"""chip_smoke.py's training phases (20b-20f, and 21b-21d: the recurrent
families) end to end at a tiny size on the CPU: the wrappers run their
plain versions, each call counted as its launch would be counted on the
card, and CUDA events and device memory are stood in for. Checks the
phases' plumbing, the launch counts they hold (two forward and one
backward flash launch a layer a step under remat="full", one of each a
step in the launcher's reduced configs; a pattern group's mLSTM / RG-LRU
layer twice forward and once backward, a tail layer once each) and the
records they add; the numbers themselves come from a run on the card. The
`cuda`-marked tests run phase 20b's and 21b's kernel checks on a card and
skip without one (this file imports no JAX).
"""

import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from test_torch_scripts import _stand_in_the_card  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as f_ops  # noqa: E402
from repro_torch.kernels.mlstm import ops as m_ops  # noqa: E402
from repro_torch.kernels.rglru import ops as r_ops  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _count_flash(monkeypatch):
    """Stand-ins for the flash wrappers that count each call as the
    kernels' launches count on the card (a call on `meta`, phase 22's trace,
    launches nothing there either)."""
    real_mha, real_bwd = f_ops.mha, f_ops.mha_backward

    def mha(q, k, v, **kw):
        if q.device.type != "meta":
            mha.launches += 1
            mha.launches_by_dtype[str(q.dtype)[6:]] += 1
        return real_mha(q, k, v, **kw)

    def mha_backward(q, *a, **kw):
        if q.device.type != "meta":
            mha_backward.launches += 1
            mha_backward.launches_by_dtype[str(q.dtype)[6:]] += 1
        return real_bwd(q, *a, **kw)

    monkeypatch.setattr(f_ops, "mha", mha)
    monkeypatch.setattr(f_ops, "mha_backward", mha_backward)
    monkeypatch.setattr(f_ops, "reset_launches", lambda: [
        setattr(fn, "launches", 0) or setattr(fn, "launches_by_dtype",
                                              {"float32": 0, "bfloat16": 0})
        for fn in (mha, mha_backward)])
    f_ops.reset_launches()
    return mha, mha_backward


def test_training_phases_run_on_the_cpu(monkeypatch):
    _stand_in_the_card(monkeypatch)
    _count_flash(monkeypatch)
    small = [(1, 40, 40, 4, 2, 32, 32, True, 0, False, 0.0),
             (1, 24, 24, 2, 2, 48, 32, True, 8, True, 5.0),
             (1, 8, 30, 2, 1, 32, 32, False, 0, False, 0.0)]
    monkeypatch.setattr(chip_smoke, "FLASH_CASES", [])
    monkeypatch.setattr(chip_smoke, "EXTRA_FLASH_CASES", [])
    monkeypatch.setattr(chip_smoke, "BWD_EXTRA", small)
    monkeypatch.setattr(chip_smoke, "BWD_MAIN", small[0])
    monkeypatch.setattr(chip_smoke, "TRAIN_CPU_S", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_S", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_ARCHS", ("llama3.2-3b", "mixtral-8x7b",
                                                    "seamless-m4t-large-v2"))
    monkeypatch.setattr(chip_smoke, "TRAIN_LM_STEPS", 3)
    monkeypatch.setattr(chip_smoke, "LAUNCH_ARGS", ["--arch", "llama3.2-3b", "--steps", "30",
                                                    "--batch", "8", "--seq", "32", "--lr",
                                                    "3e-3", "--ckpt-every", "10"])
    full = dataclasses.replace(registry.reduced("llama3.2-3b"), n_layers=3, name="llama-tiny")
    records = [{"name": "flash_attention", "launches": 5}]
    records, nums = chip_smoke.training_phases(torch.device("cpu"), records, full=full)
    bwd = records[-1]
    assert set(bwd) == set(chip_smoke.KERNEL_KEYS) and bwd["name"] == "flash_attention_bwd"
    n_steps = chip_smoke.TRAIN_WARMUP + chip_smoke.TRAIN_STEPS
    launcher = 30 + 10 + 3
    # 20e: the warm-up and timed steps after a first one under the profiler
    assert bwd["launches"] == 3 * (n_steps + 1) + launcher
    assert records[0]["launches"] == 5 + 2 * 3 * (n_steps + 1) + launcher
    assert bwd["bound_by"] in ("bytes", "operations") and bwd["max_abs_err"] < 0.05
    losses = nums["20e"]["losses"]  # the profiled step's first
    assert len(losses) == n_steps + 1 and losses[-1] < losses[0]
    # phase 22 ran on 20e's tensors: the dry run's bytes equal theirs (else
    # it raises) and the roofline's terms step_bound's
    p22 = nums["22"]
    assert p22["arg_bytes"] > 0 and set(p22["variants"]) == set(chip_smoke.PERF_RUNNABLE)
    assert p22["compute_ms"] == nums["20e"]["bound"]["flops_ms"]


def test_backward_checks_take_recurrentgemmas_training_shape():
    """Phase 20b holds the flash backward at the shape 21d trains
    recurrentgemma-9b's local attention at: MQA at dh 256, its window and
    logit cap, TRAIN_B x TRAIN_S tokens."""
    rg = registry.get(chip_smoke.RG_ARCH)
    S, dh = chip_smoke.TRAIN_S, rg.hd
    assert chip_smoke.BWD_RG == (chip_smoke.TRAIN_B, S, S, rg.n_heads, rg.n_kv_heads, dh, dh,
                                 True, rg.window, False, rg.attn_softcap)
    assert chip_smoke.BWD_RG in chip_smoke.bwd_cases()


@pytest.mark.cuda
def test_backward_kernel_matches_its_plain_version_on_the_card():
    """Phase 20b's checks (every variant, both dtypes, two calls bit for
    bit) and autograd through `mha` launching the backward once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(chip_smoke.bwd_cases()):
            chip_smoke.check_bwd(case, dtype, dev, seed=i)
    q = torch.randn((1, 64, 4, 32), device=dev, requires_grad=True)
    kv = torch.randn((1, 64, 2, 32), device=dev)
    n = f_ops.mha_backward.launches
    f_ops.mha(q, kv, kv).sum().backward()
    assert f_ops.mha_backward.launches == n + 1 and q.grad.shape == q.shape


def _count_recurrent(monkeypatch):
    """Stand-ins for the mLSTM / RG-LRU wrappers and their backwards that
    count each call as the kernels' launches count on the card (the
    Functions call the backwards by their module's names)."""
    counted = []

    def counting(mod, name):
        real = getattr(mod, name)

        def fn(*a, **k):
            fn.launches += 1
            return real(*a, **k)

        fn.launches = 0
        monkeypatch.setattr(mod, name, fn)
        counted.append(fn)
        return fn

    # the model calls the fused op `rglru`, whose plain version calls
    # `rglru_scan` in turn: one kernel on the card, so `rglru_scan` is not counted
    for mod, name in ((m_ops, "mlstm"), (m_ops, "mlstm_bwd"), (r_ops, "rglru"),
                      (r_ops, "rglru_bwd")):
        counting(mod, name)
    return counted


def test_recurrent_training_phases_run_on_the_cpu(monkeypatch):
    _stand_in_the_card(monkeypatch)
    _count_flash(monkeypatch)
    _count_recurrent(monkeypatch)
    small = {n: registry.reduced(n) for n in (chip_smoke.XLSTM_ARCH, chip_smoke.RG_ARCH)}
    monkeypatch.setattr(registry, "get", small.__getitem__)
    monkeypatch.setattr(chip_smoke, "recurrent_train_shapes",
                        lambda: ((1, 2, 40, 16), (1, 24, 16)))
    monkeypatch.setattr(chip_smoke, "MLSTM_CASES", [(1, 1, 20, 8)])
    monkeypatch.setattr(chip_smoke, "MLSTM_BWD_EXTRA", [(1, 2, 9, 12)])
    monkeypatch.setattr(chip_smoke, "RGLRU_CASES", [(1, 10, 8)])
    monkeypatch.setattr(chip_smoke, "RGLRU_BWD_EXTRA", [(2, 3, 5)])
    monkeypatch.setattr(chip_smoke, "TRAIN_CPU_S", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_S", 16)
    names = ("mlstm_chunk", "rglru_scan", "flash_attention", "flash_attention_bwd")
    records = [{"name": n, "launches": 5} for n in names]
    records, nums = chip_smoke.recurrent_training_phases(torch.device("cpu"), records)
    by_name = {r["name"]: r for r in records}
    for name in ("mlstm_bwd", "rglru_bwd"):
        assert set(by_name[name]) == set(chip_smoke.KERNEL_KEYS)
        assert by_name[name]["bound_by"] in ("bytes", "operations")
    xl, rg8 = small[chip_smoke.XLSTM_ARCH], dataclasses.replace(
        small[chip_smoke.RG_ARCH], n_layers=chip_smoke.RG_TRAIN_LAYERS)
    steps_x = sum(chip_smoke.XLSTM_TRAIN_STEPS) + 1  # and the profiled step
    steps_r = sum(chip_smoke.RG_TRAIN_STEPS) + 1
    n_m = chip_smoke.mixer_count(xl, "mlstm")
    # 21c: reduced xlstm and recurrentgemma, xlstm at 8 layers (one period): one step each
    # on "the card" and one on the CPU, both counted by the stand-ins
    rg = small[chip_smoke.RG_ARCH]
    want_c = {"mlstm": 2 * 2 * n_m, "rglru": 2 * chip_smoke.mixer_count(rg, "rglru"),
              "swa": 2 * chip_smoke.mixer_count(rg, "swa")}
    assert by_name["mlstm_bwd"]["launches"] == want_c["mlstm"] + n_m * steps_x
    assert by_name["mlstm_chunk"]["launches"] == (
        5 + want_c["mlstm"] + chip_smoke.mixer_count(xl, "mlstm", True) * steps_x)
    assert by_name["rglru_bwd"]["launches"] == (
        want_c["rglru"] + chip_smoke.mixer_count(rg8, "rglru") * steps_r)
    assert by_name["rglru_scan"]["launches"] == (
        5 + want_c["rglru"] + chip_smoke.mixer_count(rg8, "rglru", True) * steps_r)
    assert by_name["flash_attention_bwd"]["launches"] == (
        5 + want_c["swa"] + chip_smoke.mixer_count(rg8, "swa") * steps_r)
    for key in ("xlstm", "rg"):
        losses = nums[key]["losses"]
        assert losses[-1] < losses[0]


@pytest.mark.cuda
def test_recurrent_backward_kernels_match_their_plain_versions_on_the_card():
    """Phase 21b's checks on MLSTM_CASES / RGLRU_CASES and the ragged cases
    (both dtypes, every RG-LRU entry, two calls bit for bit) and autograd
    through `mlstm` and `rglru` launching each backward once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(chip_smoke.MLSTM_CASES + chip_smoke.MLSTM_BWD_EXTRA):
            chip_smoke.check_mlstm_bwd(case, dtype, dev, seed=i)
        for i, case in enumerate(chip_smoke.RGLRU_CASES + chip_smoke.RGLRU_BWD_EXTRA):
            for entry in chip_smoke.RGLRU_BWD_ENTRIES:
                chip_smoke.check_rglru_bwd(case, dtype, dev, entry, seed=i)
    x = torch.randn((1, 2, 64, 32), device=dev, requires_grad=True)
    gate = torch.randn((1, 2, 64), device=dev)
    la = -torch.rand((1, 64, 16), device=dev)
    gx = torch.randn((1, 64, 16), device=dev, requires_grad=True)
    n = (m_ops.mlstm_bwd.launches, r_ops.rglru_bwd.launches)
    m_ops.mlstm(x, x, x, gate, gate).sum().backward()
    r_ops.rglru(la, gx).sum().backward()
    assert (m_ops.mlstm_bwd.launches, r_ops.rglru_bwd.launches) == (n[0] + 1, n[1] + 1)
    assert x.grad.shape == x.shape and gx.grad.shape == gx.shape
