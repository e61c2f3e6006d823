"""chip_smoke.py's training phases (20b-20f) end to end at a tiny size on
the CPU: the wrappers run their plain versions, each call counted as its
launch would be counted on the card, and CUDA events and device memory are
stood in for. Checks the phases' plumbing, the launch counts they hold (two
forward and one backward flash launch a layer a step under remat="full",
one of each a step in the launcher's reduced configs) and the record they
add; the numbers themselves come from a run on the card. The `cuda`-marked
test runs phase 20b's kernel checks on a card and skips without one (this
file imports no JAX).
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _count_flash(monkeypatch):
    """Stand-ins for the flash wrappers that count each call as the
    kernels' launches count on the card."""
    real_mha, real_bwd = f_ops.mha, f_ops.mha_backward

    def mha(q, k, v, **kw):
        mha.launches += 1
        mha.launches_by_dtype[str(q.dtype)[6:]] += 1
        return real_mha(q, k, v, **kw)

    def mha_backward(q, *a, **kw):
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
    monkeypatch.setattr(chip_smoke, "UNTRAINED_ARCHS", {})  # on the CPU they train
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
    # 20e: the timed steps and one more under the profiler
    assert bwd["launches"] == 3 * (n_steps + 1) + launcher
    assert records[0]["launches"] == 5 + 2 * 3 * (n_steps + 1) + launcher
    assert bwd["bound_by"] in ("bytes", "operations") and bwd["max_abs_err"] < 0.05
    losses = nums["20e"]["losses"]
    assert len(losses) == n_steps and losses[-1] < losses[0]


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
