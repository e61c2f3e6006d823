"""The root scripts that drive the port on a card: `chip_smoke.py` times the
kernel at the launch shapes the lockstep step really gives it, and
`profile_step.py` accounts a profiled window correctly (run here on the CPU,
where it records host activity only). Both refuse to run without a card."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import scheduler, workloads
from repro_torch.core.engine import Grid, Simulator, batch, placement

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import profile_step  # noqa: E402

B, D, K = 3, 4, 5


def _grid():
    cfg = workloads.YCSBConfig(num_ds=D, records_per_node=1000, ops_per_txn=K, seed=0)
    bank = workloads.make_ycsb_bank(cfg, terminals=4, txns_per_terminal=8)
    return Grid([dict(preset=p) for p in ("ssp", "geotp", "scalardb")], banks=[bank] * B)


def _signature(args):
    return [(tuple(x.shape), x.dtype, bool(x.any())) for x in args]


def test_smoke_launch_shapes_are_the_steps(monkeypatch):
    """Each step calls the kernel once as Eq.9 and once as Eq.8; the smoke
    builds both launches with the same shapes, dtypes and all-zero parts."""
    _check_launch_shapes(False, monkeypatch)


def test_smoke_launch_shapes_are_the_windowed_steps(monkeypatch):
    """The same for the windowed step (`fused._omni_window`, `drain=True`)."""
    _check_launch_shapes(True, monkeypatch)


def _check_launch_shapes(drain, monkeypatch):
    seen = []
    real = scheduler.plan_dispatch

    def record(*args):
        seen.append(_signature(args))
        return real(*args)

    monkeypatch.setattr(scheduler, "plan_dispatch", record)
    grid = _grid()
    res = Simulator.from_bank(grid.banks[0], horizon_s=0.05, warmup_s=0.0, drain=drain,
                              device="cpu").run_grid(grid)
    assert len(seen) == 2 * res.steps and res.cfg.drain == drain
    launches = chip_smoke.step_launches(B, D, K, seed=0)
    want = [_signature(launches["eq9"]), _signature(launches["eq8"])]
    shapes = lambda sig: [(s, dt) for s, dt, _ in sig]  # noqa: E731
    assert [shapes(s) for s in seen[:2]] == [shapes(w) for w in want]
    # what the smoke's launches hold at zero, every step's launch holds at zero
    for i, got in enumerate(seen):
        for (_, _, got_any), (_, _, w_any) in zip(got, want[i % 2]):
            assert w_any or not got_any, f"call {i}"


def test_smoke_work_counts_these_inputs():
    eq9, eq8 = chip_smoke.step_launches(16, 4, 5, seed=99).values()
    nb9, ops9 = chip_smoke.geo_work(*eq9)
    nb8, ops8 = chip_smoke.geo_work(*eq8)
    assert (nb9, nb8) == (16 * 82, 16 * 69)
    assert ops9 == 3 * 16 + 12 * int(eq9[6].sum()) + 16
    assert ops8 == 3 * 16 * 4 + 16  # all-False valid: no Eq.9 work
    ms, by = chip_smoke.bound(nb9, ops9)
    assert by == "bytes" and ms == pytest.approx(nb9 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_profile_window_on_the_cpu():
    acts = [torch.profiler.ProfilerActivity.CPU]
    res = profile_step.measure(_grid(), 32, torch.device("cpu"), acts, drain=False)
    assert res["steps"] == 32 and res["lanes"] == B and not res["drain"]
    assert res["device_busy_ms_per_step"] is None  # no device activity recorded
    assert res["aten_ops_per_step"] > 100
    lab = res["labels"]
    assert lab["step"]["calls_per_step"] == 1.0
    assert lab["geo_schedule call"]["calls_per_step"] == 2.0
    assert 0.5 < lab["step"]["share_of_loop"] < 1.0
    hashes = sum(v["share_of_loop"] for k, v in lab.items() if k.startswith("hash:"))
    assert 0.0 < hashes < lab["step"]["share_of_loop"]
    # every wrapper was removed again
    assert placement.run is batch.run
    assert scheduler.plan_dispatch.__module__ == "repro_torch.core.scheduler"


def test_profile_window_of_the_drained_step_on_the_cpu(monkeypatch):
    """The windowed step (the default): the plan and the apply pass run
    once a step, inside it, beside the two kernel calls (a window of 8
    steps, the done check every 8)."""
    monkeypatch.setattr(batch, "_CHECK_EVERY", 8)
    acts = [torch.profiler.ProfilerActivity.CPU]
    res = profile_step.measure(_grid(), 8, torch.device("cpu"), acts)
    assert res["drain"] and res["mode"] == "eager" and res["lanes"] == B
    lab = res["labels"]
    for name in ("step", "window plan", "window apply"):
        assert lab[name]["calls_per_step"] == 1.0, name
    assert lab["geo_schedule call"]["calls_per_step"] == 2.0
    assert lab["window plan"]["share_of_loop"] < lab["step"]["share_of_loop"] < 1.0
    assert placement.run is batch.run


def test_profile_short_trace_says_where_the_kernels_lie():
    """A captured run's trace that lost a geo_schedule record: the window
    runs from the first replay range to the end of the run, and
    `_short_trace` counts the kernels in it, in the whole trace (the eager
    warm-up step's included) and before and after it."""
    from types import SimpleNamespace

    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, t0, t1):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=t0, end=t1))

    geo = "_Z19geo_schedule_kernelPKiS0_"
    events = [ev(profile_step.RUN_LABEL, cpu, 0, 100), ev(profile_step.RUN_LABEL, gpu, 1, 99),
              ev(profile_step.REPLAY_LABEL, cpu, 20, 90), ev(geo, gpu, 5, 6), ev(geo, gpu, 8, 9),
              ev("other_kernel", gpu, 26, 27)]
    events += [ev(geo, gpu, t, t + 1) for t in (25, 30, 45, 50, 65)]  # 3 replays, one lost
    prof = SimpleNamespace(events=lambda: events)
    win = profile_step._window(prof, 3 + batch._WARMUP_STEPS, 3)
    assert (win["t_lo"], win["t_hi"], win["n"]) == (20, 100, 3)
    geo_in = sum(profile_step.kernel_name(e.name) == profile_step.GEO_KERNEL
                 for e in win["kernels"])
    assert geo_in == 5
    assert profile_step._short_trace(win, geo_in) == {
        "replays": 3, "geo_in_window": 5, "geo_in_trace": 7, "geo_before_window": 2,
        "geo_after_window": 0, "kernels_per_replay": 2.0}
    with pytest.raises(AssertionError, match="replays"):
        profile_step._window(prof, 3, 3)


def test_plan_candidates_sort_equals_the_argmin_route():
    """`window._candidates` (one sort of time * M + index) against the
    reference's W masked argmins (`chip_smoke.candidates_by_argmin`) on
    times with many ties, INF_US among them."""
    from repro_torch.core.engine import window
    from repro_torch.core.netmodel import INF_US

    gen = torch.Generator().manual_seed(0)
    for M, W in ((1280, 16), (40, 16), (16, 16), (9, 16)):
        flat = torch.randint(0, 6, (5, M), generator=gen, dtype=torch.int32)
        flat = torch.where(flat == 5, INF_US, flat * 1000)
        W = min(W, M)
        got, want = window._candidates(flat, W), chip_smoke.candidates_by_argmin(flat, W)
        for name, x, y in zip(("cand_i", "cand_t", "t_w1", "pos"), got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), (M, name)


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_step.py"])
def test_scripts_refuse_to_run_without_a_card(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---- slice 2: the serving path's phases (6-9) -----------------------------


def _record_kernel_shapes(monkeypatch):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops

    seen = {"flash": [], "decode": []}
    real_mha, real_decode = fl_ops.mha, dec_ops.decode

    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.rglru import ops as r_ops

    seen = {"flash": [], "decode": [], "cap": set(), "mlstm": [], "rglru": []}
    real_mlstm, real_scan = m_ops.mlstm, r_ops.rglru_scan

    def mha(q, k, v, *, causal=True, window=0, chunk_local=False, logit_cap=0.0):
        B, S, H, dh = q.shape
        dv = (v.shape[3],) if v.shape[3] != dh else ()  # V narrower than Q/K (MLA)
        seen["flash"].append((B, S, H, k.shape[2], dh, causal, window, chunk_local) + dv)
        seen["cap"].add(logit_cap)
        return real_mha(q, k, v, causal=causal, window=window, chunk_local=chunk_local,
                        logit_cap=logit_cap)

    def decode(q, k_cache, v_cache, valid, *, logit_cap=0.0):
        B, Sc, KV, dh = k_cache.shape
        seen["decode"].append((B, Sc, q.shape[-2], KV, dh))
        seen["cap"].add(logit_cap)
        return real_decode(q, k_cache, v_cache, valid, logit_cap=logit_cap)

    def mlstm(q, k, v, logi, logf):
        seen["mlstm"].append(tuple(q.shape))
        return real_mlstm(q, k, v, logi, logf)

    def rglru_scan(log_a, b):
        seen["rglru"].append(tuple(b.shape))
        return real_scan(log_a, b)

    monkeypatch.setattr(fl_ops, "mha", mha)
    monkeypatch.setattr(dec_ops, "decode", decode)
    monkeypatch.setattr(m_ops, "mlstm", mlstm)
    monkeypatch.setattr(r_ops, "rglru_scan", rglru_scan)
    return seen


@pytest.mark.parametrize("arch,window", [("llama3.2-3b", None), ("h2o-danube-3-4b", 16),
                                         ("mixtral-8x7b", 16), ("minicpm3-4b", None)])
def test_serving_launch_shapes_are_the_models(arch, window, monkeypatch):
    """`chip_smoke.launch_shapes` gives each kernel the shapes the model's
    prefill and decode steps hand it (one launch a layer; MLA: flash with
    every head's K and V narrower than Q/K, no decode kernel)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import stack
    from repro_torch.models.schema import init_params

    cfg = dataclasses.replace(registry.reduced(arch), n_layers=2)
    if window:
        cfg = dataclasses.replace(cfg, window=window)  # a ring-buffer cache
    seen = _record_kernel_shapes(monkeypatch)
    params = init_params(stack.build_schema(cfg), torch.Generator().manual_seed(0), "cpu")
    B, S, cache_len = 2, 24, 32
    toks = torch.randint(0, cfg.vocab, (B, S + 2), generator=torch.Generator().manual_seed(1))
    chip_smoke.prefill_decode(cfg, params, toks, 2, cache_len, torch.device("cpu"))
    flash, dec = chip_smoke.launch_shapes(cfg, B, S, cache_len)
    assert seen["flash"] == [flash] * cfg.n_layers
    assert seen["decode"] == ([dec] * (2 * cfg.n_layers) if dec else [])


def test_serving_main_shapes_and_router_cache():
    cfg = chip_smoke.serve_cfg()
    assert (cfg.name, cfg.n_layers, cfg.max_seq) == ("llama3.2-3b", 28, 4096)
    flash, dec = chip_smoke.launch_shapes(cfg, 8, 2048, 4096)
    assert flash == (8, 2048, 24, 8, 128, True, 0, False)
    assert dec == (8, 4096, 24, 8, 128)
    assert chip_smoke.launch_shapes(cfg, 1, 1, chip_smoke.ROUTER_CACHE)[1] == (1, 64, 24, 8, 128)
    assert chip_smoke.serve_cfg(n_layers=2).n_layers == 2


def test_serving_helpers_run_on_the_cpu():
    """The phase-7/8 helpers at a tiny size (on the CPU the wrappers run the
    plain versions, so this checks the plumbing, not the kernels)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import stack
    from repro_torch.models.schema import init_params

    cpu = torch.device("cpu")
    for dtype in (torch.float32, torch.bfloat16):
        assert chip_smoke.check_flash((1, 40, 4, 2, 16, True, 8, True), dtype, cpu) == 0.0
        assert chip_smoke.check_decode((2, 50, 4, 2, 16), dtype, cpu) == 0.0
    assert chip_smoke.check_decode((1, 64, 4, 2, 16), torch.bfloat16, cpu, valid_slots=1) == 0.0
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.check_close(torch.ones(3), torch.zeros(3), 0.05, "x")
    cfg = dataclasses.replace(registry.reduced("llama3.2-3b"), n_layers=1)
    params = stack.cast_weights(
        cfg, init_params(stack.build_schema(cfg), torch.Generator().manual_seed(0), cpu))
    toks = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(1))
    out = chip_smoke.prefill_decode(cfg, params, toks, 3, 16, cpu)
    assert len(out) == 4 and all(o.shape == (2, cfg.vocab) for o in out)
    res, stats, secs, admits = chip_smoke.router(cfg, params, cpu, "geotp", n_requests=8)
    assert admits == 8 and res["completed"] == 8 and len(stats.occ_us) >= 8


def test_serving_work_counts_these_inputs():
    # causal: S(S+1)/2 pairs a head; a window of w keeps min(i+1, w) keys of row i
    nb, fl = chip_smoke.flash_work((2, 10, 4, 2, 8, True, 0, False), 2)
    assert nb == 2 * 10 * (2 * 4 + 2 * 2) * 8 * 2 and fl == 4 * 8 * 2 * 4 * 55
    _, fl_w = chip_smoke.flash_work((1, 10, 1, 1, 8, True, 3, False), 2)
    assert fl_w == 4 * 8 * sum(min(i + 1, 3) for i in range(10))
    _, fl_c = chip_smoke.flash_work((1, 10, 1, 1, 8, False, 4, True), 2)
    assert fl_c == 4 * 8 * (16 + 16 + 4)  # chunks of 4, 4 and 2 keys
    valid = torch.zeros((2, 16), dtype=torch.bool)
    valid[0, :5] = True
    valid[1, :1] = True
    nb, fl = chip_smoke.decode_work(valid, 6, 2, 8, 2)
    assert nb == 2 * 6 * 2 * 8 * 2 + 2 * 2 * 6 * 8 * 2 + 2 * 16 and fl == 4 * 8 * 6 * 6
    ms, by = chip_smoke.bound(*chip_smoke.flash_work((8, 2048, 24, 8, 128, True, 0, False), 2),
                              chip_smoke.BF16_TENSOR_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(2.0626e11 / 989e12 * 1e3, rel=1e-3)


# three kernel variants of a `ptxas -v` report, as nvcc prints it for sm_90a
PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z19geo_schedule_kernelPKiS0_PKhS0_S0_S0_S2_PiPfiii' for 'sm_90a'
ptxas info    : Function properties for _Z19geo_schedule_kernelPKiS0_PKhS0_S0_S0_S2_PiPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 0 barriers
ptxas info    : Compile time = 46.022 ms
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__52ee7d0f_18_flash_attention_cu_23f0aea712flash_kernelI13__nv_bfloat16Li32ELi256EEEvPKT_S4_S4_PS2_iiiifiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__52ee7d0f_18_flash_attention_cu_23f0aea712flash_kernelI13__nv_bfloat16Li32ELi256EEEvPKT_S4_S4_PS2_iiiifiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__9b822bd5_19_decode_attention_cu_3848999b13decode_kernelIfLi8EEEvPKT_S3_S3_PKhPS1_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__9b822bd5_19_decode_attention_cu_3848999b13decode_kernelIfLi8EEEvPKT_S3_S3_PKhPS1_iiiif
    3248 bytes stack frame, 8028 bytes spill stores, 10336 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 3248 bytes cumulative stack size
"""


def test_kernel_label_reads_bool_template_arguments():
    mangled = ("_ZN51_GLOBAL__N__52ee7d0f_18_flash_attention_cu_23f0aea712flash_kernelI13__nv_"
               "bfloat16Li32ELi256ELb1EEEvPKT_S4_S4_PS2_iiiiffiii")
    assert chip_smoke.kernel_label(mangled) == "flash_kernel<bfloat16, 32, 256, true>"
    assert chip_smoke.kernel_label(mangled.replace("Lb1E", "Lb0E")).endswith("256, false>")
    wgmma = ("_ZN51_GLOBAL__N__52ee7d0f_18_flash_attention_cu_23f0aea718flash_wgmma_kernel"
             "ILi256ELb1EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiffiiii")
    assert chip_smoke.kernel_label(wgmma) == "flash_wgmma_kernel<256, true>"
    split = ("_ZN52_GLOBAL__N__9b822bd5_19_decode_attention_cu_3848999b19decode_split_kernel"
             "IfLi64EEEvPKT_S3_S3_PKhPfS6_S6_iiiiffii")
    assert chip_smoke.kernel_label(split) == "decode_split_kernel<float32, 64>"


def test_ptxas_report_gives_a_line_per_kernel_variant():
    assert chip_smoke.ptxas_lines(PTXAS_REPORT) == [
        "geo_schedule_kernel: 29 registers, 0 B stack frame, 0 B spill stores, "
        "0 B spill loads",
        "flash_kernel<bfloat16, 32, 256>: 168 registers, 0 B stack frame, 0 B spill stores, "
        "0 B spill loads",
        "decode_kernel<float32, 8>: 32 registers, 3248 B stack frame, 8028 B spill stores, "
        "10336 B spill loads",
    ]


def test_wide_kernel_cases_reach_every_variant():
    """Phase 7's cases beyond the reference's reach each kernel's widest
    variant (head dim up to 256) and decode's G = 3 and G = 5 row layouts."""
    from repro_torch.kernels.decode_attention.ops import MAX_HEAD_DIM as DEC_MAX
    from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM as FL_MAX

    assert max(c[4] for c in chip_smoke.WIDE_FLASH_CASES) == FL_MAX == 256
    assert max(c[4] for c in chip_smoke.WIDE_DECODE_CASES) == DEC_MAX == 256
    assert {c[2] // c[3] for c in chip_smoke.WIDE_DECODE_CASES} >= {3, 5}
    main_dec = chip_smoke.launch_shapes(chip_smoke.serve_cfg(), 8, 2048, 4096)[1]
    assert main_dec[2] // main_dec[3] == 3  # the serving path's layout is among them


def test_narrow_v_cases_reach_every_v_variant():
    """Phase 13's cases reach every bf16 variant whose V panels are fewer
    than its Q/K panels ((dh, dv) padded to 64 / 128 / 256), and MLA's
    shape at minicpm3-4b's width: dh 96 = 64 + 32, dv 64."""
    from repro_torch.configs import registry

    pad = lambda d: 64 if d <= 64 else 128 if d <= 128 else 256  # noqa: E731
    got = {(pad(c[4]), pad(c[8])) for c in chip_smoke.MLA_FLASH_CASES}
    assert got >= {(128, 64), (256, 64), (256, 128)} and all(c[8] < c[4] for c in
                                                             chip_smoke.MLA_FLASH_CASES)
    mla, dec = chip_smoke.launch_shapes(registry.get("minicpm3-4b"), 8, 2048, 2112)
    assert mla == (8, 2048, 40, 40, 96, True, 0, False, 64) and dec is None


def test_strict_build_refuses_a_stack_frame_or_spill(monkeypatch, tmp_path, capsys):
    from repro_torch.kernels import _build

    report = tmp_path / "report.txt"
    report.write_text(PTXAS_REPORT)
    monkeypatch.setattr(_build, "report_path", lambda name: report)
    monkeypatch.setattr(_build, "library_path", lambda name: ROOT / "build" / f"lib{name}.so")
    chip_smoke.print_build("decode_attention", 1.0)
    assert "3248 B stack frame" in capsys.readouterr().out
    with pytest.raises(AssertionError, match=r"decode_kernel<float32, 8>"):
        chip_smoke.print_build("decode_attention", 1.0, strict=True)
    report.write_text(PTXAS_REPORT.split("ptxas info    : Compiling entry function '_ZN52")[0])
    chip_smoke.print_build("flash_attention", 1.0, strict=True)  # no stack, no spill: passes
    assert set(chip_smoke.STRICT_BUILDS) == {"flash_attention", "decode_attention", "mlstm_chunk"}


def test_extra_attention_cases_reach_the_redesigned_kernels_edges():
    """Phase 7's extra cases: flash with S past a window and not a multiple
    of the 128-query block (cap 50), G = 3 at dh 128, S below one 64-key
    tile and rows that are not 16-byte aligned; decode with Sc not a
    multiple of the split, leading splits with no valid slot, one row with
    none beside valid rows, the router's B = 1 over several splits, more
    than 16 rows a head and unaligned rows."""
    from repro_torch.kernels.decode_attention.ops import split_plan

    (f_win, cap), (f_gqa, _), (f_chunk, _), (f_short, _), (f_odd, _) = \
        chip_smoke.EXTRA_FLASH_CASES
    assert f_win[1] % 128 and f_win[1] > f_win[6] > 0 and cap == 50.0 and f_win[4] == 256
    assert f_gqa[2] // f_gqa[3] == 3 and f_gqa[4] == 128 and f_gqa[1] % 128
    # chunks of 256 hold 64-key tiles below the diagonal inside one chunk: the unmasked path
    assert f_chunk[7] and f_chunk[6] >= 256 and f_chunk[6] % 128 == 0 and f_chunk[1] > f_chunk[6]
    assert f_short[1] < 64 and f_odd[4] % 8  # bf16 rows of dh % 8 != 0: not 16-byte aligned
    cpu = torch.device("cpu")
    seen = set()
    for case, pattern in chip_smoke.EXTRA_DECODE_CASES:
        B, Sc, H, KV, dh = case
        splits, per = split_plan(B, KV, Sc, 132)
        valid = chip_smoke.decode_inputs(case, torch.float32, cpu, 0, pattern=pattern)[3]
        if H // KV > 16:
            seen.add("two row blocks")
        if dh % 4:  # unaligned in float32 and bf16 alike
            seen.add("unaligned")
        if Sc % per:
            seen.add("ragged split")
        if pattern == "tail":
            assert splits > 1 and not valid[:, :per].any() and valid.any(1).all()
            seen.add("tail")
        if pattern == "dead_row":
            assert not valid[1].any() and valid[0].any() and valid[2].any()
            seen.add("dead row")
        if B == 1 and splits > 1:
            seen.add("router")
    assert seen == {"ragged split", "tail", "dead row", "router", "two row blocks", "unaligned"}
    with pytest.raises(ValueError, match="unknown valid pattern"):
        chip_smoke.decode_inputs((1, 8, 2, 1, 4), torch.float32, cpu, 0, pattern="nope")


def test_tight_checks_run_on_the_cpu():
    cpu = torch.device("cpu")
    for case, cap in [((1, 70, 4, 2, 16, True, 32, False), 50.0)]:
        assert chip_smoke.check_tight("flash", case, cpu, logit_cap=cap) == (0.0, 0.0)
    for pattern in (None, "tail", "dead_row"):
        assert chip_smoke.check_tight("decode", (3, 90, 6, 2, 16), cpu, pattern=pattern) == (0.0, 0.0)


# ---- slice 3: the recurrent mixers' phases (10-12) ---------------------------


def test_recurrent_launch_shapes_are_the_models(monkeypatch):
    """`chip_smoke.recurrent_shapes` gives each kernel the shapes xlstm's and
    recurrentgemma's prefill and decode steps hand it, at the sizes of
    phases 11-12 (checked here on the reduced configs at a small size):
    one mlstm launch per mLSTM layer, one rglru_scan per RG-LRU layer, one
    flash / decode launch per swa layer, each with recurrentgemma's cap."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import stack
    from repro_torch.models.schema import init_params

    xl = registry.reduced("xlstm-350m")
    rg = dataclasses.replace(registry.reduced("recurrentgemma-9b"), window=16)  # a ring
    monkeypatch.setattr(chip_smoke, "XLSTM_B", 2)
    monkeypatch.setattr(chip_smoke, "XLSTM_S", 24)
    monkeypatch.setattr(chip_smoke, "RG_B", 2)
    monkeypatch.setattr(chip_smoke, "RG_S", 24)
    monkeypatch.setattr(chip_smoke, "DECODE_STEPS", 2)
    m_main, r_main, f_rg, d_rg = chip_smoke.recurrent_shapes(xl, rg)
    for cfg in (xl, rg):
        seen = _record_kernel_shapes(monkeypatch)
        params = init_params(stack.build_schema(cfg), torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 26), generator=torch.Generator().manual_seed(1))
        chip_smoke.prefill_decode(cfg, params, toks, 2, 26, torch.device("cpu"))
        mixers = [m for m, _ in cfg.pattern] * cfg.n_groups + [m for m, _ in cfg.tail]
        assert seen["mlstm"] == [m_main] * mixers.count("mlstm")
        assert seen["rglru"] == [r_main] * mixers.count("rglru")
        assert seen["flash"] == [f_rg] * mixers.count("swa")
        assert seen["decode"] == [d_rg] * (2 * mixers.count("swa"))
        assert seen["cap"] <= {cfg.attn_softcap}
    assert mixers.count("swa") and f_rg[6] == 16 and d_rg[1] == 16  # the ring's capacity


def test_recurrent_serving_shapes_at_full_width():
    from repro_torch.configs import registry

    xl, rg = registry.get("xlstm-350m"), registry.get("recurrentgemma-9b")
    m_main, r_main, f_rg, d_rg = chip_smoke.recurrent_shapes(xl, rg)
    assert m_main == (8, 4, 2048, 256) and r_main == (4, 4096, 4096)
    assert f_rg == (4, 4096, 16, 1, 256, True, 2048, False) and d_rg == (4, 2048, 16, 1, 256)
    mixers = [m for m, _ in rg.pattern] * rg.n_groups + [m for m, _ in rg.tail]
    assert (mixers.count("rglru"), mixers.count("swa")) == (26, 12)
    assert sum(m == "mlstm" for m, _ in xl.pattern) * xl.n_groups == 21


def test_recurrent_checks_reach_every_kernel_variant():
    """Phase 10 reaches each template variant of the four LM kernels: head
    dims up to 64, 128 and 256 (mlstm, and both attention kernels under a
    cap), both dtypes, and a cap that tanh saturates."""
    from repro_torch.configs import registry

    def buckets(dims):
        return {min(b for b in (64, 128, 256) if d <= b) for d in dims}

    m_main, r_main, f_rg, d_rg = chip_smoke.recurrent_shapes(
        registry.get("xlstm-350m"), registry.get("recurrentgemma-9b"))
    assert buckets([c[3] for c in chip_smoke.MLSTM_CASES] + [m_main[3]]) == {64, 128, 256}
    assert buckets([c[4] for c in chip_smoke.FLASH_CASES] + [f_rg[4]]) == {64, 128, 256}
    assert buckets([c[4] for c in chip_smoke.DECODE_CASES] + [d_rg[4]]) == {64, 128, 256}
    assert 50.0 in chip_smoke.SOFTCAPS  # recurrentgemma's
    # scores ~ N(0, SCALE^2) reach 5 caps past the smallest: tanh saturates
    assert chip_smoke.SOFTCAP_INPUT_SCALE * 3 > 5 * min(chip_smoke.SOFTCAPS) / 2


def test_recurrent_work_counts_these_inputs():
    nb, fl = chip_smoke.mlstm_work((2, 3, 10, 8), 4)
    assert nb == 4 * 2 * 3 * 10 * 8 * 4 + 2 * 2 * 3 * 10 * 4 and fl == 4 * 8 * 2 * 3 * 55
    nb, fl = chip_smoke.rglru_work((2, 10, 8), 2)
    assert nb == 2 * 10 * 8 * (4 + 2 * 2) and fl == 3 * 2 * 10 * 8
    ms, by = chip_smoke.bound(*chip_smoke.mlstm_work((8, 4, 2048, 256), 4))
    assert by == "operations" and ms == pytest.approx(6.87e10 / 67e12 * 1e3, rel=1e-3)
    ms, by = chip_smoke.bound(*chip_smoke.rglru_work((4, 4096, 4096), 4))
    assert by == "bytes" and ms == pytest.approx(0.2404, rel=1e-3)


def test_kernels_line_names_all_five_with_every_key():
    """The five kernels, and the two entries slice 8 added: flash's cross
    route and decode's int8 cache, each a record of its own."""
    rec = {k: 1.0 for k in chip_smoke.KERNEL_KEYS}
    records = [dict(rec, name=n) for n in chip_smoke.KERNEL_NAMES]
    line = chip_smoke.kernels_line(records)
    assert [r["name"] for r in __import__("json").loads(line)["kernels"]] == list(
        chip_smoke.KERNEL_NAMES)
    assert set(chip_smoke.KERNEL_NAMES) == {"geo_schedule", "decode_attention",
                                            "flash_attention", "mlstm_chunk", "rglru_scan",
                                            "flash_attention_cross", "decode_attention_int8"}
    with pytest.raises(AssertionError, match="!="):
        chip_smoke.kernels_line(records[:-1])
    last = chip_smoke.KERNEL_NAMES[-1]
    with pytest.raises(AssertionError, match="keys"):
        chip_smoke.kernels_line(records[:-1] + [{"name": last}])
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.kernels_line(records[:-1] + [dict(rec, name=last, launches=0)])


def test_recurrent_phases_run_on_the_cpu(monkeypatch):
    """Phases 10-12 end to end at a tiny size on the CPU: the wrappers run
    the plain versions, each counted as a launch would be; CUDA events,
    device memory and the serving shapes' timings are stood in for. Checks
    the plumbing and the records, not the kernels."""
    import dataclasses
    import time as _time

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attention import decode_attention as d_bind
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import flash_attention as f_bind
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.geo_schedule import ops as g_ops
    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.rglru import ops as r_ops

    small = {n: registry.reduced(n) for n in ("xlstm-350m", "recurrentgemma-9b")}
    small["recurrentgemma-9b"] = dataclasses.replace(small["recurrentgemma-9b"], window=32)
    monkeypatch.setattr(registry, "get", small.__getitem__)
    for name, value in (("XLSTM_B", 2), ("XLSTM_S", 24), ("RG_B", 2), ("RG_S", 40),
                        ("DECODE_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke.router, "__defaults__", (5,))
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)

    def host_ms(fn, iters):
        t0 = _time.perf_counter()
        fn()
        return (_time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    monkeypatch.setattr(f_bind, "launch", lambda *a, **k: None)
    monkeypatch.setattr(d_bind, "run", lambda args: None)
    monkeypatch.setattr(d_ops, "prepare", lambda *a, **k: (None, ()))
    monkeypatch.setattr(d_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(chip_smoke, "time_mlstm",
                        lambda m, dev: {"mlstm_bf16": (1.0, 2.0), "mlstm": (1.0, 2.0)})
    monkeypatch.setattr(chip_smoke, "time_rglru", lambda r, dev: dict.fromkeys(
        ("scan", "fused", "eager_b_then_scan", "plain", "same_bytes_add", "decode_fused",
         "decode_eager"), 1.0) | {"runs": {}})
    for mod, name in ((m_ops, "mlstm"), (r_ops, "rglru"), (f_ops, "mha"),
                      (d_ops, "decode"), (g_ops, "geo_schedule")):
        real = getattr(mod, name)

        def counted(*a, real=real, **k):
            fn = counted_fns[real.__name__]
            fn.launches += 1
            if real.__name__ in ("mha", "mlstm"):  # these wrappers also count by dtype
                fn.launches_by_dtype[str(a[0].dtype)[6:]] += 1
            return real(*a, **k)

        counted.launches, counted.__name__ = 0, real.__name__
        counted.launches_by_dtype = {"float32": 0, "bfloat16": 0}
        monkeypatch.setattr(mod, name, counted)
    counted_fns = {f.__name__: f for f in (m_ops.mlstm, r_ops.rglru, f_ops.mha,
                                           d_ops.decode, g_ops.geo_schedule)}
    check = {"mlstm": chip_smoke.check_mlstm, "rglru": chip_smoke.check_rglru}
    # the serving shapes of phase 10 shrink to what a CPU test can hold
    monkeypatch.setattr(chip_smoke, "check_mlstm", lambda case, *a, **k: check["mlstm"](
        tuple(min(c, 32) for c in case), *a, **k))
    monkeypatch.setattr(chip_smoke, "check_rglru", lambda case, *a, **k: check["rglru"](
        tuple(min(c, 32) for c in case), *a, **k))
    monkeypatch.setattr(chip_smoke, "MLSTM_CASES", [(1, 2, 40, 16)])
    monkeypatch.setattr(chip_smoke, "RGLRU_CASES", [(1, 40, 16)])
    monkeypatch.setattr(chip_smoke, "RGLRU_EXACT_CASES", chip_smoke.RGLRU_EXACT_CASES[:2])
    rglru_phase = chip_smoke.rglru_phase
    monkeypatch.setattr(chip_smoke, "rglru_phase", lambda case, dev: rglru_phase(
        tuple(min(c, 32) for c in case), dev))
    monkeypatch.setattr(chip_smoke, "FLASH_CASES", chip_smoke.FLASH_CASES[3:4])
    monkeypatch.setattr(chip_smoke, "DECODE_CASES", chip_smoke.DECODE_CASES[:1])
    serving = [dict({k: 0.0 for k in chip_smoke.KERNEL_KEYS}, name=n, launches=1)
               for n in ("decode_attention", "flash_attention")]
    records = chip_smoke.recurrent_phases(torch.device("cpu"), serving)
    geo, cross, int8 = (dict({k: 0.0 for k in chip_smoke.KERNEL_KEYS}, name=n, launches=1)
                        for n in ("geo_schedule", "flash_attention_cross",
                                  "decode_attention_int8"))
    chip_smoke.kernels_line([geo] + records + [cross, int8])  # every key, each launched
    by_name = {r["name"]: r for r in records}
    assert by_name["mlstm_chunk"]["launches"] == 2 * 7  # two prefills of 7 mLSTM layers
    # the fused op: 4 RG-LRU layers a prefill (two) and a decode step (two,
    # then one a generation in the router's runs)
    assert by_name["rglru_scan"]["launches"] > 2 * 4 + 2 * 4
    assert by_name["rglru_scan"]["launches"] % 4 == 0
    assert by_name["flash_attention"]["launches"] == 1 + 2 * 1
    assert by_name["decode_attention"]["launches"] > 1 + 2 * 1


@pytest.mark.parametrize("arch,serve,want", [
    ("mixtral-8x7b", (4, 4608), [
        ("flash", (4, 4608, 32, 8, 128, True, 4096, False), None),
        ("decode", (4, 4096, 32, 8, 128), 4096),  # the ring, full past the window
        ("decode", (4, 4096, 32, 8, 128), None),
        ("decode", (1, 64, 32, 8, 128), 1)]),  # the router's step
    ("llama4-scout-17b-a16e", (2, 10240), [
        ("flash", (2, 10240, 40, 8, 128, True, 8192, True), None),
        ("decode", (2, 8192, 40, 8, 128), 2049),  # the cla ring: position 10240's chunk
        ("decode", (2, 8192, 40, 8, 128), None),
        ("flash", (2, 10240, 40, 8, 128, True, 0, False), None),  # NoPE gqa
        ("decode", (2, 10304, 40, 8, 128), 10241),  # linear
        ("decode", (2, 10304, 40, 8, 128), None)]),
    ("minicpm3-4b", (8, 2048), [])])  # MLA: phase 13's shape, plain decode
def test_path_shape_checks_take_the_serving_shapes(arch, serve, want, monkeypatch):
    """Phases 14-16 hold flash and decode at each shape the full-width run
    gives them (the config's own widths and windows), decode over the
    valid slots of the first decode step and over random positions, and
    the router's B = 1 step, in float32 and bf16."""
    from repro_torch.configs import registry

    seen = []
    monkeypatch.setattr(chip_smoke, "check_flash",
                        lambda case, dt, dev: seen.append(("flash", case, None, str(dt))) or 0.0)
    monkeypatch.setattr(chip_smoke, "check_decode", lambda case, dt, dev, valid_slots: seen.append(
        ("decode", case, valid_slots, str(dt))) or 0.0)
    monkeypatch.setattr(chip_smoke, "check_tight", lambda kind, case, dev, valid_slots: seen.append(
        (kind, case, valid_slots, "tight")) or (0.0, 0.0))
    cfg = registry.get(arch)
    if arch.startswith("llama4"):
        cfg = dataclasses.replace(cfg, n_layers=chip_smoke.LLAMA4_LAYERS)
    chip_smoke.path_shape_checks(cfg, serve, torch.device("cpu"), not arch.startswith("llama4"))
    assert seen == [(*w, how) for w in want for how in ("torch.float32", "tight")]


def test_moe_mla_phases_run_on_the_cpu(monkeypatch):
    """Phases 13-16 end to end at a tiny size on the CPU (reduced mixtral
    cut to 2 layers with a 16-slot ring, llama4's one period with a 24-token
    chunk, minicpm3's reduced MLA): the wrappers run the plain versions,
    each counted as a launch would be; CUDA events and device memory are
    stood in for. Checks the plumbing, the launch counts against the layer
    pattern, the routing comparison and the records, not the kernels."""
    import dataclasses
    import time as _time

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import flash_attention as f_bind
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.geo_schedule import ops as g_ops
    from repro_torch.models import layers

    small = {n: registry.reduced(n) for n in ("mixtral-8x7b", "llama4-scout-17b-a16e",
                                              "minicpm3-4b")}
    small["mixtral-8x7b"] = dataclasses.replace(small["mixtral-8x7b"], window=16,
                                                capacity_factor=1.25)
    small["llama4-scout-17b-a16e"] = dataclasses.replace(small["llama4-scout-17b-a16e"],
                                                         window=24, capacity_factor=1.25)
    monkeypatch.setattr(registry, "get", small.__getitem__)
    for name, value in (("MIXTRAL_LAYERS", 2), ("LLAMA4_LAYERS", 4), ("MIXTRAL_B", 2),
                        ("MIXTRAL_S", 40), ("LLAMA4_B", 2), ("LLAMA4_S", 40), ("MINICPM_B", 2),
                        ("MINICPM_S", 24), ("MINICPM_MAX_SEQ", 64), ("MOE_CPU_PROMPT", 24),
                        ("DECODE_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke.router, "__defaults__", (5,))
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)

    def host_ms(fn, iters):
        t0 = _time.perf_counter()
        fn()
        return (_time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    monkeypatch.setattr(f_bind, "launch", lambda *a, **k: None)
    for mod, name in ((f_ops, "mha"), (d_ops, "decode"), (g_ops, "geo_schedule")):
        real = getattr(mod, name)

        def counted(*a, real=real, **k):
            fn = counted_fns[real.__name__]
            fn.launches += 1
            if real.__name__ == "mha":
                fn.launches_by_dtype[str(a[0].dtype)[6:]] += 1
            return real(*a, **k)

        counted.launches, counted.__name__ = 0, real.__name__
        counted.launches_by_dtype = {"float32": 0, "bfloat16": 0}
        monkeypatch.setattr(mod, name, counted)
    counted_fns = {f.__name__: f for f in (f_ops.mha, d_ops.decode, g_ops.geo_schedule)}
    route = layers.moe_route
    monkeypatch.setattr(chip_smoke, "MLA_FLASH_CASES", chip_smoke.MLA_FLASH_CASES[1:2])
    serving = [dict({k: 0.0 for k in chip_smoke.KERNEL_KEYS}, name=n, launches=1)
               for n in ("decode_attention", "flash_attention")]
    records, runs, mla = chip_smoke.moe_mla_phases(torch.device("cpu"), serving)
    assert layers.moe_route is route  # the RouteLog put the real one back
    assert mla["case"] == (2, 24, 4, 4, 48, True, 0, False, 32)  # MLA: dh 48, dv 32
    by_name = {r["name"]: r for r in records}
    mx, l4, mc = (runs[a] for a in ("mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"))
    assert mx["per_prefill"]["mha"] == 2 and mx["per_step"]["decode"] == 2
    assert l4["per_prefill"]["mha"] == 4 and l4["per_step"]["decode"] == 4 and not l4["router"]
    assert mc["per_prefill"]["mha"] == 1 and mc["per_step"]["decode"] == 0 and mc["router"]
    # one device: the routing is equal
    assert mx["worst"]["decisions"] > 0 and mx["worst"]["flips"] == mx["worst"]["kept_only"] == 0
    assert all(0 <= e < 2e-2 for r in runs.values() for e in r["err"])  # the path-shape checks
    assert mx["dropped"] > 0 and l4["dropped"] > 0 and mc["dropped"] == 0
    want = 1 + sum(r["launches"]["mha"] for r in runs.values())
    assert by_name["flash_attention"]["launches"] == want
    assert by_name["decode_attention"]["launches"] == 1 + mx["launches"]["decode"] + l4[
        "launches"]["decode"]


# ---- slice 8: the frontends, the encoder-decoder, the int8 cache (17-19) -----


def _count_launches(monkeypatch):
    """Stand-ins for the attention wrappers that count each call as its
    kernel launch would count on the card (flash by dtype and cross route,
    decode by cache dtype; a decode over no slots launches nothing)."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.geo_schedule import ops as g_ops

    real = {"mha": f_ops.mha, "decode": d_ops.decode, "geo_schedule": g_ops.geo_schedule}

    def mha(q, k, v, **kw):
        mha.launches += 1
        mha.launches_by_dtype[str(q.dtype)[6:]] += 1
        mha.cross_launches += k.shape[1] != q.shape[1]
        return real["mha"](q, k, v, **kw)

    def decode(q, k_cache, v_cache, valid, **kw):
        if k_cache.shape[1]:
            decode.launches += 1
            decode.launches_by_cache["int8" if k_cache.dtype == torch.int8
                                     else str(q.dtype)[6:]] += 1
        return real["decode"](q, k_cache, v_cache, valid, **kw)

    def geo_schedule(*a, **k):
        geo_schedule.launches += 1
        return real["geo_schedule"](*a, **k)

    geo_schedule.launches = 0
    monkeypatch.setattr(f_ops, "mha", mha)
    monkeypatch.setattr(d_ops, "decode", decode)
    monkeypatch.setattr(g_ops, "geo_schedule", geo_schedule)
    f_ops.reset_launches()
    d_ops.reset_launches()
    return mha, decode


def _stand_in_the_card(monkeypatch):
    import time as _time

    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)

    def host_ms(fn, iters):
        t0 = _time.perf_counter()
        fn()
        return (_time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, iters=500: host_ms(fn, iters))


def test_slice8_phases_run_on_the_cpu(monkeypatch):
    """Phases 17-19 end to end at a tiny size on the CPU (reduced internvl2
    with 8 patches, seamless with 24 frames and one encoder and decoder
    layer in the GPU-vs-CPU check, h2o with a 32-slot ring past which its
    prefill of 40 wraps): the wrappers run the plain versions, each call
    counted as its launch would be; CUDA events and device memory are stood
    in for. Checks the plumbing, the launch counts against the layer
    pattern (the encoder's and the cross-attention's included), the
    router's empty-memory decode, the int8 run's limits and the records."""
    from repro_torch.configs import registry

    small = {n: registry.reduced(n) for n in ("internvl2-26b", "seamless-m4t-large-v2",
                                              "h2o-danube-3-4b")}
    small["h2o-danube-3-4b"] = dataclasses.replace(small["h2o-danube-3-4b"], window=32)
    monkeypatch.setattr(registry, "get", small.__getitem__)
    for name, value in (("INTERNVL_B", 2), ("INTERNVL_P", 8), ("INTERNVL_T", 16),
                        ("INTERNVL_CACHE", 48), ("INTERNVL_MAX_SEQ", 64), ("SEAMLESS_B", 2),
                        ("SEAMLESS_FRAMES", 24), ("SEAMLESS_DEC", 8), ("SEAMLESS_CACHE", 32),
                        ("SEAMLESS_MAX_SEQ", 64), ("H2O_B", 2), ("H2O_S", 40), ("INT8_STEPS", 2),
                        ("FRONT_CPU", 8), ("MOE_CPU_PROMPT", 16), ("DECODE_STEPS", 2),
                        ("CROSS_MAIN", (2, 8, 24, 4, 4, 32)),
                        ("CROSS_CASES", chip_smoke.CROSS_CASES[:1]),
                        ("INT8_DECODE_CASES", [(2, 64, 4, 2, 30, 64), (2, 50, 6, 2, 16, None),
                                               (1, 40, 4, 4, 32, None)])):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke.router, "__defaults__", (5,))
    _stand_in_the_card(monkeypatch)
    from repro_torch.kernels.flash_attention import flash_attention as f_bind

    monkeypatch.setattr(f_bind, "launch", lambda *a, **k: None)
    mha, decode = _count_launches(monkeypatch)
    serving = [dict({k: 0.0 for k in chip_smoke.KERNEL_KEYS}, name=n, launches=1)
               for n in ("decode_attention", "flash_attention")]
    records, runs, i8 = chip_smoke.slice8_phases(torch.device("cpu"), serving)
    by_name = {r["name"]: r for r in records}
    assert set(by_name) == {"decode_attention", "flash_attention", "flash_attention_cross",
                            "decode_attention_int8"}
    iv, sm = runs["internvl2-26b"], runs["seamless-m4t-large-v2"]
    L = small["seamless-m4t-large-v2"].n_layers
    E = small["seamless-m4t-large-v2"].n_enc_layers
    assert iv["per_prefill"]["mha"] == 1 and iv["per_step"]["decode"] == 1 and iv["router"]
    assert sm["per_prefill"]["mha"] == E + 2 * L and sm["per_step"]["decode"] == 2 * L
    assert sm["cross"] == 2 * L and iv["cross"] == 0 and sm["router"]
    assert by_name["flash_attention_cross"]["launches"] == 2 * L
    H = small["h2o-danube-3-4b"].n_layers
    assert i8["int8"] == i8["bf16"] == H * 2 and i8["flash"] == 4 * H and i8["rel"] < 0.05
    assert by_name["decode_attention_int8"]["launches"] == i8["int8"]
    assert by_name["decode_attention_int8"]["library_ms"] is None
    assert by_name["flash_attention_cross"]["library_ms"] >= 0
    assert all(set(r) == set(chip_smoke.KERNEL_KEYS) for r in records)
    want_fl = 1 + sum(r["launches"]["mha"] - r["cross"] for r in runs.values()) + i8["flash"]
    assert by_name["flash_attention"]["launches"] == want_fl
    want_dec = 1 + sum(r["decode_by_cache"]["bfloat16"] for r in runs.values()) + i8["bf16"]
    assert by_name["decode_attention"]["launches"] == want_dec


def test_slice8_cases_reach_the_new_routes_edges():
    """Phase 17's cases: the cross route with Sq below one 64-row
    warpgroup, Sk below and across one 64-key tile, Sq past one 128-query
    block and above Sk, and seamless's shape; the int8 entry at h2o's full
    ring and llama's linear cache at B = 8 over 4,096 slots, a head dim that
    is not a multiple of the 16-byte load, G = 20, and the router's B = 1."""
    from repro_torch.configs import registry

    cross = chip_smoke.CROSS_CASES
    assert any(c[1] < 64 for c in cross) and any(c[2] < 64 for c in cross)
    assert any(c[2] % 64 and c[2] > 64 for c in cross) and any(c[1] > 128 > c[2] for c in cross)
    assert {c[5] for c in cross} >= {64, 120, 256}
    sm = registry.get("seamless-m4t-large-v2")
    assert chip_smoke.CROSS_MAIN == (8, 32, 1024, sm.n_heads, sm.n_kv_heads, sm.hd)
    h2o = registry.get("h2o-danube-3-4b")
    ring = (8, h2o.window, h2o.n_heads, h2o.n_kv_heads, h2o.hd)
    cases = chip_smoke.INT8_DECODE_CASES
    assert (*ring, h2o.window) in cases and (*ring, None) in cases
    assert (8, 4096, 24, 8, 128, None) in cases  # llama3.2-3b's linear cache
    assert any(c[4] % 8 for c in cases) and any(c[2] // c[3] > 16 for c in cases)
    assert any(c[0] == 1 and c[5] == 1 for c in cases)
    assert chip_smoke.H2O_S > h2o.window  # the int8 ring wraps in the prefill


def test_encdec_and_vision_launches_and_batches():
    """`want_launches` for an encoder-decoder adds an encoder layer's flash
    and a decoder layer's cross flash and cross decode; `front_batch`
    builds each family's prefill batch, with a vision model's decode
    positions after its patches."""
    from repro_torch.configs import registry

    sm = registry.get("seamless-m4t-large-v2")
    pre, step = chip_smoke.want_launches(sm)
    assert pre["mha"] == 72 and step["decode"] == 48  # 24 + 24 + 24; 24 self + 24 cross
    iv = registry.get("internvl2-26b")
    pre, step = chip_smoke.want_launches(iv)
    assert pre["mha"] == 48 and step["decode"] == 48
    toks = torch.zeros((2, 5), dtype=torch.int32)
    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    b, off = chip_smoke.front_batch(iv, toks, 7, gen, cpu)
    assert set(b) == {"patches", "tokens"} and b["patches"].shape == (2, 7, 3200) and off == 7
    b, off = chip_smoke.front_batch(sm, toks, 9, gen, cpu)
    assert set(b) == {"frames", "dec_tokens"} and b["frames"].shape == (2, 9, 160) and off == 0
    assert chip_smoke.front_batch(registry.get("llama3.2-3b"), toks, 0, gen, cpu) == (
        {"tokens": toks}, 0)


def test_int8_and_cross_work_count_these_inputs():
    nb, fl = chip_smoke.cross_work((2, 3, 10, 4, 2, 8), 2)
    assert nb == 2 * (2 * 3 * 4 + 2 * 10 * 2) * 8 * 2 and fl == 4 * 8 * 2 * 4 * 3 * 10
    valid = torch.zeros((2, 16), dtype=torch.bool)
    valid[0, :5] = True
    valid[1, :1] = True
    nb, fl = chip_smoke.int8_work(valid, 6, 2, 8, 2)
    assert nb == 2 * 6 * 2 * (8 + 4) + 2 * 2 * 6 * 8 * 2 + 2 * 16
    assert fl == 4 * 8 * 6 * 6 + 2 * 6 * 2 * 8
    ms, by = chip_smoke.bound(*chip_smoke.cross_work(chip_smoke.CROSS_MAIN, 2),
                              chip_smoke.BF16_TENSOR_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(34603008 / 3.35e12 * 1e3)


def test_kernel_label_names_the_int8_variant():
    mangled = ("_ZN52_GLOBAL__N__9b822bd5_19_decode_attention_cu_3848999b19decode_split_kernel"
               "I13__nv_bfloat16Li128EaEEvPKT_PKT1_S7_PKfSA_PKhPfSD_SD_iiiiffii")
    assert chip_smoke.kernel_label(mangled) == "decode_split_kernel<bfloat16, 128, int8>"
    same = mangled.replace("Li128EaE", "Li128ES1_E")
    assert chip_smoke.kernel_label(same) == "decode_split_kernel<bfloat16, 128>"


def test_profile_window_of_a_faulted_step_on_the_cpu(monkeypatch):
    """A grid with a fault schedule and a bank the cells share: the profiled
    step carries the fault and heartbeat tails (a window of 8 steps)."""
    monkeypatch.setattr(batch, "_CHECK_EVERY", 8)
    cfg = workloads.YCSBConfig(num_ds=D, records_per_node=1000, ops_per_txn=K, seed=0)
    bank = workloads.make_ycsb_bank(cfg, terminals=4, txns_per_terminal=8)
    grid = Grid([dict(preset=p, faults=((1_000, 0, 2_000),), replica_tau=(30_000,) * D)
                 for p in ("ssp", "geotp")])
    acts = [torch.profiler.ProfilerActivity.CPU]
    res = profile_step.measure(grid, 8, torch.device("cpu"), acts, bank=bank)
    assert res["drain"] and res["max_faults"] == 1 and res["lanes"] == 2
    assert res["labels"]["geo_schedule call"]["calls_per_step"] == 2.0
    assert placement.run is batch.run


def _reference_test_module(name, monkeypatch):
    import importlib

    monkeypatch.syspath_prepend(str(ROOT / "tests" / "core"))
    return importlib.import_module(name)


def test_fault_phase_schedules_are_the_reference_tests(monkeypatch):
    """Phase 4c's schedules and replicas are the reference tests' own."""
    faults = _reference_test_module("test_faults", monkeypatch)
    parts = _reference_test_module("test_partitions", monkeypatch)
    assert chip_smoke.CRASH_HEAVY == faults.CRASH_HEAVY
    assert chip_smoke.PART_HEAVY == parts.PART_HEAVY
    assert (chip_smoke.REPLICA_TAU, chip_smoke.REPL_LAG_US) == (parts.REPLICA_TAU, parts.REPL_LAG_US)
    assert (chip_smoke.SMALL_T, chip_smoke.SMALL_K, chip_smoke.SMALL_D, chip_smoke.SMALL_N) == (
        faults.T, faults.K, faults.D, faults.N)
    assert chip_smoke.SMALL_RTT == faults.RTT
    bank, grid = chip_smoke.small_fault_grid()
    assert len(grid) == 24 and grid.max_faults == 3
    assert bank.key.shape == (faults.T, faults.N, faults.K)


@pytest.mark.parametrize("fig", ["fig16", "fig17"])
def test_fault_figure_phases_run_the_reference_figures(fig, monkeypatch):
    """Phases 5c / 5d run benchmarks/figures.py's fig16 / fig17 under
    --full: its cells (worlds carried across equal), terminals, horizon,
    warmup and bank, taken from `repro_torch.bench.figures`' sweeps."""
    import jax
    import numpy as np

    from benchmarks import figures
    from repro.core import engine as r_engine
    from repro_torch import interop
    from repro_torch.core.engine.state import tree_leaves

    class Seen(Exception):
        pass

    seen = {}

    def capture(tag, cells, bank, terminals, **kw):
        seen.update(cells=cells, bank=bank, terminals=terminals, kw=kw)
        raise Seen

    monkeypatch.setattr(figures, "run_sweep", capture)
    with pytest.raises(Seen):
        {"fig16": figures.fig16_faults, "fig17": figures.fig17_partitions}[fig](quick=False)
    want = r_engine.Grid(seen["cells"])
    sweep = chip_smoke.fig_sweep(fig)
    got = Grid(sweep.cells)
    assert got.cells == want.cells and got.max_faults == want.max_faults
    rw = interop.worlds_from_numpy(jax.tree_util.tree_map(np.asarray, want.worlds()))
    for (name, x), (_, y) in zip(tree_leaves(got.worlds()), tree_leaves(rw)):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert seen["terminals"] == sweep.terminals
    assert seen["kw"] == dict(horizon_s=sweep.horizon_s, warmup_s=sweep.warmup_s)
    ref_bank, bank = seen["bank"], sweep.bank
    for f in workloads.BANK_ARRAYS:
        assert np.array_equal(getattr(bank, f).numpy(), np.asarray(getattr(ref_bank, f))), f
    ref = chip_smoke.FIG16_REF if fig == "fig16" else chip_smoke.FIG17_REF
    assert [r[:2] for r in ref] == [(c["schedule"], c["preset"]) for c in got.cells]
