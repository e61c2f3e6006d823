"""The port's geo-serving router and its launcher against the reference.

The router's event loop, its admission draws and its statistics are
integer / float64 host arithmetic in both packages, and Eq.(9)'s p_abort
enters only through `rng.random() < p`: summaries and the latency and
occupancy lists must be exactly equal. With `run_model=True` each
generation runs one real decode step of the reduced model (the reference's
weights, carried across), which must give finite logits.
"""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.launch import serve as r_serve
from repro.models import stack as r_stack
from repro.models.schema import init_params as r_init_params
from repro.serving import engine as r_engine
from repro.serving.kvcache import SlotPool as RSlotPool
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.geo_schedule import ops as geo_ops
from repro_torch.launch import serve as t_serve
from repro_torch.serving import engine as t_engine
from repro_torch.serving.kvcache import SlotPool as TSlotPool
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
POD_ARGS = [(0, 12), (30_000, 12), (100_000, 12)]  # the launcher's pods


def _pods(mod):
    return [mod.PodConfig(rtt_us=r, n_slots=n) for r, n in POD_ARGS]


def _run(mod, cfg, policy, n, rate, run_model, **kw):
    eng = mod.GeoServingEngine(cfg, _pods(mod), policy=policy, run_model=run_model, **kw)
    for r in mod.synthetic_workload(n, len(POD_ARGS), rate_per_s=rate):
        eng.submit(r)
    return eng, eng.run(until_us=120_000_000)


def test_synthetic_workload_equals_reference():
    a = r_engine.synthetic_workload(200, 3, rate_per_s=700, seed=3)
    b = t_engine.synthetic_workload(200, 3, rate_per_s=700, seed=3)
    key = lambda r: (r.rid, r.arrive_us, r.gen_len, r.fanout)  # noqa: E731
    assert [key(r) for r in a] == [key(r) for r in b]


@pytest.mark.parametrize("policy", ["geotp", "fcfs"])
@pytest.mark.parametrize("n,rate,timeout_us", [(300, 700.0, 2_000_000), (120, 20_000.0, 5_000)])
def test_router_without_model_equals_reference(policy, n, rate, timeout_us):
    """The admission path, model off; in the second case 20,000 req/s
    overflow the 12-slot pods, so requests queue and time out."""
    cfg_r, cfg_t = r_registry.reduced("llama3.2-3b"), t_registry.reduced("llama3.2-3b")
    er, res_r = _run(r_engine, cfg_r, policy, n, rate, False, slot_timeout_us=timeout_us)
    launches = geo_ops.geo_schedule.launches
    et, res_t = _run(t_engine, cfg_t, policy, n, rate, False, slot_timeout_us=timeout_us,
                     device="cpu")
    assert geo_ops.geo_schedule.launches == launches  # CPU: the plain version
    assert res_t == res_r
    assert et.stats.lat_us == er.stats.lat_us and et.stats.occ_us == er.stats.occ_us
    if timeout_us == 5_000:
        assert res_r["rejected"] > 0  # slot timeouts happened
    np.testing.assert_array_equal(et.a_cnt, er.a_cnt)
    np.testing.assert_array_equal(et.wait_ewma_us, er.wait_ewma_us)


@pytest.mark.parametrize("policy", ["geotp", "fcfs"])
def test_router_with_model_equals_reference(policy):
    _router_with_model_equals_reference("llama3.2-3b", policy)


@pytest.mark.parametrize("policy", ["geotp", "fcfs"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-9b"])
def test_recurrent_router_with_model_equals_reference(policy, arch):
    """Each generation runs one decode step of the reduced recurrent model:
    nested float32 states and bf16 conv buffers in the pods' caches and in
    the step's fresh cache."""
    _router_with_model_equals_reference(arch, policy)


@pytest.mark.parametrize("policy", ["geotp", "fcfs"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"])
def test_moe_and_mla_router_with_model_equals_reference(policy, arch):
    """Each generation runs one decode step of the reduced MoE model
    (mixtral: top-2 over a swa ring; llama4: top-1, chunk-local and NoPE
    layers) or MLA model (minicpm3: the compressed latent cache)."""
    _router_with_model_equals_reference(arch, policy)


def _router_with_model_equals_reference(arch, policy):
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    weights = {k: np.asarray(v) for k, v in
               r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(0)).items()}
    er, res_r = _run(r_engine, cfg_r, policy, 20, 100.0, True)
    et, res_t = _run(t_engine, cfg_t, policy, 20, 100.0, True, device="cpu",
                     params=interop.params_from_numpy(weights, CPU))
    assert res_t == res_r and res_t["completed"] == 20
    assert et.stats.lat_us == er.stats.lat_us and et.stats.occ_us == er.stats.occ_us
    assert et.params["embed"].dtype == torch.bfloat16  # cast once for serving


def test_generation_runs_a_decode_step_and_checks_its_logits(monkeypatch):
    cfg = t_registry.reduced("llama3.2-3b")
    calls = []
    eng = t_engine.GeoServingEngine(cfg, _pods(t_engine), run_model=True, device="cpu")
    real = eng.decode

    def spy(params, token, pos, cache):
        calls.append((tuple(token.shape), tuple(cache["blk0"]["k"].shape)))
        return real(params, token, pos, cache)

    eng.decode = spy
    for r in t_engine.synthetic_workload(6, 3, rate_per_s=100):
        eng.submit(r)
    eng.run(until_us=120_000_000)
    assert len(calls) == len(eng.stats.occ_us) > 0
    G, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    assert set(calls) == {((1,), (G, 1, 64, KV, hd))}  # the reference's 64-slot cache

    def nan_step(params, token, pos, cache):
        return torch.full((1, cfg.vocab), float("nan")), cache

    eng2 = t_engine.GeoServingEngine(cfg, _pods(t_engine), run_model=True, device="cpu")
    eng2.decode = nan_step
    for r in t_engine.synthetic_workload(3, 3, rate_per_s=100):
        eng2.submit(r)
    with pytest.raises(FloatingPointError, match="non-finite logits"):
        eng2.run(until_us=120_000_000)


def test_slot_pool_equals_reference():
    cfg_r, cfg_t = r_registry.reduced("h2o-danube-3-4b"), t_registry.reduced("h2o-danube-3-4b")
    pr, pt = RSlotPool(cfg_r, 4, 32), TSlotPool(cfg_t, 4, 32, CPU)
    for _ in range(3):
        assert pt.reserve(2) == pr.reserve(2)
        assert pt.occupancy == pr.occupancy
        pr.release([0]), pt.release([0])
    got = interop.cache_to_numpy(pt.cache)
    for blk, d in pr.cache.items():
        for leaf, x in d.items():
            assert got[blk][leaf].shape == x.shape and not got[blk][leaf].any()
            assert pt.cache[blk][leaf].device == CPU


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-9b"])
def test_recurrent_slot_pool_equals_reference(arch):
    """The pool's cache over all slots: the reference's nested layout,
    float32 recurrent states, bf16 conv buffers and K/V, all zero."""
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    pr, pt = RSlotPool(cfg_r, 3, 32), TSlotPool(cfg_t, 3, 32, CPU)
    ref = jax.tree_util.tree_leaves_with_path(pr.cache)
    got = jax.tree_util.tree_leaves_with_path(pt.cache)
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (_, x), (_, y) in zip(ref, got):
        assert tuple(y.shape) == x.shape and not y.any() and y.device == CPU
        assert str(y.dtype).split(".")[-1] == str(x.dtype)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"])
def test_moe_and_mla_slot_pool_equals_reference(arch):
    """The pool's cache over all slots: rings for swa / cla, a linear
    NoPE `gqa` cache (llama4), MLA's bf16 latent c_kv and k_rope, all zero,
    in the reference's layout."""
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    pr, pt = RSlotPool(cfg_r, 3, 32), TSlotPool(cfg_t, 3, 32, CPU)
    ref = jax.tree_util.tree_leaves_with_path(pr.cache)
    got = jax.tree_util.tree_leaves_with_path(pt.cache)
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (_, x), (_, y) in zip(ref, got):
        assert tuple(y.shape) == x.shape and not y.any() and y.device == CPU
        assert str(y.dtype).split(".")[-1] == str(x.dtype)


@pytest.mark.parametrize("arch,changes", [("internvl2-26b", {}), ("seamless-m4t-large-v2", {}),
                                          ("h2o-danube-3-4b", {"kv_cache_dtype": "int8"})])
def test_frontend_encdec_and_int8_slot_pool_equals_reference(arch, changes):
    """The pool's cache: the vision model's plain K/V, the encoder-decoder's
    {"self", "xk", "xv"} with an empty memory (enc_len = 0), int8 K/V with
    float32 scales; all zero, in the reference's layout and dtypes."""
    cfg_r = dataclasses.replace(r_registry.reduced(arch), **changes)
    cfg_t = dataclasses.replace(t_registry.reduced(arch), **changes)
    pr, pt = RSlotPool(cfg_r, 3, 32), TSlotPool(cfg_t, 3, 32, CPU)
    ref = jax.tree_util.tree_leaves_with_path(pr.cache)
    got = jax.tree_util.tree_leaves_with_path(pt.cache)
    assert [jax.tree_util.keystr(k) for k, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref]
    for (_, x), (_, y) in zip(ref, got):
        assert tuple(y.shape) == x.shape and not y.any() and y.device == CPU
        assert str(y.dtype).split(".")[-1] == str(x.dtype)


@pytest.mark.parametrize(
    "argv",
    [
        ["--requests", "300", "--rate", "700", "--no-model"],
        ["--requests", "40", "--rate", "1500", "--policy", "fcfs", "--no-model"],
        ["--requests", "12", "--rate", "100", "--policy", "geotp"],
        ["--arch", "xlstm-350m", "--requests", "10", "--rate", "100"],
        ["--arch", "recurrentgemma-9b", "--requests", "10", "--rate", "100"],
        ["--arch", "mixtral-8x7b", "--requests", "10", "--rate", "100"],
        ["--arch", "llama4-scout-17b-a16e", "--requests", "10", "--rate", "100"],
        ["--arch", "minicpm3-4b", "--requests", "10", "--rate", "100"],
        ["--arch", "internvl2-26b", "--requests", "10", "--rate", "100"],
        ["--arch", "seamless-m4t-large-v2", "--requests", "10", "--rate", "100"],
    ],
)
def test_launcher_output_equals_reference(argv, tmp_path):
    out_r, out_t = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_r):
        res_r = r_serve.main(argv)
    with contextlib.redirect_stdout(out_t):
        res_t = t_serve.main(argv + ["--device", "cpu", "--out", str(tmp_path / "r.json")])
    assert out_t.getvalue() == out_r.getvalue() and res_t == res_r
    assert (tmp_path / "r.json").exists()


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_registry.reduced("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.GeoServingEngine(cfg, _pods(t_engine), run_model=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--requests", "2", "--no-model"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TSlotPool(cfg, 2, 8)


def test_router_decode_counts_no_launch_on_the_cpu():
    cfg = dataclasses.replace(t_registry.reduced("llama3.2-3b"), n_layers=1)
    before = dec_ops.decode.launches
    eng, res = _run(t_engine, cfg, "geotp", 5, 100.0, True, device="cpu")
    assert res["completed"] == 5 and dec_ops.decode.launches == before
