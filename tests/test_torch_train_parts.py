"""The training slice's parts against the reference: the flash-attention
backward's plain version and the differentiable `mha`, AdamW, the threefry
generator and the data pipeline, the one-round-commit checkpoints (both
directions), the training state's interop and the abstract specs.

Tolerances: the attention gradients are float32 math in another order,
held at 1e-5 (abs + rel) against `jax.vjp` of the reference's
`attention_ref` (causal, window, chunk-local, non-causal, dv < dh) or, where
`attention_ref` has no such option, of its model attention
`chunked_attention` in float32 (the logit cap; a key length of its own).
AdamW's arithmetic is the reference's op for op: params, m and v within
rtol 1e-6, plus 1e-6 of the leaf's largest entry (the global norm is summed
in another order, so the clip scale may differ by an ulp, which
b1·m + (1 - b1)·g amplifies in the few entries where its two terms cancel);
the learning rate within 1e-6 (XLA's cos and torch's differ by an ulp in
the cosine phase). The generator's bits are exact; a token may differ only
where the float32 exp(u · log V) lies within 2 ulp of an integer (on these
seeds five positions do, and no token differs). Checkpoints restore
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.data import pipeline as r_pipe
from repro.dist import checkpoint as r_ckpt
from repro.kernels.flash_attention.ref import attention_ref as r_attention_ref
from repro.models import attention as r_attn
from repro.models import model as r_model
from repro.models.config import LM_SHAPES as R_SHAPES
from repro.configs import registry as r_registry
from repro.optim import adamw as r_adamw
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.data import pipeline as t_pipe
from repro_torch.data import threefry
from repro_torch.dist import checkpoint as t_ckpt
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_bwd as t_bwd_bind
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.mlstm import ops as t_mlstm
from repro_torch.kernels.rglru import ops as t_rglru
from repro_torch.models import model as t_model
from repro_torch.models.config import LM_SHAPES as T_SHAPES
from repro_torch.optim import adamw as t_adamw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, Sq, Sk, H, KV, dh, dv, causal, window, chunk_local, cap)
BWD_CASES = {
    "causal": (2, 96, 96, 4, 2, 32, 32, True, 0, False, 0.0),
    "window": (1, 80, 80, 4, 4, 48, 48, True, 24, False, 0.0),
    "chunk_local": (2, 64, 64, 6, 2, 32, 32, True, 16, True, 0.0),
    "cap": (1, 72, 72, 4, 1, 32, 32, True, 0, False, 5.0),
    "non_causal": (1, 50, 50, 2, 1, 40, 40, False, 0, False, 0.0),
    "cross": (2, 24, 70, 4, 2, 32, 32, False, 0, False, 0.0),
    "narrow_v": (1, 64, 64, 4, 4, 48, 32, True, 0, False, 0.0),
}
BWD_TOL = 1e-5


def _bwd_inputs(case, seed=0):
    B, Sq, Sk, H, KV, dh, dv, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dv), (B, Sq, H, dv))]


def _reference_grads(case, q, k, v, g):
    """jax.vjp of the reference's oracle ([B,H,S,d] layout) or, for the cap
    and the cross case, of its float32 model attention ([B,S,H,d])."""
    *_, causal, window, cl, cap = case
    if cap or k.shape[1] != q.shape[1]:
        def f(q, k, v):
            return r_attn.chunked_attention(q, k, v, causal=causal, window=window,
                                            chunk_local=cl, logit_cap=cap,
                                            q_chunk=q.shape[1])
        out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
        return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]

    def f(q, k, v):
        return r_attention_ref(q, k, v, causal=causal, window=window, chunk_local=cl)

    tr = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *tr)
    grads = vjp(jnp.asarray(g.transpose(0, 2, 1, 3)))
    return [np.asarray(x).transpose(0, 2, 1, 3) for x in (out, *grads)]


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_attention_backward_matches_jax_grad(name):
    """`attention_bwd_ref` (the kernel's plain version, FA2 form), given the
    plain forward's row lse as the wrapper passes it, and autograd through
    the port's CPU `mha` against the reference's gradient."""
    case = BWD_CASES[name]
    *_, causal, window, cl, cap = case
    q, k, v, g = _bwd_inputs(case)
    ref = _reference_grads(case, q, k, v, g)
    kw = dict(causal=causal, window=window, chunk_local=cl, logit_cap=cap)

    qt, kt, vt, gt = (torch.from_numpy(x).transpose(1, 2).contiguous() for x in (q, k, v, g))
    out, lse = attention_ref(qt, kt, vt, **kw, with_lse=True)
    assert torch.equal(out, attention_ref(qt, kt, vt, **kw))
    plain = attention_bwd_ref(qt, kt, vt, out, gt, lse, **kw)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref[0], atol=BWD_TOL, rtol=BWD_TOL)
    for got, want, label in zip(plain, ref[1:], "qkv"):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL, err_msg=f"{name} attention_bwd_ref d{label}")

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    launches = (t_flash.mha.launches, t_flash.mha_backward.launches)
    o = t_flash.mha(*leaves, **kw)
    o.backward(torch.from_numpy(g))
    assert (t_flash.mha.launches, t_flash.mha_backward.launches) == launches  # plain on the CPU
    for x, want, label in zip(leaves, ref[1:], "qkv"):
        np.testing.assert_allclose(x.grad.numpy(), want, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"{name} mha autograd d{label}")


def test_mha_without_a_gradient_takes_the_plain_path():
    """No input requires a gradient (or grad mode is off): the output has no
    autograd history, as before the backward existed."""
    q, k, v, _ = (torch.from_numpy(x) for x in _bwd_inputs(BWD_CASES["causal"]))
    assert t_flash.mha(q, k, v).grad_fn is None
    with torch.no_grad():
        assert t_flash.mha(q.requires_grad_(True), k, v).grad_fn is None


def test_backward_on_a_card_launches_or_raises(monkeypatch):
    """A CUDA tensor that needs a gradient goes to the port's Function
    (`_Mha`, `_Mlstm`, `_Rglru`, `_RglruScan`), whose backward is the
    hand-written kernel; a backward library that cannot load raises
    `OSError` before any work, never a plain fallback. (No card here: the
    Functions' `apply` is recorded, not run.)"""

    def broken(name):
        raise OSError(f"cannot load lib{name}.so")

    bwd_libs = ("flash_attention_bwd", "mlstm_chunk_bwd", "rglru_scan_bwd")
    binds = (t_bwd_bind, t_mlstm._cuda_bwd, t_rglru._cuda_bwd)
    real_load = _build.load
    monkeypatch.setattr(_build, "load",
                        lambda name: broken(name) if name in bwd_libs else real_load(name))
    for b in binds:
        b.entry.cache_clear()
    for mod in (t_flash, t_mlstm, t_rglru):  # the forward's library "loads"
        monkeypatch.setattr(mod._cuda, "entry", lambda: None)
    counts = (t_flash.mha.launches, t_flash.mha_backward.launches, t_mlstm.mlstm.launches,
              t_mlstm.mlstm_bwd.launches, t_rglru.rglru.launches, t_rglru.rglru_scan.launches,
              t_rglru.rglru_bwd.launches)
    with FakeTensorMode():
        q = torch.empty((1, 16, 4, 32), device="cuda", requires_grad=True)
        kv = torch.empty((1, 16, 2, 32), device="cuda")
        x = torch.empty((1, 2, 16, 32), device="cuda", requires_grad=True)
        gate = torch.empty((1, 2, 16), device="cuda")
        la = torch.empty((1, 16, 8), device="cuda")
        gx = torch.empty((1, 16, 8), device="cuda", requires_grad=True)
        calls = (lambda: t_flash.mha(q, kv, kv), lambda: t_mlstm.mlstm(x, x, x, gate, gate),
                 lambda: t_rglru.rglru(la, gx), lambda: t_rglru.rglru_scan(la, gx))
        for lib, call in zip(("flash_attention_bwd", "mlstm_chunk_bwd", "rglru_scan_bwd",
                              "rglru_scan_bwd"), calls):
            with pytest.raises(OSError, match=f"cannot load lib{lib}"):
                call()
        for b in binds:  # the backward's libraries "load" too: each call takes its Function
            monkeypatch.setattr(b, "entry", lambda: None)
        fns = (t_flash._Mha, t_mlstm._Mlstm, t_rglru._Rglru, t_rglru._RglruScan)
        for fn in fns:
            monkeypatch.setattr(fn, "apply", lambda *a, fn=fn: fn)
        assert [call() for call in calls] == list(fns)
    assert (t_flash.mha.launches, t_flash.mha_backward.launches, t_mlstm.mlstm.launches,
            t_mlstm.mlstm_bwd.launches, t_rglru.rglru.launches, t_rglru.rglru_scan.launches,
            t_rglru.rglru_bwd.launches) == counts
    monkeypatch.undo()
    for b in binds:
        b.entry.cache_clear()


# ---- AdamW ------------------------------------------------------------------

ADAMW_CASES = {
    # (AdamWConfig fields, the state's step, gradient scale: clipping bites above ~1)
    "warmup_first_step": (dict(lr=3e-3, warmup_steps=10, total_steps=100), 0, 0.01),
    "cosine_clipped": (dict(lr=1e-3, warmup_steps=2, total_steps=50), 7, 3.0),
    "past_total": (dict(lr=6e-4, warmup_steps=1, total_steps=5, weight_decay=0.0), 9, 0.3),
}


def _adamw_inputs(step, gscale, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a.w": (17, 9), "b.ln": (9,), "embed": (31, 9)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: (gscale * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
    state = {"m": {n: (0.01 * rng.standard_normal(s)).astype(np.float32) if step else
                   np.zeros(s, np.float32) for n, s in shapes.items()},
             "v": {n: (1e-4 * rng.random(s)).astype(np.float32) if step else
                   np.zeros(s, np.float32) for n, s in shapes.items()},
             "step": np.int32(step)}
    return params, grads, state


@pytest.mark.parametrize("name", list(ADAMW_CASES))
def test_adamw_apply_updates_matches_reference(name):
    fields, step, gscale = ADAMW_CASES[name]
    params, grads, state = _adamw_inputs(step, gscale)
    r_params, r_state, r_stats = r_adamw.apply_updates(
        r_adamw.AdamWConfig(**fields), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state))
    t_params = interop.params_from_numpy(params)
    t_state = interop.opt_state_from_numpy(state)
    t_params, t_state, t_stats = t_adamw.apply_updates(
        t_adamw.AdamWConfig(**fields), t_params, interop.params_from_numpy(grads), t_state)
    def close(got, want, label):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=f"{name} {label}")

    for n in params:
        close(t_params[n], r_params[n], f"param {n}")
        for mom in ("m", "v"):
            close(t_state[mom][n], r_state[mom][n], f"{mom} {n}")
    assert t_state["step"].dtype == torch.int32 and int(t_state["step"]) == int(r_state["step"])
    np.testing.assert_allclose(float(t_stats["grad_norm"]), float(r_stats["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_stats["lr"]), float(r_stats["lr"]), rtol=1e-6)


def test_adamw_schedule_and_state_match_reference():
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for s in range(0, 45):
        want = np.float32(r_adamw.schedule(r_adamw.AdamWConfig(**cfg), jnp.int32(s)))
        got = np.float32(t_adamw.schedule(t_adamw.AdamWConfig(**cfg),
                                          torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"step {s}")
    params = {"x": torch.zeros((3, 2), dtype=torch.bfloat16), "y": torch.ones(4)}
    st = t_adamw.init_state(params)
    assert st["m"]["x"].dtype == torch.float32 and st["m"]["x"].shape == (3, 2)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    ab = t_adamw.abstract_state({n: p.to("meta") for n, p in params.items()})
    assert ab["v"]["y"].device.type == "meta" and ab["v"]["x"].dtype == torch.float32


# ---- threefry and the data pipeline --------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    t_key = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(t_key, np.asarray(key))
    for data in (0, 5, 2**32 - 1):
        np.testing.assert_array_equal(threefry.fold_in(t_key, data),
                                      np.asarray(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(threefry.split(t_key, 7), np.asarray(jax.random.split(key, 7)))
    k1 = jax.random.split(key)[1]
    t_k1 = threefry.split(t_key)[1]
    np.testing.assert_array_equal(threefry.uniform(t_k1, (3, 11)),
                                  np.asarray(jax.random.uniform(k1, (3, 11))))
    np.testing.assert_array_equal(threefry.bernoulli(t_k1, 0.3, (40,)),
                                  np.asarray(jax.random.bernoulli(k1, 0.3, (40,))))
    want = np.asarray(jax.random.normal(k1, (500,)))
    np.testing.assert_allclose(threefry.normal(t_k1, (500,)), want, rtol=2e-5, atol=1e-6)


DATA_CASES = [(512, 64, 8, 0), (1000, 33, 5, 3), (32000, 128, 4, 11)]
# positions whose exp lies within 2 ulp of an integer, and tokens that differ
NEAR_AND_DIFFER = {(512, 64, 8, 0): (1, 0), (1000, 33, 5, 3): (0, 0),
                   (32000, 128, 4, 11): (4, 0)}


@pytest.mark.parametrize("vocab,seq,batch,seed", DATA_CASES)
def test_global_batch_matches_reference(vocab, seq, batch, seed):
    """u and the repeat mask bit for bit (the reference's own jax.random
    calls); tokens and labels equal but where the float32 exp(u log V) lies
    within 2 ulp of an integer (XLA's exp and torch's may round either way):
    none on these seeds. host_batch slices the same rows."""
    r_cfg = r_pipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    t_cfg = t_pipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    near = differ = 0
    logv = np.log(np.float32(vocab))
    for step in (0, 1, 17, 1000):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        k1, k2 = jax.random.split(key)
        u, rep = t_pipe.batch_uniforms(t_cfg, step)
        np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(k1, (batch, seq + 1))))
        np.testing.assert_array_equal(rep, np.asarray(jax.random.bernoulli(k2, 0.5,
                                                                           (batch, seq + 1))))
        e = np.exp((u * logv).astype(np.float64))  # exp of the float32 product, exactly
        close = np.abs(e - np.round(e)) <= 2 * np.spacing(e.astype(np.float32))
        # a token t at column j comes from position j (repeat: j - 1); a
        # label from j + 1 (repeat: j)
        src = np.where(rep, np.roll(close, 1, axis=1), close)
        near += int(close.sum())
        want = r_pipe.global_batch(r_cfg, step)
        got = t_pipe.global_batch(t_cfg, step, device="cpu")
        for name, cols in (("tokens", slice(0, seq)), ("labels", slice(1, seq + 1))):
            assert got[name].dtype == torch.int32
            diff = got[name].numpy() != np.asarray(want[name])
            assert not (diff & ~src[:, cols]).any(), (step, name)
            differ += int(diff.sum())
        rows = batch // 2 if batch % 2 == 0 else batch
        n_hosts = batch // rows
        for h in range(n_hosts):
            hb = t_pipe.host_batch(t_cfg, step, h, n_hosts, device="cpu")
            rb = r_pipe.host_batch(r_cfg, step, h, n_hosts)
            np.testing.assert_array_equal(hb["tokens"].numpy(), np.asarray(rb["tokens"]))
    assert (near, differ) == NEAR_AND_DIFFER[(vocab, seq, batch, seed)]


# ---- checkpoints ---------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "inner": {"scale": rng.standard_normal(2).astype(np.float32),
                      "lst": [np.int32(seed), rng.standard_normal(2).astype(np.float32)]}}


def _t_tree(seed=0):
    t = _tree(seed)
    return {"w": torch.from_numpy(t["w"]), "b": torch.from_numpy(t["b"]).to(torch.bfloat16),
            "inner": {"scale": torch.from_numpy(t["inner"]["scale"]),
                      "lst": [torch.tensor(t["inner"]["lst"][0]),
                              torch.from_numpy(t["inner"]["lst"][1])]}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_checkpoint_round_trip_and_contract(tmp_path):
    """Two hosts' shards round trip (a bf16 leaf as float32 on disk, back in
    bf16); the reference's tests/dist contract: a partial prepare never
    commits, a crash mid-prepare leaves no torn state, commit is
    idempotent, an empty root recovers to None."""
    mgr = t_ckpt.CheckpointManager(tmp_path / "a", n_hosts=2)
    assert mgr.recover() is None
    trees = [_t_tree(0), _t_tree(1)]
    mgr.write_shard(7, 0, trees[0])
    assert not mgr.prepared(7) and not mgr.commit(7) and mgr.latest_step() is None
    mgr.write_shard(7, 1, trees[1])
    assert mgr.prepared(7) and mgr.commit(7) and mgr.commit(7) and mgr.latest_step() == 7
    for h, t in enumerate(trees):
        got = mgr.restore(7, h, like=_t_tree(99))
        for (name, a), (_, b) in zip(_leaves(got), _leaves(t)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    mgr.write_shard(8, 0, trees[0])  # crash before host 1's shard
    assert mgr.recover() == 7
    assert not (tmp_path / "a" / "step_00000008").exists()
    assert (tmp_path / "a" / "step_00000007" / "COMMIT").exists()


def test_checkpoints_cross_between_packages(tmp_path):
    """A reference checkpoint restores in the port bit for bit, and the
    port's in the reference; the npz keys are the same."""
    r_mgr = r_ckpt.CheckpointManager(tmp_path / "ref", n_hosts=1)
    r_mgr.write_shard(3, 0, _tree(4))
    assert r_mgr.commit(3)
    t_mgr = t_ckpt.CheckpointManager(tmp_path / "ref", n_hosts=1)
    assert t_mgr.recover() == 3
    got = t_mgr.restore(3, 0, like=_t_tree(0))
    for (name, a), (_, b) in zip(_leaves(got), _leaves(_tree(4))):
        b = np.asarray(b)
        want = torch.from_numpy(np.array(b)).to(a.dtype)
        assert torch.equal(a, want), name

    t_mgr = t_ckpt.CheckpointManager(tmp_path / "port", n_hosts=1)
    t_mgr.write_shard(5, 0, _t_tree(6))
    assert t_mgr.commit(5)
    r_mgr = r_ckpt.CheckpointManager(tmp_path / "port", n_hosts=1)
    assert r_mgr.recover() == 5
    like = jax.tree.map(jnp.asarray, _tree(0))
    got = r_mgr.restore(5, 0, like)
    for (name, a), (_, b) in zip(_leaves(jax.tree.map(np.asarray, got)), _leaves(_t_tree(6))):
        np.testing.assert_array_equal(a, b.float().numpy() if b.dtype == torch.bfloat16
                                      else b.numpy(), err_msg=name)
    with np.load(tmp_path / "port" / "step_00000005" / "shard_0000.npz") as z_t, \
            np.load(tmp_path / "ref" / "step_00000003" / "shard_0000.npz") as z_r:
        assert sorted(z_t.files) == sorted(z_r.files)


def test_training_state_interop_round_trips():
    params, _, state = _adamw_inputs(3, 1.0)
    t_params = interop.params_from_numpy(params)
    back = interop.params_to_numpy(t_params)
    assert all(np.array_equal(back[n], params[n]) for n in params)
    t_state = interop.opt_state_from_numpy(state)
    assert t_state["step"].dtype == torch.int32 and int(t_state["step"]) == 3
    back = interop.opt_state_to_numpy(t_state)
    for mom in ("m", "v"):
        assert all(np.array_equal(back[mom][n], state[mom][n]) for n in params)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 3
    bf = interop.params_to_numpy({"x": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)})
    assert bf["x"].dtype == np.float32 and bf["x"].tolist() == [1.5, -2.25]


# ---- abstract specs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-26b", "seamless-m4t-large-v2",
                                  "xlstm-350m"])
def test_input_specs_and_abstract_train_state_match_reference(arch):
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    for r_cell, t_cell in zip(R_SHAPES, T_SHAPES):
        assert dataclasses.asdict(r_cell) == dataclasses.asdict(t_cell)
        small = dataclasses.replace(r_cell, seq_len=512, global_batch=2)
        t_small = dataclasses.replace(t_cell, seq_len=512, global_batch=2)
        want = dict(_leaves(r_model.input_specs(cfg_r, small)))
        got = dict(_leaves(t_model.input_specs(cfg_t, t_small)))
        assert set(got) == set(want), (arch, r_cell.name)
        for name, spec in want.items():
            t = got[name]
            assert t.device.type == "meta" and tuple(t.shape) == spec.shape, (arch, name)
            assert str(t.dtype)[6:] == str(spec.dtype), (arch, name)
    r_params, r_state = r_model.abstract_train_state(cfg_r)
    t_params, t_state = t_model.abstract_train_state(cfg_t)
    assert set(t_params) == set(r_params)
    for n, spec in r_params.items():
        assert tuple(t_params[n].shape) == spec.shape and t_params[n].device.type == "meta"
        assert tuple(t_state["m"][n].shape) == spec.shape
        assert t_state["v"][n].dtype == torch.float32
    assert t_state["step"].dtype == torch.int32
