"""The port's training forward and train step against the reference, on
the reduced configs, from the reference's own weights (`init_params` with
PRNGKey(0), its norm scales perturbed as `tests/test_torch_models.py` does).

Tolerances:
- `forward_train` logits: the model tests' bf16 limits, 0.05 abs + rel
  (0.08 for the recurrent stacks). xLSTM, the MoE stacks and the
  encoder-decoder are held layer by layer (LAYERWISE), each of the port's
  training layers on the reference's own input, then the head on the
  reference's final hidden state.
- One train step of reduced llama3.2-3b against `jax.jit` of the
  reference's `make_train_step`, accum 1 and 2: the loss within 2e-3 abs,
  grad_norm within 1% rel, every gradient leaf within 3e-2 relative L2
  (against `jax.value_and_grad` of the reference's `loss_fn`, summed over
  the microbatches as its scan sums them), lr and step equal.
- `remat` "full" and "dots": loss and every gradient bit for bit those of
  `remat=False` on the CPU (recomputation repeats the same ops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.data import pipeline as r_pipe
from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.models import stack as r_stack
from repro.models.schema import init_params as r_init_params
from repro.optim import adamw as r_adamw
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.models import model as t_model
from repro_torch.models import stack as t_stack
from repro_torch.optim import adamw as t_adamw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = r_registry.names()
LOGIT_TOL, RECURRENT_TOL = 0.05, 0.08
CPU = torch.device("cpu")


def _weights(cfg_r, seed=0):
    p = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    out = {}
    for name, x in p.items():
        x = np.asarray(x)
        if name.rsplit(".", 1)[-1] in ("ln", "ln2", "final_ln", "bq", "bk", "bv"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        out[name] = x
    return out


def _batch(cfg, B=2, S=64, seed=3):
    """A training batch as the reference's `input_specs` lays it out: tokens
    and labels; a vision model's 8 patch embeddings ahead of the tokens; an
    encoder-decoder's 32 frames and decoder tokens / labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, 8, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_encdec:
        batch = {"frames": rng.standard_normal((B, 32, cfg.frontend_dim)).astype(np.float32),
                 "dec_tokens": toks[:, :S], "dec_labels": toks[:, 1:]}
    return batch


def _close(out, ref, label, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=label)


# held layer by layer: xLSTM (a free-running bf16 stack is chaotic at these
# weights), the MoE stacks (a bf16 top-k decision at a near tie of the gates
# flips, C6: the tokens whose routing differs are explained by
# `routelog.compare` and left out, at most routelog.MAX_FLIPS of the
# decisions: a share, so these run 4 rows, 256 decisions a layer) and the
# encoder-decoder (each encoder
# layer, then each decoder layer on the reference's encoder output: over the
# 2 + 1 layers a few of its 65,536 logits drift past 0.05 where the
# reference's are near zero)
LAYERWISE = ("xlstm-350m", "mixtral-8x7b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2")


def _bf16(x_r):
    return torch.from_numpy(np.array(x_r.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    weights = _weights(cfg_r)
    B = 4 if cfg_r.n_experts else 2
    batch = _batch(cfg_r, B=B)
    p_t = interop.params_from_numpy(weights, CPU)  # float32 masters, cast in the graph
    b_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    b_r = {k: jnp.asarray(v) for k, v in batch.items()}
    recurrent = any(m in ("mlstm", "slstm", "rglru") for m, _ in cfg_r.pattern)
    tol = RECURRENT_TOL if recurrent else LOGIT_TOL
    got = t_stack.forward_train(cfg_t, p_t, b_t)
    S_out = batch["dec_tokens" if cfg_r.is_encdec else "tokens"].shape[1] + (
        8 if cfg_r.frontend == "vision" else 0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S_out, cfg_r.vocab)
    if arch not in LAYERWISE:
        ref = r_stack.forward_train(cfg_r, weights, b_r)
        _close(got.float().numpy(), ref, f"{arch} logits", tol)
        return
    _hold_layerwise(arch, cfg_r, cfg_t, weights, p_t, b_r, tol)


def _hold_layerwise(arch, cfg_r, cfg_t, weights, p_t, b_r, tol):
    """Each of the port's training layers on the reference's input (the
    reference's layers jitted, as its scan runs them), then the head on the
    reference's final hidden state."""
    from test_torch_models import _hold_routed, _reference_ffn_input
    from test_torch_moe import reference_routing

    from repro_torch.models import routelog

    def params_of(pfx, g):
        return {k: jnp.asarray(v[g] if g is not None else v) for k, v in weights.items()
                if k.startswith(pfx + ".")}

    enc_r = enc_t = None
    if cfg_r.is_encdec:
        x_r, pos = r_stack._embed_inputs(cfg_r, weights, {"frames": b_r["frames"]})
        for g in range(cfg_r.n_enc_layers):
            p_r = params_of("eblk0", g)
            y_r = jax.jit(lambda p, x: r_stack._apply_layer(cfg_r, p, "eblk0", "gqa", "dense", x,
                                                            pos, causal=False)[0])(p_r, x_r)
            y_t = t_stack._encoder_layer(cfg_t, t_stack._layer(p_t, "eblk0", g), _bf16(x_r),
                                         torch.from_numpy(np.array(pos)))
            _close(y_t.float().numpy(), y_r, f"{arch} encoder layer {g}", tol)
            x_r = y_r
        enc_r = r_layers.rmsnorm(x_r, jnp.asarray(weights["enc_final_ln"]))
        enc_t = _bf16(enc_r)
        x_r, pos = r_stack._embed_inputs(cfg_r, weights, {"tokens": b_r["dec_tokens"]})
    else:
        x_r, pos = r_stack._embed_inputs(cfg_r, weights, b_r)
    x_t = t_stack._embed_inputs(cfg_t, p_t, {k: torch.from_numpy(np.array(v))
                                             for k, v in b_r.items() if k != "frames"}
                                if not cfg_r.is_encdec else
                                {"tokens": torch.from_numpy(np.array(b_r["dec_tokens"]))})[0]
    _close(x_t.float().numpy(), x_r, f"{arch} embedding", 0.0)
    positions = torch.from_numpy(np.array(pos))
    n = flips = 0
    with routelog.RouteLog() as log:
        for pfx, g, mixer, fk in t_stack._layers(cfg_t):
            p_r = params_of(pfx, g)
            y_r = jax.jit(lambda p, x, e, pfx=pfx, mixer=mixer, fk=fk: r_stack._apply_layer(
                cfg_r, p, pfx, mixer, fk, x, pos, e)[0])(p_r, x_r, enc_r)
            y_t = t_stack._train_layer(cfg_t, t_stack._layer(p_t, pfx, g), pfx, mixer, fk,
                                       _bf16(x_r), positions, enc_t)
            label = f"{arch} {pfx} layer {g}"
            if fk == "moe":
                h_r = jax.jit(lambda p, x, pfx=pfx, mixer=mixer: _reference_ffn_input(
                    cfg_r, p, pfx, mixer, x, positions=pos))(p_r, x_r)
                route_r = jax.jit(lambda p, h, pfx=pfx: reference_routing(
                    cfg_r, p, h, pfx + ".ffn"))(p_r, h_r)
                d = _hold_routed(label, y_t, y_r, log.calls.pop(), route_r, tol)
                n, flips = n + d[0], flips + d[1]
            else:
                _close(y_t.float().numpy(), y_r, label, tol)
            x_r = y_r
    assert flips <= routelog.MAX_FLIPS * max(n, 1), (flips, n)
    head = jnp.asarray(weights["embed"]).T if cfg_r.tie_embeddings else jnp.asarray(
        weights["lm_head"])
    xn = r_layers.rmsnorm(x_r, jnp.asarray(weights["final_ln"]))
    ref = jnp.einsum("bsd,dv->bsv", xn, head.astype(xn.dtype))
    got = t_stack._head(p_t, t_stack.rmsnorm(_bf16(x_r), p_t["final_ln"]))
    _close(got.float().numpy(), ref, f"{arch} head", tol)


def _llama():
    return r_registry.reduced("llama3.2-3b"), t_registry.reduced("llama3.2-3b")


def _data_batch(cfg_r):
    b = r_pipe.global_batch(r_pipe.DataConfig(vocab=cfg_r.vocab, seq_len=64, global_batch=8), 0)
    return {k: np.array(v) for k, v in b.items()}


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    cfg_r, cfg_t = _llama()
    weights = _weights(cfg_r)
    batch = _data_batch(cfg_r)
    opt = dict(lr=3e-3, total_steps=30, warmup_steps=1)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    step_r = jax.jit(r_model.make_train_step(cfg_r, r_adamw.AdamWConfig(**opt), accum=accum))
    _, st_r, m_r = step_r(p_r, r_adamw.init_state(p_r), {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    # the reference's gradient, accumulated as its scan body accumulates it
    vg = jax.jit(jax.value_and_grad(lambda p, b: r_model.loss_fn(cfg_r, p, b)))
    mb = 8 // accum
    g_r = None
    for i in range(accum):
        _, g = vg(p_r, {k: jnp.asarray(v[i * mb:(i + 1) * mb]) for k, v in batch.items()})
        g_r = g if g_r is None else jax.tree.map(jnp.add, g_r, g)
    g_r = jax.tree.map(lambda x: np.asarray(x / accum), g_r)

    p_t = interop.params_from_numpy(weights, CPU)
    b_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t, g_t = t_model.accumulated_grads(cfg_t, p_t, b_t, accum)
    for n in g_r:
        assert g_t[n].dtype == torch.float32
        assert _rel_l2(g_t[n].numpy(), g_r[n]) <= 3e-2, n
    step_t = t_model.make_train_step(cfg_t, t_adamw.AdamWConfig(**opt), accum=accum)
    p_t, st_t, m_t = step_t(p_t, t_adamw.init_state(p_t), b_t)
    assert float(loss_t) == float(m_t["loss"])
    assert abs(float(m_t["loss"]) - float(m_r["loss"])) <= 2e-3
    assert abs(float(m_t["grad_norm"]) / float(m_r["grad_norm"]) - 1) <= 1e-2
    assert np.float32(m_t["lr"]) == np.float32(m_r["lr"])
    assert int(st_t["step"]) == int(st_r["step"]) == 1 and st_t["step"].dtype == torch.int32


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise_the_plain_backward(remat):
    """Two pattern groups of reduced llama3.2-3b and one of
    recurrentgemma-9b (rglru x 2 + capped local attention, then its tail):
    the recomputing backward gives the same loss and gradients bit for bit."""
    for arch, changes in (("llama3.2-3b", dict(n_layers=2)), ("recurrentgemma-9b", {})):
        cfg_r = dataclasses.replace(r_registry.reduced(arch), **changes)
        cfg_t = dataclasses.replace(t_registry.reduced(arch), **changes)
        p_t = interop.params_from_numpy(_weights(cfg_r), CPU)
        b_t = {k: torch.from_numpy(v[:2, :32]) for k, v in _data_batch(cfg_r).items()}
        loss0, g0 = t_model.accumulated_grads(cfg_t, p_t, b_t, remat=False)
        loss1, g1 = t_model.accumulated_grads(cfg_t, p_t, b_t, remat=remat)
        assert torch.equal(loss0, loss1), arch
        for n in g0:
            assert torch.equal(g0[n], g1[n]), (arch, n)
