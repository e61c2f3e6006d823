"""The whole train step's gradients of every reduced family but xlstm-350m
against the reference, leaf by leaf.

For each reduced registry config, from the reference's own weights and
batch (`tests/test_torch_train.py`'s `_weights` / `_batch`: B = 2, S = 64;
B = 4 for the MoE stacks, as that file's forward test, since their routing
is held by a share of the decisions), three sets of gradients:
- the reference's `jax.value_and_grad(loss_fn)`;
- the port's `accumulated_grads` in bf16 (the training path's activations);
- the port's with `stack.ACT_DTYPE = float32`, no other change.
The port's bf16-vs-float32 gap on a leaf is its own bf16 noise there. Each
leaf's relative L2 against the reference is held within GAP_FACTOR times
that gap, or GAP_FLOOR where the gap is smaller (measured on these
weights: every leaf within 1.75x, the largest qwen2-72b's cancelling bias
gradient `blk0.mix.bk`; the smallest gap 0.0073, so the floor does not
bind). A leaf past the bound is a port fault (ROADMAP §C), not a reason to
widen it.

xlstm-350m is held layer by layer (`tests/test_torch_recurrent_bwd.py`,
chip_smoke phase 21c): a free-running bf16 xLSTM stack is chaotic at random
weights (`tests/test_torch_models.py`). The MoE stacks' bf16 routing flips
at near ties (ROADMAP C6): the bf16 step's routing of the first MoE layer
is held against the float32 step's by `routelog.compare` (an expert flip
only where the float32 gates of the two experts are within TIE_GAP, a
kept / dropped difference only after such a flip in its row, at most
MAX_FLIPS of the decisions). A later MoE layer's input already carries an
earlier layer's flips, so its routing is not held by that rule (on
llama4-scout's third layer a token moves off a tie). The router leaves,
whose gradients the flips move (~1.0-1.4 relative L2 in all three
comparisons on llama4-scout), are held by the same bound as every other
leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models import model as r_model
from repro_torch import interop
from repro_torch.configs import registry as t_registry
from repro_torch.models import model as t_model
from repro_torch.models import routelog
from repro_torch.models import stack as t_stack
from test_torch_train import _batch, _rel_l2, _weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = [a for a in r_registry.names() if a != "xlstm-350m"]
GAP_FACTOR = 2.0
GAP_FLOOR = 1e-3  # relative L2
CPU = torch.device("cpu")


def _port_grads(cfg_t, p_t, b_t):
    """(loss, grads, the routing of every MoE layer) of one port step."""
    with routelog.RouteLog() as log:
        loss, grads = t_model.accumulated_grads(cfg_t, p_t, b_t)
    return loss, grads, log.calls


@pytest.mark.parametrize("arch", ARCHS)
def test_step_gradients_within_twice_the_ports_own_bf16_gap(arch, monkeypatch):
    cfg_r, cfg_t = r_registry.reduced(arch), t_registry.reduced(arch)
    weights = _weights(cfg_r)
    batch = _batch(cfg_r, B=4 if cfg_r.n_experts else 2)
    p_r = {k: jnp.asarray(v) for k, v in weights.items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: r_model.loss_fn(cfg_r, p, b)))
    loss_r, g_r = vg(p_r, {k: jnp.asarray(v) for k, v in batch.items()})

    p_t = interop.params_from_numpy(weights, CPU)
    b_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss16, g16, route16 = _port_grads(cfg_t, p_t, b_t)
    monkeypatch.setattr(t_stack, "ACT_DTYPE", torch.float32)
    loss32, g32, route32 = _port_grads(cfg_t, p_t, b_t)
    monkeypatch.undo()

    assert np.isfinite(float(loss16)) and np.isfinite(float(loss32))
    assert len(route16) == len(route32) == (len(list(t_stack._layers(cfg_t)))
                                            if cfg_t.n_experts else 0)
    if route16:
        r32, r16 = route32[0], route16[0]
        _, flipped, shifted = routelog.compare((r32.topi, r32.kept, r32.gates),
                                               (r16.topi, r16.kept), f"{arch} first MoE layer")
        decisions = r16.topi.shape[0] * r16.topi.shape[1]
        assert flipped + shifted <= routelog.MAX_FLIPS * decisions, (flipped, shifted)

    assert set(g16) == set(g32) == set(g_r)
    bad = []
    for name in g_r:
        assert g16[name].dtype == g32[name].dtype == torch.float32, name
        gap = _rel_l2(g16[name].numpy(), g32[name].numpy())
        got = _rel_l2(g16[name].numpy(), np.asarray(g_r[name]))
        if not got <= max(GAP_FACTOR * gap, GAP_FLOOR):
            bad.append(f"{name}: {got:.4g} against the reference, own bf16 gap {gap:.4g}")
    assert not bad, f"{arch}: " + "; ".join(bad)
