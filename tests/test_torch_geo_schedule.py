"""The `geo_schedule` kernel's plain version and the scheduler / hot-table
math of the port against the reference.

Tolerances: integer outputs (Eq.8 offsets, slots, admission/commit
decisions, Eq.4 w_lat) are bitwise. Eq.(9) p_abort is held within atol
1e-6: it goes through log/exp, whose float32 results may differ by an ulp
or two between libms (XLA's, PyTorch's CPU kernels, CUDA's logf/expf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotspot as r_hs
from repro.core import scheduler as r_sched
from repro.kernels.geo_schedule.ops import schedule_batch
from repro_torch.core import hotspot as t_hs
from repro_torch.core import scheduler as t_sched
from repro_torch.kernels.geo_schedule import ops as t_ops
from repro_torch.kernels.geo_schedule.ref import geo_schedule_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (N, D, K, bn) — the reference kernel's GEO_CASES, plus the lockstep
# engine's shape (N = B lanes, D = 4, K = 5)
GEO_CASES = [
    (64, 4, 8, 256),
    (256, 8, 16, 128),
    (100, 3, 5, 32),
    (48, 4, 5, 16),
    (37, 2, 4, 8),
    (16, 4, 5, 16),
]


def _inputs(n, d, k, seed=4):
    rng = np.random.default_rng(seed)
    tau = rng.integers(0, 300_000, (n, d)).astype(np.int32)
    lel = rng.integers(0, 50_000, (n, d)).astype(np.int32)
    inv = rng.random((n, d)) < 0.6
    inv[:, 0] = True
    inv[-1] = False  # an all-masked row: off = 0
    c = rng.integers(0, 100, (n, k)).astype(np.int32)
    t = (c + rng.integers(0, 50, (n, k))).astype(np.int32)
    a = rng.integers(0, 10, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < 0.8
    valid[-2] = False  # an all-masked row: p = 0
    return tau, lel, inv, c, t, a, valid


@pytest.mark.parametrize("n,d,k,bn", GEO_CASES)
def test_plain_version_matches_reference_kernel(n, d, k, bn):
    args = _inputs(n, d, k)
    off_k, p_k = schedule_batch(*(jnp.asarray(x) for x in args), bn=bn, interpret=True)
    off_r, p_r = r_sched.plan_dispatch(*(jnp.asarray(x) for x in args))
    targs = [torch.from_numpy(x) for x in args]
    launches = t_ops.geo_schedule.launches
    off, p = t_ops.geo_schedule(*targs)  # CPU tensors: the plain version
    assert t_ops.geo_schedule.launches == launches  # plain calls are not launches
    assert off.dtype == torch.int32 and p.dtype == torch.float32
    assert off.shape == (n, d) and p.shape == (n,)
    for o_ref, p_ref in ((off_k, p_k), (off_r, p_r)):
        np.testing.assert_array_equal(off.numpy(), np.asarray(o_ref))
        np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-6)
    assert off[-1].eq(0).all() and p[-2] == 0.0
    off2, p2 = t_sched.plan_dispatch(*targs)
    np.testing.assert_array_equal(off2.numpy(), off.numpy())
    np.testing.assert_array_equal(p2.numpy(), p.numpy())


@pytest.mark.parametrize("n,d,k,bn", GEO_CASES[:3])
def test_schedule_batch_is_the_reference_public_op(n, d, k, bn):
    """The reference's public name `schedule_batch` (its `bn` taken and
    ignored): the wrapper's outputs, equal to the reference op's."""
    args = _inputs(n, d, k)
    off_k, p_k = schedule_batch(*(jnp.asarray(x) for x in args), bn=bn, interpret=True)
    targs = [torch.from_numpy(x) for x in args]
    off, p = t_ops.schedule_batch(*targs, bn=bn)
    want = t_ops.geo_schedule(*targs)
    assert torch.equal(off, want[0]) and torch.equal(p, want[1])
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_k))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_k), rtol=0, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = [torch.from_numpy(x) for x in _inputs(8, 4, 5)]
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(TypeError, match="tau must be torch.int32"):
        t_ops.geo_schedule(*bad)
    bad = list(args)
    bad[6] = args[6][:4]
    with pytest.raises(ValueError, match="valid must be"):
        t_ops.geo_schedule(*bad)
    bad = list(args)
    bad[3] = torch.zeros((5, 8), dtype=torch.int32).t()
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.geo_schedule(*bad)


def test_stagger_and_abort_probability_match():
    tau, lel, inv, c, t, a, valid = _inputs(500, 4, 5, seed=11)
    T = lambda x: torch.from_numpy(x)
    for lv, scale in ((None, 1000), (lel, 1000), (lel, 700)):
        ref = r_sched.stagger_offsets(jnp.asarray(tau), jnp.asarray(inv),
                                      None if lv is None else jnp.asarray(lv), scale)
        got = t_sched.stagger_offsets(T(tau), T(inv), None if lv is None else T(lv), scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = r_sched.abort_probability(*(jnp.asarray(x) for x in (c, t, a, valid)))
    got = t_sched.abort_probability(T(c), T(t), T(a), T(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    off = t_sched.stagger_offsets(T(tau), T(inv))
    np.testing.assert_array_equal(
        t_sched.lock_contention_span(T(tau), T(inv), off).numpy(),
        np.asarray(r_sched.lock_contention_span(jnp.asarray(tau), jnp.asarray(inv),
                                                jnp.asarray(off.numpy()))),
    )


def test_admission_and_commit_decisions_match():
    rng = np.random.default_rng(5)
    n = 4000
    p = rng.random(n).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    u[:10] = p[:10]  # ties: u < p is False
    blocked = rng.integers(0, 8, n).astype(np.int32)
    rb, ra = r_sched.admission_decision(jnp.asarray(p), jnp.asarray(u), jnp.asarray(blocked), 5)
    tb, ta = t_sched.admission_decision(torch.from_numpy(p), torch.from_numpy(u),
                                        torch.from_numpy(blocked), 5)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    prep = rng.integers(0, 3, n).astype(np.int32)
    flags = [rng.random(n) < 0.5 for _ in range(3)]
    r = r_sched.commit_decision(jnp.asarray(prep), *(jnp.asarray(f) for f in flags), 2, 0, 1)
    t = t_sched.commit_decision(torch.from_numpy(prep), *(torch.from_numpy(f) for f in flags),
                                2, 0, 1)
    for x, y in zip(t, r):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_eq4_masked_w_bitwise():
    """XLA fuses `w_old * a + ...` into an FMA; the port emulates it exactly."""
    rng = np.random.default_rng(0)
    B, K, C = 20_000, 5, 64
    w_lat = rng.integers(0, 3_000_000, (B, C + 1)).astype(np.int32)
    slot = rng.integers(0, C + 1, (B, K)).astype(np.int32)
    found = rng.random((B, K)) < 0.7
    lel = rng.integers(0, 5_000_000, (B, 1)).astype(np.float32)
    for alpha in (800, 500, 999):
        ref = jax.jit(jax.vmap(lambda w, s, f, l: r_hs.eq4_masked_w(w, s, f, l, alpha)))(
            w_lat, slot, found, lel)
        got = t_hs.eq4_masked_w(torch.from_numpy(w_lat), torch.from_numpy(slot).long(),
                                torch.from_numpy(found), torch.from_numpy(lel), alpha)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@jax.jit
@jax.vmap
def _ref_claim(slot_key, keys, valid):
    """The reference step's claim: find_or_claim + the slot_key scatter-set
    (`omni.py:239,249-251`)."""
    slot, evict = r_hs.find_or_claim_slots(slot_key, keys, valid)
    sk = slot_key.at[slot].set(jnp.where(valid, keys, slot_key[slot]))
    return slot, evict, sk


def _port_claim(slot_key, keys, valid):
    sk, ks, vd = (torch.from_numpy(x) for x in (slot_key, keys, valid))
    slot, evict = t_hs.find_or_claim_slots(sk, ks, vd)
    vals = t_hs.last_writer_values(slot, torch.where(vd, ks, sk.gather(1, slot)))
    return slot, evict, sk.scatter(1, slot, vals)


def _assert_claim_equal(slot_key, keys, valid):
    r = _ref_claim(slot_key, keys, valid)
    t = _port_claim(slot_key, keys, valid)
    for name, x, y in zip(("slot", "evict", "slot_key"), t, r):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)


def test_find_or_claim_random_tables():
    rng = np.random.default_rng(9)
    B, K, C = 3000, 5, 16
    slot_key = np.where(rng.random((B, C + 1)) < 0.5, rng.integers(0, 40, (B, C + 1)), -1)
    slot_key[:, C] = -1
    keys = rng.integers(0, 40, (B, K)).astype(np.int32)
    valid = rng.random((B, K)) < 0.8
    _assert_claim_equal(slot_key.astype(np.int32), keys, valid)
    # lookup_slots too
    r = jax.jit(jax.vmap(r_hs.lookup_slots))(slot_key.astype(np.int32), keys, valid)
    t = t_hs.lookup_slots(torch.from_numpy(slot_key.astype(np.int32)),
                          torch.from_numpy(keys), torch.from_numpy(valid))
    for x, y in zip(t, r):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_two_keys_race_for_one_empty_slot():
    """The documented race (`hotspot.py:166-168`): two distinct keys of one
    transaction claim the same empty slot (and, on a full table, the same
    eviction victim). The reference's scatter keeps the last key."""
    C = 8
    pr = t_hs.probe_slots_batch(torch.arange(200, dtype=torch.int32), C).numpy()
    first = pr[:, 0]
    a = 0
    b = int(np.nonzero(first == first[a])[0][1])
    c = int(np.nonzero(first == first[a])[0][2])
    empty = np.full((1, C + 1), -1, np.int32)
    for order in ((a, b), (b, a), (a, b, c), (c, a, b)):
        keys = np.array([list(order) + [150, 151, 152][: 5 - len(order)]], np.int32)
        valid = np.ones_like(keys, bool)
        _assert_claim_equal(empty, keys, valid)
        _, _, sk = _port_claim(empty, keys, valid)
        assert sk[0, first[a]] == order[-1]  # last wins
    full = np.arange(1000, 1000 + C + 1, dtype=np.int32)[None]
    full[0, C] = -1
    keys = np.array([[a, b, c, 150, 151]], np.int32)
    _assert_claim_equal(full, keys, np.ones_like(keys, bool))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    for n, d, k, _ in GEO_CASES:
        args = [torch.from_numpy(x) for x in _inputs(n, d, k)]
        off_r, p_r = geo_schedule_ref(*args)
        off, p = t_ops.geo_schedule(*(x.cuda() for x in args))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(off.cpu().numpy(), off_r.numpy())
        np.testing.assert_allclose(p.cpu().numpy(), p_r.numpy(), rtol=0, atol=1e-6)
