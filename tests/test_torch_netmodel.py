"""Integer hashing, delays, salts, EWMA, probes and histogram bins of the
port are array-equal to the reference's (bitwise; no tolerance)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotspot as r_hs
from repro.core import netmodel as r_net
from repro.core.engine import state as r_state
from repro_torch.core import hotspot as t_hs
from repro_torch.core import netmodel as t_net
from repro_torch.core.engine import state as t_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _salts(n=200_000, seed=0):
    """Dense int32 sweep: a contiguous block around 0, the int32 extremes and
    uniform draws over the whole range (negative salts included)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.arange(-5000, 5000, dtype=np.int64),
        np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX], dtype=np.int64),
        rng.integers(I32_MIN, I32_MAX, n, endpoint=True),
    ]).astype(np.int32)


def test_hash_u32_matches():
    x = _salts()
    ref = np.asarray(jax.jit(r_net._hash_u32)(x)).astype(np.int64)
    got = t_net._hash_u32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("jitter", [0, 30, 100, 1000])
def test_delay_salted_matches(jitter):
    x = _salts(50_000, seed=jitter)
    rng = np.random.default_rng(jitter + 1)
    rtt = rng.integers(0, 600_000, x.shape[0]).astype(np.int32)
    ref = np.asarray(
        jax.jit(r_state._delay_salted)(jnp.int32(jitter), rtt, x)
    )
    got = t_state._delay_salted(
        torch.tensor(jitter, dtype=torch.int32), torch.from_numpy(rtt), torch.from_numpy(x)
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_one_way_delay_matches():
    x = _salts(20_000, seed=5)
    net_r = r_net.make_net_params(jitter_frac=0.1)
    net_t = t_net.make_net_params(jitter_frac=0.1)
    rtt = np.full(x.shape, 73_000, np.int32)
    ref = np.asarray(r_net.one_way_delay(net_r, jnp.asarray(rtt), jnp.asarray(x)))
    got = t_net.one_way_delay(net_t, torch.from_numpy(rtt), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(net_t.tau_ds.numpy(), np.asarray(net_r.tau_ds))


def test_u01_matches():
    x = _salts()
    ref = np.asarray(jax.jit(r_state._u01)(x))
    got = t_state._u01(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("a", [0, 11, 29, 53])
def test_salt_matches_with_int32_wrap(a):
    # iters up to 4e6 (max_events) and beyond: iters * 506952113 wraps int32
    iters = np.concatenate([np.arange(0, 5000), np.arange(4_000_000 - 5000, 4_000_000),
                            np.array([2**31 - 1, 123_456_789])]).astype(np.int32)
    ref = np.asarray(r_state._salt(types.SimpleNamespace(iters=jnp.asarray(iters)), a))
    got = t_state._salt(types.SimpleNamespace(iters=torch.from_numpy(iters)), a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref < 0).any()  # the sweep does reach the wrap


def test_ewma_update_matches():
    rng = np.random.default_rng(3)
    est = rng.integers(0, 2_000_000, 500_000).astype(np.int32)
    sm = rng.integers(0, 2_000_000, 500_000).astype(np.int32)
    for beta in (875, 500, 999):
        ref = np.asarray(jax.jit(lambda e, s: r_net.ewma_update(e, s, jnp.int32(beta)))(est, sm))
        got = t_net.ewma_update(torch.from_numpy(est), torch.from_numpy(sm), beta).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("capacity", [1024, 64, 7])
def test_probe_slots_batch_matches(capacity):
    keys = _salts(50_000, seed=capacity)
    ref = np.asarray(jax.jit(lambda k: r_hs.probe_slots_batch(k, capacity))(keys))
    got = t_hs.probe_slots_batch(torch.from_numpy(keys), capacity).numpy()
    np.testing.assert_array_equal(got, ref)


def test_hist_bin_matches_everywhere():
    """Every latency from -1000 µs to 7 s (bins saturate at ~6.01 s), plus
    the octave edges 100 * 2**m ± 1 where one ulp of log moves the bin."""
    lat = np.arange(-1000, 7_000_000, dtype=np.int32)
    ref = np.asarray(jax.jit(r_state._hist_bin)(lat))
    got = t_state._hist_bin(torch.from_numpy(lat)).numpy()
    np.testing.assert_array_equal(got, ref)
    edges = np.array([100 * 2**m + d for m in range(0, 25) for d in (-1, 0, 1)], np.int64)
    edges = np.clip(edges, 0, 2**31 - 1).astype(np.int32)
    np.testing.assert_array_equal(
        t_state._hist_bin(torch.from_numpy(edges)).numpy(),
        np.asarray(jax.jit(r_state._hist_bin)(edges)),
    )
