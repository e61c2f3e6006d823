"""The port's small leaves against the reference, on the CPU: the legacy
`core.protocol` shim, the ten `configs/<name>.py` modules, the dense
record-indexed hotspot table (`dense_*`) and the scalar hash-table
operations `hash_lookup` / `hash_touch`.

The reference's scalar probe sequence (`repro.core.hotspot._probe_slots`)
overflows its int32 add under the installed jax (ROADMAP §C, C9), so
`hash_lookup` / `hash_touch` are held against the reference with that one
helper replaced by its batched form (`probe_slots_batch`: the same step,
key + 0x9E3779B9 mod 2**32); the overflow itself is asserted.
"""

import dataclasses
import importlib
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotspot as r_hot
from repro.core import protocol as r_protocol
from repro_torch.core import hotspot
from repro_torch.core import protocol
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted(p.stem for p in (ROOT / "src" / "repro" / "configs").glob("*.py")
                      if p.stem not in ("registry", "__init__"))


def test_protocol_shim_exports_the_reference_names():
    names = [n for n in dir(r_protocol) if not n.startswith("_") and n != "annotations"
             and not isinstance(getattr(r_protocol, n), types.ModuleType)]
    assert len(names) >= 20
    for n in names:
        assert hasattr(protocol, n), n
    assert sorted(protocol.PRESETS) == sorted(r_protocol.PRESETS)
    for name, ref in r_protocol.PRESETS.items():
        assert dataclasses.asdict(protocol.PRESETS[name]) == dataclasses.asdict(ref), name
    for n in ("STAGGER_NONE", "STAGGER_NET", "STAGGER_NET_LEL", "PREPARE_NONE",
              "PREPARE_COORD", "PREPARE_DECENTRAL"):
        assert getattr(protocol, n) == getattr(r_protocol, n), n


@pytest.mark.parametrize("stem", CONFIG_FILES)
def test_config_module_is_the_reference_config(stem):
    ref = importlib.import_module(f"repro.configs.{stem}").CONFIG
    got = importlib.import_module(f"repro_torch.configs.{stem}").CONFIG
    assert got.name == ref.name
    from repro_torch.configs import registry

    assert got is registry.get(ref.name)
    r, t = dataclasses.asdict(ref), dataclasses.asdict(got)
    for k, v in r.items():  # the port's registry adds fields of its own
        assert t[k] == v, (stem, k)


def test_ten_config_modules():
    assert len(CONFIG_FILES) == 10
    have = sorted(p.stem for p in (ROOT / "src" / "repro_torch" / "configs").glob("*.py")
                  if p.stem not in ("registry", "__init__"))
    assert have == CONFIG_FILES


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables_equal(got, ref):
    assert type(got)._fields == type(ref)._fields
    for f, g, r in zip(type(ref)._fields, got, ref):
        g, r = _np(g), _np(r)
        assert g.dtype == r.dtype and g.shape == r.shape, f
        assert np.array_equal(g, r), f


def _dense_inputs(seed, R=40, K=9):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, R + 5, K).astype(np.int32)  # some past R: dropped / clamped
    keys[:3] = keys[3]  # duplicates
    keys[4] = 0  # record 0, also where invalid entries land
    valid = rng.random(K) < 0.7
    valid[4] = True
    return keys, valid


@pytest.mark.parametrize("seed", range(4))
def test_dense_table_matches_the_reference(seed):
    R = 40
    rhs, ths = r_hot.dense_init(R), hotspot.dense_init(R)
    _tables_equal(ths, rhs)
    rng = np.random.default_rng(100 + seed)
    for step in range(6):
        keys, valid = _dense_inputs(seed * 10 + step, R)
        rk, rv, tk, tv = jnp.asarray(keys), jnp.asarray(valid), torch.from_numpy(keys), \
            torch.from_numpy(valid)
        rhs, ths = r_hot.dense_on_dispatch(rhs, rk, rv), hotspot.dense_on_dispatch(ths, tk, tv)
        _tables_equal(ths, rhs)
        committed = bool(rng.random() < 0.6)
        lel = int(rng.integers(0, 300_000))
        alpha = int(rng.choice([0, 250, 500, 900, 1000]))
        rhs = r_hot.dense_on_complete(rhs, rk, rv, jnp.asarray(committed),
                                      jnp.asarray(lel, jnp.int32), jnp.asarray(alpha, jnp.int32))
        ths = hotspot.dense_on_complete(ths, tk, tv, torch.tensor(committed),
                                        torch.tensor(lel, dtype=torch.int32),
                                        torch.tensor(alpha, dtype=torch.int32))
        _tables_equal(ths, rhs)
        kk = rng.integers(0, R, (3, 5)).astype(np.int32)
        vv = rng.random((3, 5)) < 0.8
        got = hotspot.dense_forecast_lel(ths, torch.from_numpy(kk), torch.from_numpy(vv))
        want = r_hot.dense_forecast_lel(rhs, jnp.asarray(kk), jnp.asarray(vv))
        assert _np(got).dtype == np.int32 and np.array_equal(_np(got), _np(want))
        for g, w in zip(hotspot.dense_gather_stats(ths, torch.from_numpy(kk), torch.from_numpy(vv)),
                        r_hot.dense_gather_stats(rhs, jnp.asarray(kk), jnp.asarray(vv))):
            assert np.array_equal(_np(g), _np(w))
    assert int(ths.t_cnt.sum()) > 0 and int(ths.w_lat.max()) > 0


def test_reference_scalar_probe_overflows():
    """C9: the reference's scalar probe sequence adds 0x9E3779B9 to an int32
    key, which the installed jax refuses."""
    with pytest.raises(OverflowError):
        r_hot.hash_lookup(r_hot.hash_init(16), jnp.int32(5))


def _batched_probe(key, capacity, probes):
    return r_hot.probe_slots_batch(jnp.asarray(key, jnp.int32)[None], capacity, probes)[0]


@pytest.mark.parametrize("capacity,probes", [(16, 4), (8, 8), (32, 8)])
def test_hash_touch_and_lookup_match_the_reference(capacity, probes, monkeypatch):
    monkeypatch.setattr(r_hot, "_probe_slots", _batched_probe)
    rng = np.random.default_rng(capacity + probes)
    rhs, ths = r_hot.hash_init(capacity), hotspot.hash_init(capacity)
    _tables_equal(ths, rhs)
    # a stat per slot, so a reset on eviction shows
    rhs = rhs._replace(w_lat=jnp.arange(capacity, dtype=jnp.int32) + 7)
    ths = ths._replace(w_lat=torch.arange(capacity, dtype=torch.int32) + 7)
    evicted = 0
    for key in rng.integers(0, 4 * capacity, 3 * capacity).astype(np.int32):
        for probe in (int(key), int(rng.integers(0, 4 * capacity))):
            rs, rf = r_hot.hash_lookup(rhs, jnp.int32(probe), probes)
            ts, tf = hotspot.hash_lookup(ths, torch.tensor(probe, dtype=torch.int32), probes)
            assert (int(ts), bool(tf)) == (int(rs), bool(rf)), probe
        before = _np(ths.slot_key).copy()
        rhs, rslot = r_hot.hash_touch(rhs, jnp.int32(key), probes)
        ths, tslot = hotspot.hash_touch(ths, torch.tensor(int(key), dtype=torch.int32), probes)
        assert int(tslot) == int(rslot) and tslot.dtype == torch.int32
        _tables_equal(ths, rhs)
        evicted += before[int(tslot)] not in (-1, key)
    assert evicted > 0  # the clock eviction ran
