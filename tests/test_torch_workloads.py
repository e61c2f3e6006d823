"""The port's banks and presets equal the reference's (bitwise; no tolerance)."""

import dataclasses

import numpy as np
import pytest

from repro.core import protocols as r_proto
from repro.core import workloads as r_wl
from repro_torch.core import protocols as t_proto
from repro_torch.core import workloads as t_wl
from repro_torch.core.workloads import BANK_ARRAYS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_bank_equal(tb, rb):
    for f in BANK_ARRAYS:
        got, ref = getattr(tb, f).numpy(), np.asarray(getattr(rb, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    assert (tb.num_records, tb.num_ds) == (rb.num_records, rb.num_ds)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(num_ds=2, records_per_node=2000, ops_per_txn=4, dist_ratio=0.5, seed=3),
        dict(theta=1.6, records_per_node=500, rounds=2, seed=7),
        dict(num_ds=1, ops_per_txn=3, read_frac=0.9),
    ],
)
def test_ycsb_bank_matches(kw):
    kw = dict(dict(records_per_node=10_000), **kw)
    tb = t_wl.make_ycsb_bank(t_wl.YCSBConfig(**kw), terminals=6, txns_per_terminal=9)
    rb = r_wl.make_ycsb_bank(r_wl.YCSBConfig(**kw), terminals=6, txns_per_terminal=9)
    _assert_bank_equal(tb, rb)
    _assert_bank_equal(t_wl.quro_reorder(tb), r_wl.quro_reorder(rb))


@pytest.mark.parametrize("only_type", [-1, 0, 4])
def test_tpcc_bank_matches(only_type):
    kw = dict(num_ds=4, warehouses_per_node=2, dist_ratio=0.3, only_type=only_type, seed=2)
    tb, tt = t_wl.make_tpcc_bank(t_wl.TPCCConfig(**kw), 5, 11)
    rb, rt = r_wl.make_tpcc_bank(r_wl.TPCCConfig(**kw), 5, 11)
    _assert_bank_equal(tb, rb)
    np.testing.assert_array_equal(tt, rt)


def test_presets_equal_field_by_field():
    assert sorted(t_proto.PRESETS) == sorted(r_proto.PRESETS)
    assert len(t_proto.PRESETS) == 12
    for name, rp in r_proto.PRESETS.items():
        assert dataclasses.asdict(t_proto.PRESETS[name]) == dataclasses.asdict(rp), name
    for c in ("PREPARE_COORD", "PREPARE_DECENTRAL", "PREPARE_NONE",
              "STAGGER_NONE", "STAGGER_NET", "STAGGER_NET_LEL"):
        assert getattr(t_proto, c) == getattr(r_proto, c)
    with pytest.raises(TypeError):
        t_proto.PRESETS["x"] = t_proto.SSP  # frozen view
    with pytest.raises(ValueError, match="already registered"):
        t_proto.register_preset(t_proto.SSP)
