"""The figures' bank families through the port's engine against the
reference's, on the CPU: TPC-C mixed (fig5), Payment-only and
NewOrder-only (fig9), interactive rounds 1-3 at 6 ops (fig14), 25-op
transactions (fig14), QURO-reordered YCSB beside the other fig7 presets
(fig7) and two data sources of 500,000 records (fig1).

Each case runs one sweep of a figure for real on both sides, the figure's
own cells and banks at T = 4 (`QUICK_T` patched on both sides; fig5's
TPC-C sweep keeps its T = 16) and a horizon cut to 0.25-0.6 s: the port's
vmap lanes (`repro_torch.bench.common.run_sweep`, device "cpu") against the
reference's `benchmarks.common.run_sweep` on its vmap lanes (the same
`_omni_window`; its map lanes compile no faster on the CPU). Every final
`SimState` leaf is bitwise equal, the drain's `fused` counter included.
The figure's other sweeps get the recorder's made-up results
(`test_torch_figures.Recorder`), and the wall-clock keys of the real
sweep's metrics are set alike on both sides, so the two figure functions'
payloads and printed lines must be equal too: their row code on real
final states.

One reference compile a case (~10-15 s on one CPU core).
"""

import contextlib
import io
import json

import numpy as np
import pytest

from benchmarks import common as r_common
from benchmarks import figures as r_figures
from repro_torch.bench import common as t_common
from repro_torch.bench import figures
from test_torch_drain import _differing_leaves
from test_torch_figures import Recorder

T = 4
WARMUP_S = 0.1

# family: (figure, the sweep run for real, its horizon in s: 3-round
# transactions to the 251 ms data source need ~0.6 s to commit)
CASES = {
    "tpcc-mixed": ("fig5_overall", "fig5_tpcc_T16", 0.25),
    "tpcc-payment-neworder": ("fig9_tpcc", "fig9", 0.3),
    "rounds-1-3": ("fig14_txn_length", "fig14_rounds", 0.6),
    "ops25": ("fig14_txn_length", "fig14_ops25", 0.3),
    "quro": ("fig7_dist_ratio", "fig7", 0.3),
    "two-ds-500k": ("fig1_motivation", "fig1", 0.25),
}


def _run_figure(side, name, tag, horizon_s):
    """`side`'s figure `name`, its sweep `tag` run for real: (RunResult,
    payload, printed text)."""
    rec, real, cut = Recorder(), {}, horizon_s

    def sweep(t, cells, bank, terminals, *, banks=None, horizon_s=10.0, warmup_s=2.0, **kw):
        if t != tag:
            return rec.run_sweep(t, cells, bank, terminals, banks=banks, horizon_s=horizon_s,
                                 warmup_s=warmup_s)
        w = min(warmup_s, WARMUP_S)
        if side == "ref":
            res = r_common.run_sweep(t, cells, bank, terminals, banks=banks,
                                     horizon_s=cut, warmup_s=w, strategy="vmap",
                                     record=False)
        else:
            res = t_common.run_sweep(t, cells, bank, terminals, banks=banks,
                                     horizon_s=cut, warmup_s=w, record=False,
                                     device="cpu")
        for m in res.metrics:
            m["wall_s"], m["sweep_wall_s"] = 0.25, 1.0
        real["res"] = res
        return res

    mod = r_figures if side == "ref" else figures
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(mod, "QUICK_T", T)
        mp.setattr(mod, "run_sweep", sweep)
        mp.setattr(mod, "save", rec.save)
        fn = getattr(mod, name)
        payload = fn(quick=True) if side == "ref" else fn(True, opts=figures.Options(
            device="cpu", record=False))
    return real["res"], json.loads(json.dumps(payload, default=float)), buf.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_family_matches_the_reference(case):
    name, tag, horizon_s = CASES[case]
    rres, r_payload, r_text = _run_figure("ref", name, tag, horizon_s)
    tres, t_payload, t_text = _run_figure("port", name, tag, horizon_s)
    assert tres.strategy_resolved == rres.strategy_resolved == "vmap"
    assert _differing_leaves(tres.states, rres.states) == {}
    assert all(m["noops"] == 0 for m in tres.metrics) and tres.events > 0
    assert sum(m["commits"] for m in tres.metrics) > 0
    assert t_payload == r_payload
    assert t_text == r_text
    bank = tres.bank
    if case == "rounds-1-3":
        # 3-round transactions commit in every lane that has them, so
        # rounds advanced; some terminal ends past its first round
        assert int(bank.round_id.max()) == 2
        assert all(m["commits"] > 0 for c, m in zip(tres.cells, tres.metrics)
                   if c["rounds"] == 3)
        assert int(tres.states.cur_round.max()) >= 1
    if case.startswith("tpcc"):
        assert bank.key.shape[-1] == 21 and bank.num_records > 8_000_000
    if case == "ops25":
        assert bank.key.shape[-1] == 25
    if case == "two-ds-500k":
        assert bank.num_ds == 2 and bank.num_records == 1_000_000
    if case == "quro":
        presets = [c["preset"] for c in tres.cells]
        assert presets.count("quro") == 12 and len(presets) == 60
    assert np.isfinite([m["throughput_tps"] for m in tres.metrics]).all()
