"""The paper's figures and claims through the port (`repro_torch.bench.
figures`, `claims`, `run`) against the reference's `benchmarks/`, on the
CPU, without running either engine at figure size.

* Every figure of `ALL_FIGURES`, quick and full: a recorder stands in for
  `run_sweep` (and for `Simulator` in fig11's online chain) on both sides,
  in this test's process (the reference's files are untouched). Each side
  hands the recorder its sweeps: tags, cells, terminals, horizons, warmups
  and every bank leaf must be equal, banks shared between the same cells.
  The recorder answers both sides with the same made-up results (metrics
  and the final-state leaves `latency_cdf` and `drain_stats` read), so the
  two row codes must give equal payloads and print equal lines.
* `claims.validate` against `benchmarks.run.validate` check by check on
  crafted payloads where every check passes, where every check fails, and
  with figures missing; the helpers on the reference's own claim cases
  (`tests/core/test_claims.py`).
* ``python -m repro_torch.bench.run``: raises without a card, prints the
  summary with ``--validate-only --device cpu``, raises naming A7 for
  ``--strategy mesh``; ``--only`` picks as the reference does.
* Every public name of `repro.core.engine` is in `repro_torch.core.engine`.
* `chip_smoke.FIGURES_REF` is the reference's numbers for phase 5h's
  sweeps at its cut (slow-marked: the reference runs 19 grids at T = 48).

Run as a script, the file prints `FIGURES_REF` from the JAX reference on
the CPU (a few minutes; nothing is written):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_figures.py
"""

import contextlib
import copy
import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import types
import zlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import claims as r_claims  # noqa: E402
from benchmarks import common as r_common  # noqa: E402
from benchmarks import figures as r_figures  # noqa: E402
from benchmarks import run as r_run  # noqa: E402
from repro.core import engine as r_engine  # noqa: E402
from repro_torch.bench import claims, figures  # noqa: E402
from repro_torch.bench import run as t_run  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine.state import HIST_BINS, N_ABORT_CAUSES, N_STOP_REASONS  # noqa: E402

FIGS = [fn.__name__ for fn in r_figures.ALL_FIGURES]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the recorder: made-up results, the same on both sides
# ---------------------------------------------------------------------------


class FakeState(NamedTuple):
    """The final-state leaves of one lane that the row codes read."""

    now: np.ndarray
    iters: np.ndarray
    drained: np.ndarray
    windows: np.ndarray
    win_stops: np.ndarray
    ab_cause: np.ndarray
    down_us: np.ndarray
    ds_down: np.ndarray
    down_since: np.ndarray
    mw_heal: np.ndarray
    commits_fault: np.ndarray
    stale_reads: np.ndarray
    failovers: np.ndarray
    max_stale_us: np.ndarray
    wan_legs: np.ndarray
    fast_commits: np.ndarray
    chained: np.ndarray
    fused: np.ndarray
    hist_all: np.ndarray
    hist_cen: np.ndarray


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32("/".join(map(str, key)).encode()))


def fake_metrics(tag, i) -> dict:
    rng = _rng(tag, i, "m")
    commits, aborts = int(rng.integers(1, 900)), int(rng.integers(0, 90))
    m = {"throughput_tps": float(rng.uniform(1, 400)), "commits": commits, "aborts": aborts,
         "abort_rate": aborts / (commits + aborts)}
    for k in ("avg_latency_ms", "avg_latency_dist_ms", "p50_ms", "p99_ms", "p999_ms",
              "p50_centralized_ms", "p99_centralized_ms", "p50_distributed_ms",
              "p99_distributed_ms", "avg_lcs_ms"):
        m[k] = float(rng.uniform(1, 2000))
    m.update(noops=0, events=int(rng.integers(1000, 90_000)), sim_end_s=float(rng.uniform(1, 20)))
    return m


def fake_state(tag, i, D, horizon_us) -> FakeState:
    rng = _rng(tag, i, "s")
    ri = lambda hi, shape=(): rng.integers(0, hi, shape).astype(np.int32)  # noqa: E731
    return FakeState(
        now=np.int32(horizon_us - int(rng.integers(0, 1000))), iters=ri(90_000),
        drained=ri(50_000), windows=ri(9_000), win_stops=ri(900, (N_STOP_REASONS,)),
        ab_cause=ri(90, (N_ABORT_CAUSES,)), down_us=ri(3_000_000, (D,)),
        ds_down=rng.random(D) < 0.3, down_since=ri(horizon_us, (D,)),
        mw_heal=ri(2 * horizon_us, (D,)), commits_fault=ri(500), stale_reads=ri(50),
        failovers=ri(9), max_stale_us=ri(900_000), wan_legs=ri(20_000),
        fast_commits=ri(900), chained=ri(900), fused=ri(900),
        hist_all=ri(60, (HIST_BINS,)), hist_cen=ri(60, (HIST_BINS,)))


@dataclasses.dataclass
class FakeResult:
    metrics: list
    states: list
    cfg: types.SimpleNamespace
    steps: int = 0
    wall_s: float = 1.0

    @property
    def events(self) -> int:
        return sum(m["events"] for m in self.metrics)

    def world(self, i):
        return self.states[i]


def fake_result(tag, cells, horizon_s, warmup_s) -> FakeResult:
    D = len(cells[0].get("rtt_ms", r_common.DEFAULT_RTT))
    h = int(round(horizon_s * 1e6))
    return FakeResult(
        metrics=[fake_metrics(tag, i) for i in range(len(cells))],
        states=[fake_state(tag, i, D, h) for i in range(len(cells))],
        cfg=types.SimpleNamespace(horizon_us=h, warmup_us=int(round(warmup_s * 1e6))),
        steps=len(cells) * 7)


class OnlineState(NamedTuple):
    tau_true: object
    commits: int
    now: int


class Recorder:
    """Stands in for `run_sweep`, `save` and fig11's `Simulator` on one side."""

    def __init__(self):
        self.sweeps, self.saved, self.online = [], {}, []

    def run_sweep(self, tag, cells, bank, terminals, *, banks=None, horizon_s=10.0,
                  warmup_s=2.0, **kw):
        self.sweeps.append(dict(tag=tag, cells=copy.deepcopy(cells), bank=bank, banks=banks,
                                terminals=terminals, horizon_s=horizon_s, warmup_s=warmup_s))
        res = fake_result(tag, cells, horizon_s, warmup_s)
        for c, m in zip(cells, res.metrics):
            m["preset"] = c["preset"]
            m["wall_s"] = 0.25
            m["sweep_wall_s"] = 1.0
        return res

    def save(self, name, payload, *args):
        self.saved[name] = json.loads(json.dumps(payload, default=float))

    def simulator(self, device):
        """A `Simulator` class for fig11's online chain: records the run and
        each resume, and answers with made-up states."""
        rec = self

        class Sim:
            def __init__(self, bank, terminals, horizon_s, warmup_s):
                self.device = device
                rec.online.append(("sim", bank, terminals, horizon_s, warmup_s))

            @classmethod
            def from_bank(cls, bank, terminals=None, *, horizon_s=10.0, warmup_s=2.0, **kw):
                return cls(bank, terminals, horizon_s, warmup_s)

            def run(self, world, bank):
                rec.online.append(("run", bank, *(_np(getattr(world, f)).ravel().tolist()
                                                  for f in ("tau_true", "tau_ds",
                                                            "jitter_milli"))))
                rec.online.append(("dyn", [_np(x).tolist() for x in world.dyn]))
                return online_result(len(rec.online), world.tau_true, 8.0, 0)

            def resume(self, res, *, horizon_s, warmup_s):
                rec.online.append(("resume", _np(res.states.tau_true).ravel().tolist(),
                                   horizon_s, warmup_s))
                return online_result(len(rec.online), res.states.tau_true, horizon_s,
                                     int(res.states.commits))

        return Sim


@dataclasses.dataclass
class OnlineResult:
    metrics: list
    states: OnlineState
    cfg: types.SimpleNamespace
    steps: int
    wall_s: float = 1.0

    def with_states(self, states):
        return dataclasses.replace(self, states=states)


def online_result(k, tau, horizon_s, commits) -> OnlineResult:
    m = fake_metrics("online", k)
    return OnlineResult(
        metrics=[m], states=OnlineState(tau, commits + m["commits"], int(horizon_s * 1e6) - 17 * k),
        cfg=types.SimpleNamespace(horizon_us=int(horizon_s * 1e6), warmup_us=0), steps=k)


@contextlib.contextmanager
def recording(side):
    """Patch `side`'s ("ref" or "port") figure module; yields the recorder."""
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        if side == "ref":
            mp.setattr(r_figures, "run_sweep", rec.run_sweep)
            mp.setattr(r_figures, "save", rec.save)
            mp.setattr(r_engine, "Simulator", rec.simulator(None))
        else:
            mp.setattr(figures, "run_sweep", rec.run_sweep)
            mp.setattr(figures, "save", rec.save)
            mp.setattr(figures, "Simulator", rec.simulator(torch.device("cpu")))
        yield rec


def run_recorded(name, quick):
    """Both sides' figure `name` against recorders: {side: (recorder,
    returned payload, printed text)}."""
    out = {}
    for side in ("ref", "port"):
        buf = io.StringIO()
        with recording(side) as rec, contextlib.redirect_stdout(buf):
            if side == "ref":
                payload = getattr(r_figures, name)(quick=quick)
            else:
                payload = getattr(figures, name)(quick, opts=figures.Options(device="cpu"))
        out[side] = (rec, json.loads(json.dumps(payload, default=float)), buf.getvalue())
    return out


def banks_equal(rb, tb, what):
    assert tb.num_records == rb.num_records and tb.num_ds == rb.num_ds, what
    for f in ("key", "write", "ds", "round_id", "valid", "is_dist"):
        r, t = _np(getattr(rb, f)), _np(getattr(tb, f))
        assert t.dtype == r.dtype and t.shape == r.shape, (what, f, t.dtype, r.dtype)
        assert np.array_equal(t, r), (what, f)


def sharing(banks) -> list:
    """Each bank's first index in the list: which cells share one."""
    return [next(j for j, c in enumerate(banks) if c is b) for b in banks]


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", FIGS)
def test_figure_sweeps_rows_and_lines_equal_the_reference(name, quick):
    runs = run_recorded(name, quick)
    (r, r_payload, r_text), (t, t_payload, t_text) = runs["ref"], runs["port"]
    assert [s["tag"] for s in t.sweeps] == [s["tag"] for s in r.sweeps] and r.sweeps
    for rs, ts in zip(r.sweeps, t.sweeps):
        for k in ("cells", "terminals", "horizon_s", "warmup_s"):
            assert ts[k] == rs[k], (rs["tag"], k)
        assert (ts["bank"] is None) == (rs["bank"] is None), rs["tag"]
        if rs["bank"] is not None:
            banks_equal(rs["bank"], ts["bank"], rs["tag"])
        assert (ts["banks"] is None) == (rs["banks"] is None), rs["tag"]
        if rs["banks"] is not None:
            assert sharing(ts["banks"]) == sharing(rs["banks"]), rs["tag"]
            for j in sorted(set(sharing(rs["banks"]))):
                banks_equal(rs["banks"][j], ts["banks"][j], (rs["tag"], j))
    # fig11's online chain: the same worlds, the same resumes
    assert len(t.online) == len(r.online)
    for ro, to in zip(r.online, t.online):
        if ro[0] in ("sim", "run"):
            banks_equal(ro[1], to[1], ro[0])
            assert to[2:] == ro[2:], ro
        else:
            assert to == ro
    assert list(t.saved) == list(r.saved) == [name]
    assert t.saved == r.saved
    assert t_payload == r_payload
    assert t_text == r_text


def test_figure_names_and_quick_width():
    assert [fn.__name__ for fn in figures.ALL_FIGURES] == FIGS
    assert figures.QUICK_T == r_figures.QUICK_T
    assert list(figures.SWEEPS) == FIGS
    assert figures.DEFAULT_RTT == r_common.DEFAULT_RTT


def test_sweep_cut_keeps_a_zero_warmup():
    s = figures.fig18_sweeps()[0].cut(1.5, 0.5)
    assert (s.horizon_s, s.warmup_s) == (1.5, 0.0)
    s = figures.fig15_sweeps()[0].cut(1.5, 0.5)
    assert (s.horizon_s, s.warmup_s) == (1.5, 0.5)


@pytest.mark.parametrize("kw", [dict(strategy="mesh"), dict(mesh_devices=2)])
def test_run_sweep_mesh_raises_a7(kw):
    from repro_torch.bench import common

    bank = common.ycsb_bank(2, records=64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A item A7"):
        common.run_sweep("x", [dict(preset="ssp")], bank, 2, device="cpu", record=False, **kw)


def test_summary_line_and_ycsb_bank_equal_the_reference():
    from repro_torch.bench import common

    m = fake_metrics("line", 0)
    assert common.summary_line("fig5 ycsb T=16 geotp", m) == r_common.summary_line(
        "fig5 ycsb T=16 geotp", m)
    kw = dict(theta=1.2, dist_ratio=0.6, ops=6, rounds=3, records=5000, num_ds=3, seed=4,
              quro=True)
    banks_equal(r_common.ycsb_bank(3, **kw), common.ycsb_bank(3, **kw), kw)


def test_save_writes_the_port_results_dir(tmp_path, monkeypatch):
    from repro_torch.bench import common

    monkeypatch.chdir(tmp_path)
    path = common.save("fig0", [{"a": np.float32(1.5), "rtt": (1, 2)}])
    assert path == pathlib.Path("results/bench_torch/fig0.json")
    assert json.loads(path.read_text()) == [{"a": 1.5, "rtt": [1, 2]}]
    assert not (tmp_path / "results" / "bench").exists()


# ---------------------------------------------------------------------------
# the claims
# ---------------------------------------------------------------------------


def _row(preset, tps, **kw):
    return dict(preset=preset, throughput_tps=tps, **kw)


def claim_payloads(good: bool) -> dict:
    """One payload a validated figure, crafted so that every check passes
    (`good`) or every check fails."""
    g = good
    fig5 = [dict(bench="ycsb", terminals=T, **_row(p, v))
            for T in (16, 32) for p, v in (("ssp", 100), ("geotp", 150 if g else 90),
                                           ("scalardb", 50 if g else 120))]
    fig7 = [dict(level="medium", dist_ratio=0.6, **_row(p, v))
            for p, v in (("ssp", 100), ("chiller", 120), ("quro", 110),
                         ("geotp", 130 if g else 60))]
    fig12 = [dict(theta=th, **_row(p, v)) for th in (0.5, 0.9) for p, v in (
        ("ssp", 50), ("geotp-o1", 80 if g else 30), ("geotp-o1o2", 90), ("geotp", 120 if g else 40))]
    fig13 = [dict(level=lv, **_row(p, v)) for lv, rows in (
        ("high", (("ssp", 40), ("geotp", 90 if g else 30), ("yugabyte-like", 50))),
        ("low", (("ssp", 100), ("geotp", 120), ("yugabyte-like", 130 if g else 80))))
        for p, v in rows]
    fig14 = [dict(sweep="rounds", rounds=n, theta=0.3, **_row(p, v)) for n in (1, 3)
             for p, v in (("ssp", 100), ("geotp", 150 if g else 80))]
    causes = lambda c: {"none": 0, "timeout": 1, "admission": 0, "crash": c, "exhausted": 0}  # noqa: E731
    fig16 = [dict(schedule=s, availability=a, abort_causes=causes(c), commits=n, **_row(p, v))
             for s, a, c, n in (("crashes", 0.95 if g else 1.0, 9 if g else 0, 100 if g else 0),
                                ("fault-free", 1.0, 0 if g else 3, 120))
             for p, v in (("ssp", 80), ("geotp", 90 if g else 70))]
    fig17 = [dict(schedule=s, availability=a, failovers=f, stale_reads=f, avg_latency_ms=lat,
                  **_row(p, v))
             for s, a, f, lat in (("partitions", 0.96 if g else 1.0, 3 if g else 0, 200),
                                  ("degrades", 1.0 if g else 0.9, 0, 300 if g else 100),
                                  ("fault-free", 1.0, 0, 200))
             for p, v in (("ssp", 80), ("geotp", 90 if g else 70))]
    fig18 = []
    for lv in ("uniform", "hotspot"):
        for sc in (0.5, 1.0):
            for p, wan in (("ssp", 3.0), ("geotp", 2.0 if g else 3.5), ("fastc", 1.2 if g else 3.1),
                           ("opta", 2.5)):
                fig18.append(dict(level=lv, rtt_scale=sc, clock_skew_us=0, wan_per_txn=wan,
                                  fast_commits=5 if g or p != "fastc" else 0, fast_rate=0.0,
                                  abort_rate=0.2 if (p == "opta") == g else 0.1,
                                  avg_latency_ms=100 if (p == "opta") == g else 150,
                                  **_row(p, 100)))
            for skew, fr in zip((0, 100_000, 200_000), (0.9, 0.5, 0.1) if g else (0.5, 0.6, 0.7)):
                fig18.append(dict(level=lv, rtt_scale=sc, clock_skew_us=skew, wan_per_txn=2.0,
                                  fast_commits=3, fast_rate=fr, abort_rate=0.0,
                                  avg_latency_ms=90, **_row("tiga", 100)))
    t1 = [dict(scenario=s, dist_ratio=dr, **_row(p, v))
          for s in ("S1-mysql", "S2-postgres") for dr in (0.25, 0.75)
          for p, v in (("ssp", 100), ("geotp", 120 if g else 80))]
    return {"fig5_overall": fig5, "fig7_dist_ratio": fig7, "fig12_ablation": fig12,
            "fig13_yugabyte": fig13, "fig14_txn_length": fig14, "fig16_faults": fig16,
            "fig17_partitions": fig17, "fig18_protocols": fig18, "table1_heterogeneous": t1}


def write_payloads(d: pathlib.Path, payloads: dict) -> pathlib.Path:
    d.mkdir(parents=True, exist_ok=True)
    for name, rows in payloads.items():
        (d / f"{name}.json").write_text(json.dumps(rows))
    return d


def _jsonable(checks):
    return json.loads(json.dumps(checks, default=str))


@pytest.mark.parametrize("case", ["pass", "fail", "missing", "empty"])
def test_validate_equals_the_reference_check_by_check(case, tmp_path):
    payloads = claim_payloads(case != "fail")
    if case == "missing":
        payloads = {k: v for i, (k, v) in enumerate(payloads.items()) if i % 2}
    if case == "empty":
        payloads = {}
    d = write_payloads(tmp_path / "bench", payloads)
    got, want = claims.validate(d), r_run.validate(d)
    assert _jsonable(got) == _jsonable(want)
    assert [c[0] for c in got] == [c[0] for c in want]
    if case == "pass":
        assert len(got) == 23 and all(ok for _, ok, _ in got), [c for c in got if not c[1]]
    if case == "fail":
        assert len(got) == 23 and not any(ok for _, ok, _ in got), [c for c in got if c[1]]
    if case == "empty":
        assert got == []


def test_claimset_defaults_to_the_port_results():
    assert claims.ClaimSet().dir == pathlib.Path("results/bench_torch")
    assert claims.RESULTS_DIR == "results/bench_torch"


# the reference's own claim-helper cases (tests/core/test_claims.py), on the port
_ROWS = [
    {"schedule": "crashes", "preset": "ssp", "availability": 0.95},
    {"schedule": "crashes", "preset": "geotp", "availability": 0.96},
    {"schedule": "fault-free", "preset": "ssp", "availability": 1.0},
]
CLAIM_CASES = {
    "rows_by-filters-and-keys": lambda c: (
        sorted(c.rows_by(_ROWS, schedule="crashes")) == ["geotp", "ssp"]
        and c.rows_by(_ROWS, schedule="crashes")["geotp"]["availability"] == 0.96
        and c.rows_by(_ROWS, schedule="nope") == {}),
    "rows_by-later-rows-win": lambda c: c.rows_by(
        [{"preset": "a", "v": 1}, {"preset": "a", "v": 2}])["a"]["v"] == 2,
    "values_over-orders-by-axis": lambda c: c.values_over(
        [{"k": 3, "v": "c", "p": "x"}, {"k": 1, "v": "a", "p": "x"},
         {"k": 2, "v": "b", "p": "y"}], "k", "v", p="x") == ["a", "c"],
    "ratio-guards-zero": lambda c: c.ratio(1.0, 0.0) > 1e8 and c.ratio(6.0, 3.0) == 2.0,
    "non_increasing": lambda c: (c.non_increasing([3, 2, 2, 1])
                                 and not c.non_increasing([1, 2])
                                 and c.non_increasing([1.0, 1.01], tol=0.02)
                                 and c.non_increasing([]) and c.non_increasing([5])),
    "claimset-add-and-count": lambda c: _claimset_counts(c),
    "claimset-missing-figure": lambda c: c.ClaimSet("/nonexistent/dir").load("fig1") is None,
    "claimset-loads-json": None,  # needs a directory: see the test
}


def _claimset_counts(c):
    cs = c.ClaimSet("/nonexistent")
    cs.add("a", 1, "x")
    cs.add("b", 0, {"k": 1})
    cs.add("c", [True], [1])
    return cs.checks == [("a", True, "x"), ("b", False, {"k": 1}), ("c", True, [1])] \
        and cs.n_ok == 2


@pytest.mark.parametrize("case", list(CLAIM_CASES))
def test_claim_helpers_match_the_reference(case, tmp_path):
    if case == "claimset-loads-json":
        (tmp_path / "fig9.json").write_text(json.dumps([{"preset": "ssp"}]))
        for mod in (claims, r_claims):
            assert mod.ClaimSet(tmp_path).load("fig9") == [{"preset": "ssp"}]
        return
    assert CLAIM_CASES[case](r_claims) and CLAIM_CASES[case](claims)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _cli(args, cwd, env_extra=None):
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "repro_torch.bench.run", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_cli_without_a_card_raises(tmp_path):
    out = _cli(["--only", "fig15"], tmp_path)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert not (tmp_path / "results").exists()


def test_cli_validate_only_on_the_cpu_prints_the_summary(tmp_path):
    write_payloads(tmp_path / "results" / "bench_torch", claim_payloads(True))
    out = _cli(["--validate-only", "--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "PAPER-CLAIM VALIDATION" in out.stdout and lines[-1] == "23/23 claims validated"
    want = [f"[PASS] {name} :: {detail}" for name, _, detail in
            r_run.validate(tmp_path / "results" / "bench_torch")]
    assert lines[-24:-1] == want


def test_cli_strategy_mesh_raises_a7(tmp_path):
    out = _cli(["--smoke", "--strategy", "mesh", "--device", "cpu"], tmp_path)
    assert out.returncode != 0 and "ROADMAP.md §A item A7" in out.stderr


@pytest.mark.parametrize("only", [None, "fig1", "fig11", "fig17_partitions", "table1", "fig"])
def test_only_picks_as_the_reference(only):
    want = [fn.__name__ for fn in r_figures.ALL_FIGURES
            if not only or fn.__name__ == only or fn.__name__.startswith(only + "_")]
    assert [fn.__name__ for fn in t_run.selected(only)] == want


def test_failed_figure_prints_failed_and_goes_on(monkeypatch, capsys):
    def boom(quick=True, *, opts=None):
        raise RuntimeError("boom")

    boom.__name__ = "fig0_boom"
    recs = t_run.run_figures([boom], True, device="cpu")
    out = capsys.readouterr().out
    assert "[FAILED] fig0_boom: boom" in out and recs[0]["failed"] == "RuntimeError('boom')"


# ---------------------------------------------------------------------------
# the engine's public names
# ---------------------------------------------------------------------------

REF_PUBLIC = sorted(n for n in dir(r_engine) if not n.startswith("_")
                    and not isinstance(getattr(r_engine, n), types.ModuleType))


@pytest.mark.parametrize("name", REF_PUBLIC)
def test_engine_exports_every_reference_name(name):
    assert hasattr(engine, name), name
    assert name in engine.__all__
    ref = getattr(r_engine, name)
    if isinstance(ref, (int, str, tuple)) and not isinstance(ref, bool):
        assert getattr(engine, name) == ref, name


def test_mesh_device_count_answers_as_the_reference():
    for s in ("map", "vmap", "auto"):
        assert engine.mesh_device_count(s) == r_engine.mesh_device_count(s) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A item A7"):
        engine.mesh_device_count("mesh")


# ---------------------------------------------------------------------------
# chip_smoke's FIGURES_REF: phase 5h's sweeps at its cut, from the reference
# ---------------------------------------------------------------------------


def hist_digest(hist) -> int:
    return zlib.crc32(np.ascontiguousarray(_np(hist), dtype=np.int32).tobytes())


def ref_figures_table(names, horizon_s, warmup_s) -> dict:
    """{tag: [(preset, events, commits, aborts, hist_all digest) a lane]} of
    the reference's figures `names` (quick), every sweep cut to `horizon_s`
    (warmup min(own, `warmup_s`)) and run through `benchmarks.common.
    run_sweep` (its CPU strategy, nothing recorded or saved)."""
    out = {}

    def sweep(tag, cells, bank, terminals, *, banks=None, horizon_s=10.0, warmup_s=2.0):
        res = r_common.run_sweep(tag, cells, bank, terminals, banks=banks, horizon_s=cut_h,
                                 warmup_s=min(warmup_s, cut_w), record=False)
        out[tag] = [(c["preset"], m["events"], m["commits"], m["aborts"],
                     hist_digest(res.world(i).hist_all))
                    for i, (c, m) in enumerate(zip(cells, res.metrics))]
        return res

    cut_h, cut_w = horizon_s, warmup_s
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(r_figures, "run_sweep", sweep)
        mp.setattr(r_figures, "save", lambda *a, **k: None)
        for name in names:
            getattr(r_figures, name)(quick=True)
    return out


def test_chip_smoke_figures_are_the_reference_sweeps():
    import chip_smoke

    names = [n for n in FIGS if n not in ("fig11_dynamic", "fig16_faults", "fig17_partitions")]
    assert list(chip_smoke.FIGURES_5H) == names
    tags = [s.tag for n in names for s in figures.SWEEPS[n][0](True)]
    assert len(tags) == 19 and list(chip_smoke.FIGURES_REF) == tags
    for n in names:
        for s in figures.SWEEPS[n][0](True):
            assert [r[0] for r in chip_smoke.FIGURES_REF[s.tag]] == [c["preset"] for c in s.cells]


def test_figures_phase_runs_on_the_cpu(tmp_path, capsys):
    """Phase 5h's code at T = 4 and 0.3 s on fig15, its table from the
    reference at that size: every lane equal, the rows written, the claims
    printed; a table one lane off raises."""
    import chip_smoke

    names = ("fig15_multiregion",)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(figures, "QUICK_T", 4)
        mp.setattr(r_figures, "QUICK_T", 4)
        mp.setattr(chip_smoke, "FIGURES_5H", names)
        mp.setattr(chip_smoke, "FIGURES_CUT", (0.3, 0.1))
        ref = {k: [tuple(r) for r in v] for k, v in ref_figures_table(names, 0.3, 0.1).items()}
        mp.setattr(chip_smoke, "FIGURES_REF", ref)
        assert chip_smoke.figures_phase(device="cpu", rows_path=tmp_path / "rows.txt") == 0
        out = capsys.readouterr().out
        assert "fig15: 4 lanes, T=4, K=5" in out and "every lane the reference" in out
        assert "phase 5h: 1 grids, 4 lanes equal to the reference" in out
        assert len((tmp_path / "rows.txt").read_text().splitlines()) == 4
        p, e, c, a, h = ref["fig15"][1]
        mp.setattr(chip_smoke, "FIGURES_REF", {"fig15": [ref["fig15"][0], (p, e, c, a, h + 1),
                                                         *ref["fig15"][2:]]})
        with pytest.raises(AssertionError, match="lanes differ from FIGURES_REF"):
            chip_smoke.figures_phase(device="cpu", rows_path=tmp_path / "rows.txt")


@pytest.mark.slow
def test_chip_smoke_figures_ref_is_the_reference():
    import chip_smoke

    h, w = chip_smoke.FIGURES_CUT
    got = ref_figures_table(chip_smoke.FIGURES_5H, h, w)
    assert {k: [tuple(r) for r in v] for k, v in got.items()} == chip_smoke.FIGURES_REF


if __name__ == "__main__":
    import chip_smoke

    h, w = chip_smoke.FIGURES_CUT
    print("FIGURES_REF = {")
    for tag, rows in ref_figures_table(chip_smoke.FIGURES_5H, h, w).items():
        print(f"    {tag!r}: [")
        for row in rows:
            print(f"        {row!r},")
        print("    ],")
    print("}")
