"""Profile a window of lockstep steps of the port's main path on one card.

    python3 profile_step.py

Runs `chip_smoke.py`'s phase-5 grid (fig5 YCSB, T = 128, ssp / ssp-local /
scalardb / geotp x seeds 0-3, 16 lanes) through `Simulator.run_grid` for
WINDOW events per lane, three times: a warm-up, an unprofiled run (host
wall per step) and a run under `torch.profiler`; the script profiles the
windowed drain (`drain=True`, the default step `fused._omni_window`), then
the single-event step (`drain=False`, `omni._omni_step`). Either step is
branchless (every step issues the same ops whatever events it processes),
so the opening window costs per step what any window does; a drained
window of WINDOW events per lane takes fewer steps.

On the card (mode "captured") the run warms the step up, captures it into
a CUDA graph and replays it (`engine.batch.CapturedStep`); the window is
the replays, from the first replay to the end of the run. Per replay it
prints the host wall, the host time to issue a replay, the device kernels,
the device busy time (union of kernel intervals) and the idle share, and
the kernel table by name (launches a replay, device us a launch):
the trace must hold exactly two `geo_schedule_kernel`s a step, the eager
warm-up steps' and the replays' (a trace that lost kernel records is
profiled again, up to PROFILE_ATTEMPTS runs, each short trace printed
with where its geo_schedule kernels lie). On the CPU (mode
"eager", where the tests run it) each step's ops run one by one, and it
prints per step the host wall and aten ops issued, then for each labelled
part of the step (the uint32 hash / salt / delay helpers, the hot-table
probe, the lane freeze, the two `geo_schedule` calls, the window plan and
its apply pass) its host time and its share of the profiled loop. The last
line is a JSON list of the two summaries, each naming its mode and step.
The full op tables go to `build/profile_step.txt`.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

import torch
from torch.autograd.profiler_util import Interval

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (module, function, label); labels with `outer` open a range only when no
# other `outer` range is open, so their host times are disjoint and add up
LABELS = (
    ("repro_torch.core.netmodel", "_hash_u32", "hash: _hash_u32", True),
    ("repro_torch.core.netmodel", "_mul_u32", "hash: _mul_u32", True),
    ("repro_torch.core.engine.state", "_salt", "hash: _salt", True),
    ("repro_torch.core.engine.state", "_u01", "hash: _u01", True),
    ("repro_torch.core.engine.state", "_delay_salted", "hash: _delay_salted", True),
    ("repro_torch.core.hotspot", "probe_slots_batch", "hash: probe_slots_batch", True),
    ("repro_torch.core.engine.batch", "_freeze", "lane freeze", False),
    ("repro_torch.core.engine.batch", "_active", "done check", False),
    ("repro_torch.core.scheduler", "plan_dispatch", "geo_schedule call", False),
    ("repro_torch.core.engine.fused", "_window_plan", "window plan", False),
    ("repro_torch.core.engine.fused", "_apply_window", "window apply", False),
    ("repro_torch.core.engine.batch", "_omni_step", "step", False),
    ("repro_torch.core.engine.batch", "_omni_window", "step", False),
)
RUN_LABEL = "lockstep run"
REPLAY_LABEL = "replay of the captured step"
GEO_KERNEL = "geo_schedule_kernel"
# events per lane: 32 steps (31 replays on the card). At 128 (127 replays,
# ~375,000 kernels of the windowed step) one chip run's trace lost 3 of its
# 254 geo_schedule kernels, and the accounting below refuses a trace that
# lost any; a shorter window cuts what the profiler records and what is
# read back, and chip_smoke.py profiles three such windows
WINDOW = 32
# the profiler leaves out device records stamped outside its own span (its
# log counts them as "Out-of-range"), so on a card the span reaches this far
# past the run on either side
TRACE_PAD_S = 0.25
# a captured run's trace that holds fewer geo_schedule kernels than the run
# launched (2 a step: its eager warm-up steps' and its replays') lost records
# between the card and the trace (one run of chip_smoke.py on an H100 kept
# 106 of the 126 in phase 5b's replays, while the wrapper's launch count held
# 2 a step): the run is profiled again, at most this many times in all, and
# the last attempt's trace is refused if it is short too
PROFILE_ATTEMPTS = 3
KERNEL_ROWS = 25  # kernel table rows printed


def install_labels(undo: list) -> None:
    """Wrap each LABELS function in a `record_function` range, in every
    `repro_torch` module that holds a reference to it; `undo` collects
    what to restore."""
    depth = [0]

    def wrap(fn, label, outer):
        def labelled(*a, **k):
            if outer and depth[0]:
                return fn(*a, **k)
            depth[0] += outer
            try:
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            finally:
                depth[0] -= outer

        return labelled

    for mod_name, fn_name, label, outer in LABELS:
        fn = getattr(sys.modules[mod_name], fn_name)
        new = wrap(fn, label, outer)
        for name, mod in list(sys.modules.items()):
            if name.startswith("repro_torch") and getattr(mod, fn_name, None) is fn:
                undo.append((mod, fn_name, fn))
                setattr(mod, fn_name, new)


def install_run_timer(device, undo: list) -> dict:
    """Time `batch.run` (the lockstep loop alone, synchronised) as called by
    `placement.simulate_batch`, inside a RUN_LABEL range."""
    from repro_torch.core.engine import placement

    run, timing = placement.run, {}

    def timed_run(*a, **k):
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(RUN_LABEL):
            out = run(*a, **k)
        sync()
        timing["wall_s"], timing["steps"] = time.perf_counter() - t0, out[1]
        return out

    undo.append((placement, "run", run))
    placement.run = timed_run
    return timing


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return busy


def install_replay_label(undo: list) -> dict:
    """Wrap `CapturedStep.replay` in a REPLAY_LABEL range; the returned
    dict counts the replays it issued."""
    from repro_torch.core.engine import batch

    replay, count = batch.CapturedStep.replay, {"replays": 0}

    def labelled(self, n):
        count["replays"] += n
        with torch.profiler.record_function(REPLAY_LABEL):
            return replay(self, n)

    undo.append((batch.CapturedStep, "replay", replay))
    batch.CapturedStep.replay = labelled
    return count


def kernel_name(name: str) -> str:
    """A device event's kernel name without its parameter list (and without
    the anonymous namespace), or a mangled name's identifier."""
    if m := re.match(r"_Z(?:N\d+_GLOBAL__N_\w+?)?(\d+)", name):
        return name[m.end():m.end() + int(m.group(1))]
    return name.replace("(anonymous namespace)::", "").split("(")[0]


def kernel_table(kernels, steps: int) -> dict:
    """{kernel name: launches a step, device us a launch, device us a step},
    by total device time."""
    by = {}
    for e in kernels:
        name = kernel_name(e.name)
        n, us = by.get(name, (0, 0.0))
        by[name] = (n + 1, us + (e.time_range.end - e.time_range.start))
    return {name: {"per_step": n / steps, "us_per_launch": us / n, "us_per_step": us / steps}
            for name, (n, us) in sorted(by.items(), key=lambda kv: -kv[1][1])}


class _Record:
    """One trace record, with the fields of a `FunctionEvent` that `_window`
    and `measure` read."""

    __slots__ = ("name", "device_type", "time_range", "cpu_parent", "cpu_children")

    def __init__(self, name, device_type, start_us, end_us):
        self.name, self.device_type, self.cpu_parent = name, device_type, None
        self.time_range, self.cpu_children = Interval(start_us, end_us), []


class RawTrace:
    """`prof`'s records read straight from the profiler's result, as
    `prof.events()` gives them (the same records, times in us from the
    trace's start, each host op's parent the innermost host range around it
    on its thread), without its parse of every record (demangled names,
    stacks, shapes, the kernels attached to their launches), a few times
    slower for the same records."""

    def __init__(self, prof):
        self.prof = prof

    def events(self) -> list:
        res = self.prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        cpu_t = torch.autograd.DeviceType.CPU
        hidden = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                  "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                  "aten::is_leaf", "aten::output_nr", "aten::_version"}
        out, threads = [], {}
        for e in res.events():
            name = e.name()
            if name in hidden or getattr(e, "is_hidden_event", bool)():
                continue
            rec = _Record(name, e.device_type(), (e.start_ns() - t0) / 1000,
                          (e.end_ns() - t0) / 1000)
            out.append(rec)
            if (rec.device_type == cpu_t and not e.is_async()
                    and e.start_thread_id() == e.end_thread_id()):
                threads.setdefault(e.start_thread_id(), []).append(rec)
        for recs in threads.values():  # as `EventList._populate_cpu_children`
            stack = []
            for rec in sorted(recs, key=lambda r: (r.time_range.start, -r.time_range.end)):
                while stack:
                    parent = stack[-1].time_range
                    if rec.time_range.start >= parent.end or rec.time_range.end > parent.end:
                        stack.pop()
                    else:
                        rec.cpu_parent = stack[-1]
                        stack[-1].cpu_children.append(rec)
                        break
                stack.append(rec)
        while True:  # as `EventList._remove_dup_nodes`: an op's lone namesake child goes
            keep = []
            for rec in out:
                parent = rec.cpu_parent
                if parent is not None and parent.name == rec.name and len(parent.cpu_children) == 1:
                    parent.cpu_children = rec.cpu_children
                    for child in rec.cpu_children:
                        child.cpu_parent = parent
                else:
                    keep.append(rec)
            if len(keep) == len(out):
                return out
            out = keep


def _window(prof, steps: int, replays) -> dict:
    """The profiled run in `prof`'s trace: the host RUN_LABEL range, on a
    card (`replays`: the replays the run issued) from its first replay on.
    Returns the window's bounds (us), its steps `n` (the replays on a
    card), the replay ranges, the events that start in the window and the
    device kernels among them, and every device kernel of the trace."""
    from repro_torch.core.engine import batch

    events = prof.events()
    cpu_t = torch.autograd.DeviceType.CPU
    # the host range; on a card the profiler also mirrors it on the device
    run_ev = [e for e in events if e.name == RUN_LABEL and e.device_type == cpu_t]
    if len(run_ev) != 1:
        raise AssertionError(f"expected one host '{RUN_LABEL}' range, got {len(run_ev)}")
    t_lo, t_hi = run_ev[0].time_range.start, run_ev[0].time_range.end
    n = steps
    rep_ev = [e for e in events if e.name == REPLAY_LABEL and e.device_type == cpu_t]
    if replays is not None:  # the window: from the first replay to the end of the run
        n = replays
        if not rep_ev or n != steps - batch._WARMUP_STEPS:
            raise AssertionError(f"{n} replays in {len(rep_ev)} ranges for {steps} steps")
        t_lo = min(e.time_range.start for e in rep_ev)
    in_win = [e for e in events if t_lo <= e.time_range.start <= t_hi]
    # device activity, less the device-side mirrors of the labelled ranges
    names = {RUN_LABEL, REPLAY_LABEL} | {label for _, _, label, _ in LABELS}
    kernels = [e for e in in_win if e.device_type != cpu_t and e.name not in names]
    traced = [e for e in events if e.device_type != cpu_t and e.name not in names]
    return {"t_lo": t_lo, "t_hi": t_hi, "n": n, "rep_ev": rep_ev, "in_win": in_win,
            "kernels": kernels, "traced": traced}


def _short_trace(win: dict, geo: int) -> dict:
    """Where a short trace's geo_schedule kernels are: in the window, in the
    whole trace (the eager warm-up steps' launches included), before and
    after the window; and the window's device kernels a replay."""
    traced = [e.time_range.start for e in win["traced"] if kernel_name(e.name) == GEO_KERNEL]
    return {"replays": win["n"], "geo_in_window": geo, "geo_in_trace": len(traced),
            "geo_before_window": sum(t < win["t_lo"] for t in traced),
            "geo_after_window": sum(t > win["t_hi"] for t in traced),
            "kernels_per_replay": len(win["kernels"]) / win["n"]}


def measure(grid, window: int, device, activities, tables=None, drain: bool = True,
            bank=None, terminals=None) -> dict:
    """Warm-up, unprofiled and profiled runs of `grid` for `window` events
    per lane, with the windowed step (`drain`) or the single-event one;
    returns the per-step summary (device fields are None when the profiler
    recorded no device activity). On a card the step is replayed from a
    CUDA graph and the summary covers the replays. `bank` is a bank the
    cells share (default: the grid's own per-cell banks); a grid with a
    fault schedule profiles the step with its fault and heartbeat tails."""
    from repro_torch.core.engine import Simulator, batch

    captured = device.type == "cuda"
    undo = []
    try:
        install_labels(undo)
        replays = install_replay_label(undo)
        timing = install_run_timer(device, undo)
        sim = Simulator.from_bank(grid.banks[0] if bank is None else bank, terminals=terminals,
                                  horizon_s=2.5, warmup_s=0.5, drain=drain, device=device)
        sim.cfg = dataclasses.replace(sim.cfg, max_events=window)
        sim.run_grid(grid, bank, strategy="vmap")
        sim.run_grid(grid, bank, strategy="vmap")
        wall_s, steps, capture_s = timing["wall_s"], timing["steps"], batch.run.capture_s
        short = []
        for _ in range(PROFILE_ATTEMPTS):
            replays["replays"] = 0
            with torch.profiler.profile(activities=activities) as prof:
                if captured:
                    time.sleep(TRACE_PAD_S)
                sim.run_grid(grid, bank, strategy="vmap")
                if captured:
                    time.sleep(TRACE_PAD_S)
            prof_wall_s = timing["wall_s"]
            if timing["steps"] != steps:
                raise AssertionError(f"profiled run took {timing['steps']} steps, "
                                     f"unprofiled {steps}")
            win = _window(RawTrace(prof), steps, replays["replays"] if captured else None)
            traced_geo = sum(kernel_name(e.name) == GEO_KERNEL for e in win["traced"])
            if not captured or traced_geo == 2 * steps:
                break
            geo = sum(kernel_name(e.name) == GEO_KERNEL for e in win["kernels"])
            short.append(_short_trace(win, geo))
            print(f"profile attempt {len(short)}: the trace is short: {short[-1]}")
    finally:
        for mod, name, fn in reversed(undo):
            setattr(mod, name, fn)

    n, win_us, rep_ev, in_win, kernels = (
        win["n"], win["t_hi"] - win["t_lo"], win["rep_ev"], win["in_win"], win["kernels"])
    cpu_t = torch.autograd.DeviceType.CPU
    aten = [
        e for e in in_win
        if e.device_type == cpu_t and e.name.startswith("aten::")
        and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))
    ]
    out = {
        "mode": "captured" if captured else "eager",
        "drain": drain,
        "max_faults": int(grid.max_faults),
        "device": str(device),
        "window_events_per_lane": window,
        "steps": steps,
        "replays": n if captured else None,
        "lanes": len(grid),
        "capture_s": capture_s,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "profiled_wall_ms_per_step": prof_wall_s * 1e3 / steps,
        "aten_ops_per_step": len(aten) / n,
        "device_kernels_per_step": None,
        "device_busy_ms_per_step": None,
        "idle_share_profiled": None,
        "idle_share_unprofiled": None,
        "kernels": kernel_table(kernels, n),
        "labels": {},
        "short_traces": short,
    }
    if captured:
        out["wall_ms_per_replay"] = (wall_s - capture_s) * 1e3 / n
        out["profiled_wall_ms_per_replay"] = win_us / 1e3 / n
        out["host_issue_us_per_replay"] = sum(
            e.time_range.end - e.time_range.start for e in rep_ev) / n
        out["geo_in_trace"] = traced_geo
        if traced_geo != 2 * steps:
            raise AssertionError(f"{GEO_KERNEL}: {traced_geo} launches in the trace of {steps} "
                                 f"steps ({n} replays), want 2 a step")
    if kernels:
        busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
        unprof_us = (wall_s - capture_s if captured else wall_s) * 1e6 * n / steps
        out["device_kernels_per_step"] = len(kernels) / n
        out["device_busy_ms_per_step"] = busy_us / 1e3 / n
        out["idle_share_profiled"] = 1.0 - busy_us / win_us
        out["idle_share_unprofiled"] = 1.0 - busy_us / unprof_us
    if not captured:  # the labelled parts run only while a step is issued op by op
        for label in dict.fromkeys(label for _, _, label, _ in LABELS):
            evs = [e for e in in_win if e.name == label and e.device_type == cpu_t]
            host_us = sum(e.time_range.end - e.time_range.start for e in evs)
            out["labels"][label] = {
                "calls_per_step": len(evs) / steps,
                "host_ms_per_step": host_us / 1e3 / steps,
                "share_of_loop": host_us / win_us,
            }
    if tables is not None:
        avg = prof.key_averages()
        tables.write(avg.table(sort_by="self_cpu_time_total", row_limit=60) + "\n")
        if kernels:
            dev_key = "self_device_time_total" if hasattr(avg[0], "self_device_time_total") \
                else "self_cuda_time_total"
            tables.write(avg.table(sort_by=dev_key, row_limit=40) + "\n")
    return out


def report(res: dict) -> None:
    """Print the summary of `measure`, one line for each part."""
    if res["device_busy_ms_per_step"] is None:
        print("the profiler recorded no device activity: device busy time and idle share "
              "not measured")
    step = "windowed step (drain=True)" if res["drain"] else "single-event step (drain=False)"
    if res.get("max_faults"):
        step += f" with {res['max_faults']} fault rows a lane"
    print(f"mode {res['mode']}, {step}: {res['steps']} steps x {res['lanes']} lanes, wall "
          f"{res['wall_ms_per_step']:.4f} ms/step unprofiled (warm-up and capture "
          f"{res['capture_s']:.4f} s included), {res['profiled_wall_ms_per_step']:.4f} profiled")
    if res["mode"] == "captured":
        print(f"{res['replays']} replays: wall {res['wall_ms_per_replay']:.4f} ms/replay "
              f"unprofiled, {res['profiled_wall_ms_per_replay']:.4f} profiled; host issue "
              f"{res['host_issue_us_per_replay']:.2f} us/replay")
    print(f"per {'replay' if res['mode'] == 'captured' else 'step'}: "
          f"{res['aten_ops_per_step']:.2f} aten ops, "
          f"{res['device_kernels_per_step']} device kernels, "
          f"device busy {res['device_busy_ms_per_step']} ms, "
          f"idle share {res['idle_share_profiled']} (profiled wall) / "
          f"{res['idle_share_unprofiled']} (unprofiled wall)")
    for name, v in list(res["kernels"].items())[:KERNEL_ROWS]:
        print(f"kernel {name[:60]:60s} {v['per_step']:6.2f}/step {v['us_per_launch']:9.3f} "
              f"us/launch {v['us_per_step']:10.3f} us/step")
    if GEO_KERNEL in res["kernels"]:
        g = res["kernels"][GEO_KERNEL]
        print(f"{GEO_KERNEL}: {g['per_step']:.2f} launches a step, {g['us_per_launch']:.4f} us "
              f"device time a launch")
    if res["mode"] == "captured":
        print(f"{GEO_KERNEL}: {res['geo_in_trace']} launches in the whole trace for "
              f"{res['steps']} steps; {len(res['short_traces'])} short traces profiled again")
    for label, v in res["labels"].items():
        print(f"{label:26s} {v['calls_per_step']:7.2f} calls/step  "
              f"{v['host_ms_per_step']:9.4f} host ms/step  {100 * v['share_of_loop']:6.2f}% of loop")


def main() -> int:
    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False — needs a CUDA card")
    from chip_smoke import main_grid

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    runs = []
    with open(out_dir / "profile_step.txt", "w") as tables:
        for drain in (True, False):
            res = measure(main_grid(), WINDOW, torch.device("cuda"), acts, tables, drain=drain)
            res["card"] = smi
            report(res)
            runs.append(res)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
