"""Chip smoke test: the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero):

1. environment — torch / CUDA versions and the card's name and power limit;
2. build — the `geo_schedule` CUDA kernel from `src/repro_torch/csrc`, with
   ptxas's registers, stack frame and spills for each kernel variant (as
   for phase 6's);
3. kernel vs plain version on the card — the reference kernel's GEO_CASES
   shapes plus N = 16 at D = 4, K = 5, then the two launches of one
   lockstep step built as the step builds them (Eq.9 at [16,1] + [16,5]
   with zero tau/lel and an all-False inv; Eq.8 at [16,4] + [16,1] with an
   all-False valid), with all-masked rows: offsets equal, p_abort within
   1e-6; CUDA-event times of the wrapper called in a loop (the host's
   issue rate of one eager call: checks, allocation, the ctypes launch)
   and of the plain version at those two launch shapes;
4. end to end, GPU vs CPU — all 12 presets (YCSB, T = 16, D = 4, paper
   RTTs, jitter 30, 1 s horizon) through `Simulator(drain=False).run_grid`
   (the single-event step `_omni_step`) on both devices (the CPU's eager
   run in a process of its own, started in phase 2 beside the builds, as
   4b's and 4c's), the card's run as a captured step replayed from a CUDA
   graph; every final `SimState` leaf and the step count must be equal;
4b. the same with the windowed drain (`drain=True`, the default: the step
   is `fused._omni_window`): GPU == CPU on every leaf, the drain telemetry
   included, and the card's final states equal to phase 4's on every leaf
   but the five telemetry leaves;
5. the main path at full width — fig5's YCSB deployment (4 data sources at
   0/27/73/251 ms, 1M records per node, zipf 0.9, 20% distributed, 5 ops,
   256 txns per terminal, T = 128 terminals) for ssp / ssp-local /
   scalardb / geotp x seeds 0-3 with per-seed banks (B = 16 lanes); the
   horizon is cut from fig5's 10 s / 2 s warmup to 2.5 s / 0.5 s. The
   lockstep step is captured once into a CUDA graph and replayed; the
   capture time is printed and is part of the wall time. Checks noops == 0
   and commits > 0 on every lane, the events the eager step gave
   (MAIN_EVENTS), and that the kernel launched exactly twice per lockstep
   step (the launches of one replay, counted at the capture, times the
   replays); then (after phase 5d, once the LM kernels' builds have ended,
   so the profiles run on a quiet host) `profile_step.measure` over a
   window of replays: two `geo_schedule_kernel` launches a replay in the
   trace, their device time, the device busy time and idle share. Phase 5
   runs the single-event step (`drain=False`);
5b. the same grid drained (`drain=True`, the default path): the same
   MAIN_EVENTS, final states equal to phase 5's on every leaf but the drain
   telemetry, two `geo_schedule` launches a lockstep step; steps, events/s
   beside phase 5's, the drain hit rate, mean window, loop iterations,
   window stops and the capture time; the plan's candidates by one sort
   (`window._candidates`) against the reference's 16 masked argmins on the
   final event times, equal and both timed; then (after 5d) the windowed
   replay's profile (kernels a replay, device busy ms, idle share; the kernel record's `ms`
   is its `geo_schedule` device time a launch, its `launches` every
   engine phase's: 4c-5d, 5e-5g and 5h).

Slice 10, fault injection (typed crash / partition / degrade schedules,
heartbeats, replica failover) in the captured lockstep steps:

4c. GPU vs CPU with faults — the 12 presets under the reference tests'
   CRASH_HEAVY, then under PART_HEAVY with replicas at 60 ms and a 250 ms
   lag (24 lanes; YCSB T = 8, D = 2, RTT 10 / 100 ms, horizon 2 s), the
   single-event and the windowed step: every final leaf and the step
   count equal, two `geo_schedule` launches a step on the card, the
   drained states equal to the single-event ones but the drain
   telemetry, and the schedules biting (crash aborts, failovers, stale
   reads, windows stopped at a fault row);
5c. fig16 at paper size (`repro_torch.bench.figures.fig16_sweeps(quick=False)`,
   the reference's `benchmarks/figures.py` under `--full`): T = 48,
   the fig5 bank (4 data sources at 0/27/73/251 ms, 1M records per node,
   zipf 0.9, 20% distributed), horizon 20 s, warmup 1 s, ssp and geotp x
   two crash / recovery cycles and the fault-free control (4 lanes)
   through `Simulator.run_grid`, the captured windowed step: every lane's
   events, commits, aborts, availability, abort causes, commits during a
   fault, link downtime, failovers, stale reads and staleness equal to
   the JAX reference's (FIG16_REF), crash aborts and availability < 1 on
   the crash lanes, availability 1 on the controls; events/s, steps, loop
   iterations an event and the windows stopped at a fault row;
5d. fig17 the same way (6 lanes: partitions, degrades and the control x
   ssp / geotp, replicas at 30 ms, lag 500 ms; FIG17_REF): failovers and
   stale reads on the partition lanes; then `profile_step.measure` over
   the faulted windowed replay, printed beside phase 5b's fault-free one.

Slice 2, the serving path of the LM stack (dense GQA, llama3.2-3b):

6. build — `decode_attention.cu`, `flash_attention.cu`, `mlstm_chunk.cu`
   and `rglru_scan.cu`, each by its own nvcc started beside phase 2's, so
   they compile while phases 3-5 run; ptxas's line for each variant, and
   a failure if a variant of the two attention kernels or of mlstm_chunk
   has a stack frame or spills;
7. kernels vs plain versions on the card — every FLASH_CASES / DECODE_CASES
   row of the reference's kernel tests, the WIDE_* cases (head dims up
   to 256, decode's G = 3 and G = 5 row layouts) and the EXTRA_* edge cases
   of the redesigned kernels (S past a window and not a multiple of the
   query block, G = 3 at dh 128, S below one tile, unaligned rows; Sc not a
   multiple of the split, leading splits with no valid slot, a row with
   none, B = 1 over several splits, G = 20, unaligned rows)
   in float32 and bfloat16, plus the serving path's own launch shapes in
   float32 and bfloat16 (prefill B = 8 x 2048 tokens at 24/8 heads of 128;
   decode B = 8 over a 4096-slot cache with random positions; the router's
   decode B = 1 over 64 slots, slot 0 valid), within 2e-5 (f32) / 2e-2
   (bf16) abs + rel; in bf16 at the serving shapes and the EXTRA_* cases
   also per query row (||d|| <= 1e-2 ||ref|| + 1e-3: sees a dropped key
   tile) and bit for bit over two calls; CUDA-event times of the kernel,
   its plain version and `F.scaled_dot_product_attention` (timed only,
   never used by the port);
8. model, GPU vs CPU — llama3.2-3b at full width cut to 2 layers, one set of
   weights drawn on the CPU and copied to the card: prefill 2 x 128 tokens,
   then 4 decode steps, logits within 0.05 abs/rel; the router
   (`GeoServingEngine`, run_model=True, geotp and fcfs) gives exactly equal
   summaries and latency lists on both devices;
9. the serving path at full width — llama3.2-3b, all 28 layers, weights
   drawn on the card: (a) `make_prefill_step(cfg, 4096)` on 8 prompts of
   2048 tokens, then 64 `make_decode_step` steps, with 28 flash launches per
   prefill (every one bf16: the tensor-core kernel) and 28 decode calls per
   step (each the split kernel and its merge); (b) `GeoServingEngine` geotp vs
   fcfs over the launcher's three pods (RTT 0/30/100 ms, 12 slots), 60
   requests, run_model=True: geotp's average latency below fcfs's, 28
   decode launches per generation and one geo_schedule launch per geotp
   admission. Cut: `max_seq` 32768 -> 4096 for the pods' slot caches
   (3 x 12 slots x 28 layers at 32768 would need 135 GB).

Slice 3, the recurrent mixers (xlstm-350m, recurrentgemma-9b):

10. kernels vs plain versions on the card — `mlstm_chunk` on MLSTM_CASES at
    10 x TOL and `rglru_scan` on RGLRU_CASES at 5 x TOL (the reference
    tests' limits), both dtypes, mlstm's bf16 (tensor-core) kernel also per
    query row and bit for bit over two calls; the RG-LRU kernel's fused
    entry `ops.rglru` (b formed in the kernel) against the plain
    composition (`gated_input`, then `rglru_ref`) on RGLRU_CASES with and
    without a carry h0, and from h0 at S = 1 and 300 at the serving width,
    float32 and bf16 gx; its exact carry checks (torch.equal: a = 1, b = 1
    counts t + 1, a = 0 resets; the fused op holds h0 or the last reset's
    gx) on RGLRU_EXACT_CASES and the serving shape; both kernels again at
    their serving shapes in float32 ([8,4,2048,256], [4,4096,4096]) at
    2e-5, the RG-LRU entries twice bit for bit in both dtypes, and mlstm
    in bf16 there at TOL, per row and bit for bit; the attention kernels
    with logit caps 50 and 5 on FLASH_CASES / DECODE_CASES and at
    recurrentgemma's shapes (flash B = 4 x 4096, 16/1 heads of 256, window
    2048; decode B = 4 over a 2048-slot ring), cap 50, both dtypes, and
    there in bf16 per query row and bit for bit over two calls;
    CUDA-event times of the kernels and their plain versions (mlstm in
    bf16, the serving path's type, and in float32; the RG-LRU contract,
    fused op and the eager b formation plus the contract in turns, each
    against the bound and in TB/s, and decode's S = 1 step fused vs the
    eager update; no PyTorch call computes the gated recurrence, mLSTM's
    signed normaliser or a capped softmax: no library time);
11. xlstm-350m — (a) GPU vs CPU at full width cut to 8 layers (one period,
    with the sLSTM), layer by layer from the CPU's inputs: prefill 2 x 128,
    4 decode steps, every layer's output, cache leaf and the logits within
    0.08 abs + rel; (b) all 24 layers, weights drawn on the card: prefill
    8 x 2048 (21 mlstm launches per prefill, every one bf16: the
    tensor-core kernel), 64 decode steps at B = 8, the
    router geotp vs fcfs (run_model=True), geotp's average latency below
    fcfs's;
12. recurrentgemma-9b — (a) as 11a at 5 layers (one group and the tail);
    (b) all 38 layers, weights drawn and cast tensor by tensor on the card:
    prefill 4 x 4096 (26 fused RG-LRU and 12 flash launches per prefill,
    past the 2048 window: band skip and ring wrap), 64 decode steps at
    B = 4 (26 fused RG-LRU and 12 decode launches a step), the router
    geotp vs fcfs (the same launches per step for every generation).

Slice 7, the MoE and MLA families (mixtral-8x7b, llama4-scout, minicpm3-4b):

13. flash with V heads narrower than its Q/K heads vs its plain version —
    MLA_FLASH_CASES (dh / dv 96 / 64, 48 / 32, 192 / 128, 256 / 40;
    causal, windowed, chunk-local, non-causal; caps 0 and 50) in both
    dtypes, bf16 per row and bit for bit; minicpm3-4b's prefill launch
    ([8,2048,40,96], dv 64, causal) in float32 at TOL and in bf16 per row;
    CUDA-event times of the kernel, its plain version and SDPA on the same
    tensors, against the tensor cores' bound;
14. mixtral-8x7b — (a) flash and decode vs their plain versions at the
    path's shapes (`path_shape_checks`): flash [4,4608,32,8,128] swa 4096,
    decode over the 4096-slot ring (full, as after the prefill, and random
    positions) and the router's B = 1 decode, in float32 at TOL and in
    bf16 per row and bit for bit; then GPU vs CPU over one period (1 layer)
    at full width, layer by layer from the CPU's input, within 0.05, the
    MoE routing read on both devices and held by `routelog.compare` (a
    token whose experts differ must be a near tie of the CPU's gates, one
    whose kept assignments alone differ must follow such a flip in its
    row; those are counted, at most routelog.MAX_FLIPS, and not compared);
    (b) CUT to 16 of 32 layers (~46 GB of bf16 weights, drawn on the card
    one layer group at a time): prefill 4 x 4608 (past the 4096 window),
    the assignments the capacity (1.25) drops, 64 decode steps at B = 4,
    flash / decode launches equal to the layer pattern's (16 a prefill, 16
    a step); (c) the router geotp vs fcfs, its summaries equal to the
    CPU's;
15. llama4-scout — as 14 (one period = 4 layers; the path's shapes: flash
    [2,10240,40,8,128] cla 8192 and NoPE gqa, decode over the 8192-slot
    cla ring and the 10304-slot linear cache), CUT to 12 of 48 layers
    (three periods, ~54 GB), prefill 2 x 10240 (past the 8192 chunk), 64
    decode steps at B = 2 (12 flash a prefill, 12 decode a step); no
    router (its pods' linear NoPE caches do not fit beside the weights);
16. minicpm3-4b — as 14 (one layer), then all 62 layers uncut: prefill
    8 x 2048 (62 flash launches at dv 64 < dh 96), 64 decode steps at
    B = 8 (the absorbed MLA decode: plain products, no decode launch), the
    router with `max_seq` cut to 4096 for its pods, as llama's.

Slice 8, the vision frontend, the encoder-decoder and the int8 KV cache
(internvl2-26b, seamless-m4t-large-v2, h2o-danube-3-4b):

17. kernels vs plain versions on the card — flash's cross route (Sk != S,
    non-causal) on CROSS_CASES (Sq below one warpgroup's 64 rows, Sk below
    and across one 64-key tile, Sq past one 128-query block and above Sk,
    dh 64 / 120 / 128 / 256) and seamless's cross launch CROSS_MAIN
    (8 x 32 decoder tokens over 1,024 frames, 16/16 heads of 64); flash at
    seamless's encoder shape (non-causal) and at h2o's prefill
    ([8,4608,32,8,120], swa 4096: dh 120); decode at seamless's cross step
    (1,024 valid slots); decode's int8 entry on INT8_DECODE_CASES (h2o's
    ring of 4,096 with every slot valid and at random positions, llama's
    linear cache, edges) — each in float32 at TOL and in bf16 at TOL, per
    query row and bit for bit over two calls, the int8 entry also bit for
    bit the same dtype's entry on the `_kv_dequantize`d cache; decode over
    an empty memory (Sc = 0): zeros, no launch; CUDA-event times of the
    cross route (SDPA on the same tensors), h2o's flash and the int8 entry
    (the bf16 entry on the dequantized cache beside it; no library call
    reads an int8 cache), each against its bound;
18. internvl2-26b — (a) flash and decode at the path's shapes, then GPU vs
    CPU over one layer at full width, layer by layer, 64 patch embeddings
    ahead of the prompt, within 0.05; (b) all 48 layers uncut (39.8 GB of
    bf16 weights, drawn on the card one layer group at a time): prefill
    4 x (1,280 patches + 768 tokens) into a 4,096-slot cache, 64 decode
    steps, 48 flash launches a prefill and 48 decode calls a step; (c) the
    router geotp vs fcfs, summaries equal to the CPU's, `max_seq` cut to
    2,048 for its pods;
19. seamless-m4t-large-v2 — (a) as 18a over one encoder and one decoder
    layer, 64 frames (the encoder's layers held too, the decoder's on the
    CPU's encoder output); (b) 24 + 24 layers uncut: 8 x 1,024 stub fbank
    frames of 160 and 32 decoder tokens, cache 256, 64 decode steps, 72
    flash launches a prefill (24 encoder, 24 decoder, 24 on the cross
    route) and 48 decode calls a step (24 self, 24 cross); (c) the router
    over pods with an empty encoder memory (its cross step zeros without a
    launch), `max_seq` cut to 4,096; (d) h2o-danube-3-4b at full size, one
    set of weights with the bf16 and the int8 cache: prefill 8 x 4,608
    (past the 4,096 window: the ring wraps), logits equal bit for bit, 16
    decode steps of each, the int8 logits within 0.05 of the bf16 run's
    largest, 24 int8 decode launches a step.

Phases 11-19 draw the GPU-vs-CPU check's weights on the card and copy
them to the CPU.

Slice 11, continuation (`Simulator.resume`, `RunResult.with_states` /
`save`) and the port's smoke path, run after phase 19:

5e. fig11's online segments (`repro_torch.bench.figures.fig11_online`, the
   reference's `benchmarks/figures.py:177-210`) at fig11's own size:
   T = 48, `ycsb_bank(48, theta=0.9, dist_ratio=0.6)`, jitter 30; for ssp
   and for geotp a first 8 s segment (warmup 1 s) through
   `Simulator.run`, then three segments, each `with_states` with
   `tau_true` edited and `resume(horizon_s=now / 1e6 + 8.0, warmup_s=0.0)`,
   the captured windowed step captured anew for each. Each preset is a
   single lane, as fig11 runs it: each chain's next horizon is its own
   `now` + 8 s, which two lanes of one grid cannot share. Every segment's
   events, commits, aborts, throughput and final clock equal the JAX
   reference's (FIG11_ONLINE_REF); two `geo_schedule` launches a step;
   each segment's steps, seconds, events/s and launches;
5f. the port's smoke (`repro_torch.bench.smoke`, the reference smoke's
   cells: fig5's YCSB deployment at T = 32, 2.5 s, drained, single-event,
   faults, partitions, protocols) with its bench file in a temporary
   directory: every guard holds, every leg's cells equal the JAX
   reference's events, commits and aborts (SMOKE_REF), the bench file
   holds the smoke entry and a sweep a leg, two `geo_schedule` launches a
   step; each leg's steps, seconds, events/s, drain hit rate and mean
   window.

Slice 12, the sequential lanes (`strategy="map"`, `engine.simulate`), run
after phase 5f:

5g. first the host cost of one eager op and of one host read (what a
   handler's inner branch costs either way); then (a) the 12 presets at
   fig5's YCSB deployment cut to T = 8 and 0.2 s (paper RTTs) through
   `run_grid(strategy="map")`, single-event and drained, fault-free and
   under CRASH_HEAVY with replicas: every leaf but `fused` equal to the
   card's vmap lanes, `geo_schedule` launched eagerly, and every final leaf
   equal to the same map lanes on the CPU; (b) phase 5's world (fig5's YCSB
   deployment at T = 128) for geotp, seed 0, its horizon cut (printed):
   untimed to the warm-up at 0.3 s (the map lane through `engine.simulate`
   equal to the vmap lane on every leaf), then timed to 0.45 s in both
   modes through `engine.simulate(state=)`, each equal to the vmap lane
   resumed over the same span on every leaf but `fused`. Each run's
   events/s, host ms an event and launches, beside the vmap lanes' rate
   without their capture. Every timed run has the host to itself: the
   CPU's map lanes (four processes) run beside (b)'s untimed prefix.

Slice 13, the paper's figure sweeps through the port
(`repro_torch.bench.figures`), run after phase 5g:

5h. every figure of `ALL_FIGURES` but fig11, fig16 and fig17 (phases 5c-5e
   run those uncut): 12 figures, 19 grids, 204 lanes, each sweep at the
   reference's quick widths (T = 48; fig5's T 16 / 32 / 64 YCSB and
   16 / 32 TPC-C; fig7's 60 lanes with the QURO banks, fig9's TPC-C
   Payment / NewOrder banks, fig14's 15- and 25-op and 1-3-round banks,
   fig1's two data sources of 500,000 records, fig18's 28 protocol lanes)
   through `figures.run` (`run_sweep` on the captured windowed step), only
   the horizon cut (FIGURES_CUT): every lane's events, commits, aborts
   and hist_all digest equal to the JAX reference's (FIGURES_REF), two
   `geo_schedule` launches a step; each grid's steps, seconds and events/s;
   the figures' row code on the results and `claims.validate`'s verdicts
   on those cut payloads, printed and not gated.

The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import pathlib
import re
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PRESETS_MAIN = ("ssp", "ssp-local", "scalardb", "geotp")
SEEDS_MAIN = (0, 1, 2, 3)
T_MAIN = 128
HORIZON_S, WARMUP_S = 2.5, 0.5  # cut from fig5's 10 s / 2 s
GEO_CASES = [(64, 4, 8), (256, 8, 16), (100, 3, 5), (48, 4, 5), (37, 2, 4), (16, 4, 5)]
B_MAIN, D_MAIN, K_MAIN = 16, 4, 5  # lanes, data sources, ops per txn of phase 5
# phase 5's processed events, as the eager lockstep step processed them; the
# captured step runs the same step, so any other count is a fault
MAIN_EVENTS = 139_853
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 on the tensor cores


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def kernel_label(mangled: str) -> str:
    """`decode_kernel<bfloat16, 8>` from the mangled name of a kernel
    variant (its name and its template's type, integer and bool
    arguments; a template whose first argument is not a type has none)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), ""
    while i < len(mangled) and mangled[i].isdigit():  # <length><name> ... (namespaces)
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    if not rest.startswith("I"):
        return name
    args = (["bfloat16"] if rest.startswith("I13__nv_bfloat16")
            else ["float32"] if rest.startswith("If") else [])
    args += [v if t == "i" else ("false", "true")[int(v)]
             for t, v in re.findall(r"L([ib])(\d+)E", rest)]
    if re.search(r"L[ib]\d+EaE", rest):  # a trailing int8_t (signed char): the int8 cache
        args.append("int8")
    return f"{name}<{', '.join(args)}>"


def ptxas_entries(report: str) -> list[tuple[str, int, int, int, int]]:
    """(variant, registers, stack frame, spill stores, spill loads) for each
    kernel variant of a `ptxas -v` report."""
    out, label, frame = [], None, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            label = kernel_label(m.group(1))
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frame = [int(x) for x in m.groups()]
        elif (m := re.search(r"Used (\d+) registers", line)) and label and frame:
            out.append((label, int(m.group(1)), *frame))
            label = frame = None
    return out


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel variant of a `ptxas -v` report: registers, stack
    frame and spill bytes (whether the variant keeps its state in
    registers)."""
    return [f"{label}: {regs} registers, {stack} B stack frame, {st} B spill stores, "
            f"{ld} B spill loads" for label, regs, stack, st, ld in ptxas_entries(report)]


def print_build(name: str, secs: float, note: str = "", strict: bool = False) -> None:
    """The build's time and ptxas's line for each variant; `strict`: fail
    unless every variant keeps its state in registers (no stack, no spill)."""
    from repro_torch.kernels import _build

    print(f"built {_build.library_path(name).relative_to(ROOT)} in {secs:.2f} s{note}")
    report = _build.report_path(name).read_text()
    for line in ptxas_lines(report):
        print(f"  ptxas {line}")
    bad = [e[0] for e in ptxas_entries(report) if any(e[2:])]
    if strict and bad:
        raise AssertionError(f"{name}: stack frame or spills in {bad}")


def geo_inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    tau = rng.integers(0, 300_000, (n, d)).astype(np.int32)
    lel = rng.integers(0, 50_000, (n, d)).astype(np.int32)
    inv = rng.random((n, d)) < 0.6
    inv[:, 0] = True
    inv[-1] = False
    c = rng.integers(0, 100, (n, k)).astype(np.int32)
    t = (c + rng.integers(0, 50, (n, k))).astype(np.int32)
    a = rng.integers(0, 10, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < 0.8
    valid[-2] = False
    return [torch.from_numpy(x) for x in (tau, lel, inv, c, t, a, valid)]


def step_launches(n, d, k, seed):
    """The kernel's two launches in one lockstep step, built as the step
    builds them: Eq.9 (`omni.py`) with [n,1] zero tau/lel and an all-False
    inv beside [n,k] counts; Eq.8 (`handlers._stagger`) with [n,d] tau/lel
    beside [n,1] zero counts and an all-False valid."""
    tau, lel, inv, c, t, a, valid = geo_inputs(n, d, k, seed)
    zn = torch.zeros((n, 1), dtype=torch.int32)
    return {
        "eq9": (zn, zn, zn.bool(), c, t, a, valid),
        "eq8": (tau, lel, inv, zn, zn, zn, zn.bool()),
    }


def check_kernel(args, label, geo_schedule, geo_schedule_ref) -> float:
    """Kernel == plain version on `args`: offsets equal, |dp| <= 1e-6, and
    all-masked rows give off = 0, p = 0. Returns max |dp|."""
    off_r, p_r = geo_schedule_ref(*args)
    off, p = geo_schedule(*args)
    torch.cuda.synchronize()
    if not torch.equal(off, off_r):
        raise AssertionError(f"offsets differ at {label}")
    err = (p - p_r).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"p_abort differs by {err} at {label}")
    dead_d, dead_k = ~args[2].any(1), ~args[6].any(1)
    if off[dead_d].any() or p[dead_k].any():
        raise AssertionError(f"all-masked rows must give off = 0 and p = 0 at {label}")
    print(f"{label}: offsets equal, max |dp| = {err:.3g}")
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, timed with CUDA events."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def geo_work(tau, lel, inv, c, t, a, valid):
    """(bytes, operations) of one launch on these inputs: each input read
    once and both outputs written once, vs 3 int ops per D entry (max,
    subtract, clamp), 12 float ops per valid K entry (log and exp counted
    as one op each) and the final exp of each row."""
    n, d = tau.shape
    k = c.shape[1]
    nbytes = n * (d * (4 + 4 + 1) + k * (4 * 3 + 1) + d * 4 + 4)
    return nbytes, 3 * n * d + 12 * int(valid.sum()) + n


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """Least time (ms) for this work on the card, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main_grid():
    """Phase 5's grid: fig5's YCSB deployment at T = 128 for the smoke
    presets x seeds 0-3, each cell with its seed's bank (16 lanes)."""
    from repro_torch.core import workloads
    from repro_torch.core.engine import Grid

    banks = {
        sd: workloads.make_ycsb_bank(
            workloads.YCSBConfig(num_ds=4, records_per_node=1_000_000, ops_per_txn=5,
                                 dist_ratio=0.2, theta=0.9, seed=sd), T_MAIN, 256)
        for sd in SEEDS_MAIN
    }
    cells = [dict(preset=p, seed=sd) for sd in SEEDS_MAIN for p in PRESETS_MAIN]
    return Grid(cells, banks=[banks[c["seed"]] for c in cells])


def profile_replays(grid, dev, drain, bank=None, terminals=None) -> dict:
    """`profile_step.measure` over a window of replays of `grid`'s captured
    step, windowed (`drain`) or single-event (its output printed); it fails
    unless the trace holds exactly two `geo_schedule_kernel` launches a
    step (the eager warm-up's and the replays'). Returns the summary;
    `geo_ms` reads B1's device ms a launch."""
    import profile_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    res = profile_step.measure(grid, profile_step.WINDOW, dev, acts, drain=drain, bank=bank,
                               terminals=terminals)
    profile_step.report(res)
    return res


def geo_ms(prof: dict) -> float:
    import profile_step

    return prof["kernels"][profile_step.GEO_KERNEL]["us_per_launch"] / 1e3


# the drain telemetry: the only leaves a drained run may differ on from the
# single-event run
TELEMETRY = ("drained", "windows", "win_stops", "fused", "chained")


def leaves_but_telemetry_equal(a, b, what):
    bad = [(n, lanes) for n, lanes in leaf_mismatches(a, b) if n not in TELEMETRY]
    for name, lanes in bad:
        print(f"MISMATCH leaf {name} lanes {lanes}")
    if bad:
        raise AssertionError(f"{len(bad)} SimState leaves differ: {what}")
    print(f"every SimState leaf but the drain telemetry equal: {what}")


def drain_line(res) -> str:
    d = res.drain
    stops = {k: v for k, v in d["window_stops"].items() if v}
    return (f"drained {d['drained_events']} of {d['events']} events (hit rate "
            f"{d['drain_hit_rate']}), {d['windows']} windows (mean {d['mean_window_len']}), "
            f"loop iterations {d['loop_iters']} ({d['loop_iters'] / d['events']:.4f} an "
            f"event), chained {d['chained']}, window stops {stops}")


def candidates_by_argmin(flat, W):
    """The reference's lockstep route to the window plan's candidates
    (`src/repro/core/engine/window.py:207-223`): W masked first-occurrence
    argmins, the first time after them, and each slot's rank as the count
    of candidates before it (saturated at W). `window._candidates` takes one
    sort instead."""
    B, M = flat.shape
    ids = torch.arange(M, device=flat.device)
    mflat, cand = flat, []
    for _ in range(W):
        j = mflat.argmin(1)
        cand.append(j)
        mflat = torch.where(ids == j[:, None], 2**31 - 1, mflat)
    cand_i = torch.stack(cand, 1)
    cand_t = flat.gather(1, cand_i)
    before = (cand_t[..., None] < flat[:, None]) | (
        (cand_t[..., None] == flat[:, None]) & (cand_i[..., None] < ids))
    return cand_i, cand_t, mflat.amin(1), before.sum(1, dtype=torch.int32)


def graph_ms(fn, iters: int = 500) -> float:
    """Device ms of one call of `fn` captured into a CUDA graph (no host
    issue), by CUDA events over `iters` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def check_candidates(states) -> None:
    """The plan's sort route (`window._candidates`) equals the reference's
    argmin route on `states`' event times (ties at INF_US among them), and
    both timed as captured graphs at that shape."""
    from repro_torch.core.engine import window
    from repro_torch.core.engine.state import _times_flat

    flat, W = _times_flat(states), window.PLAN_CAP
    got, want = window._candidates(flat, W), candidates_by_argmin(flat, W)
    for name, x, y in zip(("cand_i", "cand_t", "t_w1", "pos"), got, want):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"window._candidates: {name} differs from the argmin route")
    sort_ms = graph_ms(lambda: window._candidates(flat, W))
    argmin_ms = graph_ms(lambda: candidates_by_argmin(flat, W))
    print(f"plan candidates at [{flat.shape[0]}, {flat.shape[1]}], W = {W}: the sort route "
          f"equals the argmin route; {sort_ms:.5f} ms (sort) vs {argmin_ms:.5f} ms "
          f"({W} masked argmins), device time in a captured graph")


def gpu_vs_cpu(bank, grid, drain, horizon_s=1.0, warmup_s=0.2, cpu=None):
    """Phases 4 / 4b / 4c: `grid` on the card (a captured step) and on the
    CPU (eager), single-event or windowed; every final leaf and the step
    count must be equal, and `geo_schedule` launched twice a step on the
    card. `cpu`, if given, is the CPU run, made elsewhere (`cpu_run`).
    Returns ({"cuda": run, "cpu": run}, launches)."""
    from repro_torch.core.engine import Simulator, batch
    from repro_torch.kernels.geo_schedule import ops

    res = {}
    for name in ("cuda", "cpu"):
        if name == "cpu" and cpu is not None:
            res[name] = cpu
            how = "eager, in a process of its own beside the card's phases"
        else:
            sim = Simulator.from_bank(bank, horizon_s=horizon_s, warmup_s=warmup_s, drain=drain,
                                      track_slots=True, device=name)
            before = ops.geo_schedule.launches
            res[name] = sim.run_grid(grid, bank)
            launches = ops.geo_schedule.launches - before
            if launches != (2 * res[name].steps if name == "cuda" else 0):
                raise AssertionError(f"{name}: geo_schedule launches {launches} for "
                                     f"{res[name].steps} steps")
            if name == "cuda":
                cuda_launches = launches
            how = (f"a captured step replayed, warm-up and capture {batch.run.capture_s:.3f} s"
                   if name == "cuda" else "eager")
        print(f"{name}: {res[name].steps} steps, {res[name].events} events, "
              f"{res[name].wall_s:.2f} s ({how})")
    if res["cuda"].steps != res["cpu"].steps:
        raise AssertionError(f"steps differ: GPU {res['cuda'].steps}, CPU {res['cpu'].steps}")
    bad = leaf_mismatches(res["cuda"].states, res["cpu"].states)
    for name, lanes in bad:
        print(f"MISMATCH leaf {name} lanes {lanes}")
    if bad:
        raise AssertionError(f"{len(bad)} SimState leaves differ between GPU and CPU")
    print(f"every SimState leaf equal on {len(grid)} lanes ({len(res['cuda'].states)} fields)")
    if drain:
        print(drain_line(res["cuda"]))
    return res, cuda_launches


def main_path(grid, drain):
    """Phases 5 / 5b: fig5's grid through `Simulator.run_grid` on the card,
    single-event or windowed: noops 0 and commits on every lane,
    MAIN_EVENTS events, two `geo_schedule` launches a lockstep step.
    Returns (RunResult, launches)."""
    from repro_torch.core.engine import Simulator, batch
    from repro_torch.kernels.geo_schedule import ops

    cells = grid.cells
    sim = Simulator.from_bank(grid.banks[0], horizon_s=HORIZON_S, warmup_s=WARMUP_S, drain=drain)
    torch.cuda.reset_peak_memory_stats()
    ops.geo_schedule.launches = 0
    main = sim.run_grid(grid)
    launches = ops.geo_schedule.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if launches != 2 * main.steps:
        raise AssertionError(f"geo_schedule launches {launches} != 2 x {main.steps} steps")
    for i, m in enumerate(main.metrics):
        if m["noops"] != 0 or m["commits"] <= 0:
            raise AssertionError(f"lane {i} {cells[i]}: noops={m['noops']} commits={m['commits']}")
    ev = main.events
    if ev != MAIN_EVENTS:
        raise AssertionError(f"{ev} events, the eager step gave {MAIN_EVENTS}")
    step = "windowed step (_omni_window)" if drain else "single-event step (_omni_step)"
    print(f"warm-up step and capture of the {step}: {batch.run.capture_s:.3f} s "
          f"(part of the wall time)")
    print(f"steps {main.steps} (up to 31 idle tail steps included), events {ev}, "
          f"wall {main.wall_s:.3f} s, {main.steps / main.wall_s:.1f} steps/s, "
          f"{ev / main.wall_s:.1f} events/s, {main.wall_s / main.steps * 1e3:.4f} ms a step, "
          f"peak device memory {peak_mib:.1f} MiB, geo_schedule launches {launches}")
    if drain:
        print(drain_line(main))
    for p in PRESETS_MAIN:
        rows = [r for r in main.rows() if r["preset"] == p]
        tps = np.mean([r["throughput_tps"] for r in rows])
        lat = np.mean([r["avg_latency_ms"] for r in rows])
        print(f"{p:10s} throughput {tps:9.2f} tps  avg latency {lat:8.2f} ms  "
              f"(mean of {len(rows)} seeds)")
    return main, launches


def leaf_mismatches(a, b):
    from repro_torch.core.engine.state import tree_leaves

    out = []
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            out.append((name, "dtype/shape"))
            continue
        neq = (x != y).reshape(x.shape[0], -1).any(1) if x.dim() else (x != y).reshape(1)
        lanes = torch.nonzero(neq).flatten().tolist()
        if lanes:
            out.append((name, lanes))
    return out


# ---------------------------------------------------------------------------
# slice 10: fault injection (typed crash / partition / degrade schedules,
# heartbeats, replica failover) in the captured lockstep steps
# ---------------------------------------------------------------------------

# phase 4c: the reference tests' scale and schedules (tests/core/test_faults.py,
# tests/core/test_partitions.py): T 8, K 4, D 2, 32 txns a terminal
SMALL_T, SMALL_K, SMALL_D, SMALL_N = 8, 4, 2, 32
SMALL_RTT = (10.0, 100.0)
SMALL_HORIZON_S = 2.0
MW, KIND_PARTITION, KIND_DEGRADE = -1, 1, 2
CRASH_HEAVY = ((100_000, 0, 400_000), (600_000, 1, 1_300_000), (1_500_000, 0, 1_700_000))
PART_HEAVY = (
    (200_000, KIND_PARTITION, MW, 0, 1_200_000, 0),
    (1_300_000, KIND_DEGRADE, MW, 1, 1_800_000, 5_000),
    (1_400_000, KIND_PARTITION, 0, 1, 1_900_000, 0),
)
REPLICA_TAU, REPL_LAG_US = (60_000, 60_000), 250_000

# phases 5c / 5d: fig16 and fig17 at paper size, their sweeps as
# `repro_torch.bench.figures` builds them under --full (quick=False): T 48,
# fig5's YCSB bank (4 data sources at 0/27/73/251 ms, 1M records per node,
# zipf 0.9, 20% distributed), horizon 20 s, warmup 1 s
# Each lane's numbers as the JAX reference gives them for the same cells,
# from `PYTHONPATH=src python -m benchmarks.run --full --only fig16` (and
# `--only fig17`), read from the results/bench/fig16_faults.json and
# fig17_partitions.json that the command writes: (schedule, preset, events,
# commits, aborts, availability, abort_causes, commits_during_fault,
# link_downtime_us, failovers, stale_reads, max_staleness_us). fig16's file
# holds no link or replica fields: its cells carry no replica (nothing
# fails over), and its crash spells, [2 s, 4 s) at DS 0 and [5 s, 6.5 s) at
# DS 2, are the downtime its availability 0.95625 = 1 - 3.5 s / (4 x 20 s)
# charges.
_CAUSES = ("none", "timeout", "admission", "crash", "exhausted")
_FIG16_DOWN = [2_000_000, 0, 1_500_000, 0]
FIG16_REF = [
    ("crashes", "ssp", 25845, 1710, 176, 0.95625, (0, 19, 0, 157, 0), 304, _FIG16_DOWN, 0, 0, 0),
    ("crashes", "geotp", 27173, 1890, 196, 0.95625, (0, 16, 8, 172, 0), 373, _FIG16_DOWN, 0, 0,
     0),
    ("fault-free", "ssp", 24411, 1588, 26, 1.0, (0, 26, 0, 0, 0), 0, [0] * 4, 0, 0, 0),
    ("fault-free", "geotp", 28314, 1985, 27, 1.0, (0, 18, 9, 0, 0), 0, [0] * 4, 0, 0, 0),
]
FIG17_REF = [
    ("partitions", "ssp", 25410, 1679, 57, 0.96875, (0, 7, 0, 50, 0), 137,
     [0, 2_500_000, 0, 0], 2, 4, 1934996),
    ("partitions", "geotp", 25676, 1763, 101, 0.96875, (0, 20, 13, 68, 0), 193,
     [0, 2_500_000, 0, 0], 4, 9, 2342689),
    ("degrades", "ssp", 25312, 1651, 17, 1.0, (0, 17, 0, 0, 0), 0, [0] * 4, 0, 0, 0),
    ("degrades", "geotp", 29323, 2057, 31, 1.0, (0, 22, 9, 0, 0), 0, [0] * 4, 0, 0, 0),
    ("fault-free", "ssp", 24411, 1588, 26, 1.0, (0, 26, 0, 0, 0), 0, [0] * 4, 0, 0, 0),
    ("fault-free", "geotp", 28314, 1985, 27, 1.0, (0, 18, 9, 0, 0), 0, [0] * 4, 0, 0, 0),
]
LANE_KEYS = ("events", "commits", "aborts", "availability", "abort_causes",
             "commits_during_fault", "link_downtime_us", "failovers", "stale_reads",
             "max_staleness_us")


def small_fault_grid():
    """Phase 4c's grid: the 12 presets under CRASH_HEAVY, then under
    PART_HEAVY with replicas (24 lanes), and their shared bank."""
    from repro_torch.core import workloads
    from repro_torch.core.engine import Grid
    from repro_torch.core.protocols import PRESETS

    bank = workloads.make_ycsb_bank(
        workloads.YCSBConfig(num_ds=SMALL_D, records_per_node=2000, ops_per_txn=SMALL_K,
                             dist_ratio=0.5, theta=0.9, seed=0), SMALL_T, SMALL_N)
    presets = sorted(PRESETS)
    cells = [dict(preset=p, rtt_ms=SMALL_RTT, faults=CRASH_HEAVY) for p in presets]
    cells += [dict(preset=p, rtt_ms=SMALL_RTT, faults=PART_HEAVY, replica_tau=REPLICA_TAU,
                   repl_lag_us=REPL_LAG_US) for p in presets]
    return bank, Grid(cells, default_rtt_ms=SMALL_RTT)


def presets_grid():
    """Phases 4 / 4b's grid: the 12 presets (jitter 30, paper RTTs) over fig5's
    YCSB deployment at T = 16, and their shared bank."""
    from repro_torch.core import workloads
    from repro_torch.core.engine import Grid
    from repro_torch.core.protocols import PRESETS

    bank = workloads.make_ycsb_bank(
        workloads.YCSBConfig(num_ds=4, records_per_node=1_000_000, ops_per_txn=5,
                             dist_ratio=0.2, theta=0.9, seed=0), 16, 256)
    return bank, Grid.cross(preset=tuple(sorted(PRESETS)), jitter_milli=30)


# the CPU runs of the GPU-vs-CPU phases: grid, horizon s, warmup s
CPU_RUNS = {"presets": (presets_grid, 1.0, 0.2), "faults": (small_fault_grid, SMALL_HORIZON_S, 0.0)}


def cpu_run(kind, drain):
    """The CPU side (eager, one thread) of phases 4 / 4b (`kind` "presets")
    or 4c ("faults"), run in a process of its own so it overlaps the card's
    phases: a stand-in for its RunResult with the final states as numpy
    arrays."""
    import types

    from repro_torch.core.engine import Simulator
    from repro_torch.core.engine.state import tree_map

    torch.set_num_threads(1)
    make, horizon_s, warmup_s = CPU_RUNS[kind]
    bank, grid = make()
    sim = Simulator.from_bank(bank, horizon_s=horizon_s, warmup_s=warmup_s, drain=drain,
                              track_slots=True, device="cpu")
    res = sim.run_grid(grid, bank)
    return types.SimpleNamespace(steps=res.steps, events=res.events, wall_s=res.wall_s,
                                 states=tree_map(lambda x: x.numpy(), res.states))


def start_cpu_runs():
    """The four CPU runs of phases 4, 4b and 4c (single-event, windowed),
    started in four processes; returns (pool, {(kind, drain): future of a
    `cpu_run`})."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    return pool, {(kind, drain): pool.submit(cpu_run, kind, drain)
                  for kind in CPU_RUNS for drain in (False, True)}


def cpu_result(cpu_runs, kind, drain):
    """A copy of a `cpu_run`'s result with its states as tensors again."""
    import types

    from repro_torch.core.engine.state import tree_map

    run = cpu_runs[kind, drain].result()
    return types.SimpleNamespace(**{**vars(run), "states": tree_map(torch.from_numpy,
                                                                    run.states)})


def fault_small_phase(cpu_runs):
    """Phase 4c: GPU == CPU on every leaf and step count under both
    schedules, single-event and windowed (the CPU runs from
    `start_cpu_runs`); the drained states equal the single-event ones but
    the drain telemetry. Returns the card's geo_schedule launches."""
    bank, grid = small_fault_grid()
    kw = dict(horizon_s=SMALL_HORIZON_S, warmup_s=0.0)
    out = {}
    for drain in (False, True):
        out[drain] = gpu_vs_cpu(bank, grid, drain, cpu=cpu_result(cpu_runs, "faults", drain),
                                **kw)
    (single, l1), (drained, l2) = out[False], out[True]
    leaves_but_telemetry_equal(drained["cuda"].states, single["cuda"].states,
                               "phase 4c, drained vs single-event on the card")
    d = drained["cuda"].drain
    if not (d["abort_causes"]["crash"] > 0 and d["failovers"] > 0 and d["stale_reads"] > 0
            and d["window_stops"]["fault"] > 0):
        raise AssertionError(f"the schedules did not bite: {d}")
    print(f"crash aborts {d['abort_causes']['crash']}, failovers {d['failovers']}, stale reads "
          f"{d['stale_reads']}, probes {int(drained['cuda'].states.hb_count.sum())}, "
          f"availability {d['availability']}, windows stopped at a fault row "
          f"{d['window_stops']['fault']}")
    return l1 + l2


def fig_sweep(fig):
    """fig16's or fig17's sweep at paper size (`figures.fig16_sweeps` /
    `fig17_sweeps` with quick=False): cells, bank, T, horizon and warmup."""
    from repro_torch.bench import figures

    return {"fig16": figures.fig16_sweeps, "fig17": figures.fig17_sweeps}[fig](False)[0]


def lane_numbers(res, i) -> dict:
    """Lane i's LANE_KEYS from its row and its `drain_stats`."""
    from repro_torch.core.engine.metrics import drain_stats

    m, d = res.metrics[i], drain_stats(res.world(i), horizon_us=res.cfg.horizon_us)
    return {"events": m["events"], "commits": m["commits"], "aborts": m["aborts"],
            **{k: d[k] for k in LANE_KEYS[3:]}}


def fig_phase(fig, device=None):
    """Phases 5c / 5d: the figure's sweep (`fig_sweep`) through
    `Simulator.run_grid` on the card, the captured windowed step: every
    lane's numbers equal to the reference's (FIG16_REF / FIG17_REF), two
    geo_schedule launches a step. Returns (RunResult, Grid, launches)."""
    from repro_torch.core.engine import Grid, Simulator, batch
    from repro_torch.kernels.geo_schedule import ops

    s = fig_sweep(fig)
    cells, bank, ref = s.cells, s.bank, (FIG16_REF if fig == "fig16" else FIG17_REF)
    grid = Grid(cells)
    sim = Simulator.from_bank(bank, terminals=s.terminals, horizon_s=s.horizon_s,
                              warmup_s=s.warmup_s, device=device)
    ops.geo_schedule.launches = 0
    res = sim.run_grid(grid, bank)
    launches = ops.geo_schedule.launches
    if launches != (2 * res.steps if sim.device.type == "cuda" else 0):
        raise AssertionError(f"geo_schedule launches {launches} != 2 x {res.steps} steps")
    bad = []
    for i, (cell, want) in enumerate(zip(cells, ref)):
        got = lane_numbers(res, i)
        exp = dict(zip(LANE_KEYS, want[2:]))
        exp["abort_causes"] = dict(zip(_CAUSES, exp["abort_causes"]))
        if (cell["schedule"], cell["preset"]) != want[:2]:
            raise AssertionError(f"lane {i}: cell {cell} is not the reference's {want[:2]}")
        diff = {k: (got[k], exp[k]) for k in LANE_KEYS if got[k] != exp[k]}
        print(f"{fig} {cell['schedule']:10s} {cell['preset']:5s} events {got['events']} commits "
              f"{got['commits']} aborts {got['aborts']} availability {got['availability']} "
              f"crash aborts {got['abort_causes']['crash']} commits in fault "
              f"{got['commits_during_fault']} failovers {got['failovers']} stale reads "
              f"{got['stale_reads']} staleness {got['max_staleness_us']} us link downtime "
              f"{got['link_downtime_us']}: {'the reference' if not diff else diff}")
        if diff:
            bad.append(i)
        faulted = cell["schedule"] != "fault-free"
        if cell["schedule"] == "crashes" and not (
                got["abort_causes"]["crash"] > 0 and got["availability"] < 1.0):
            bad.append(i)
        if cell["schedule"] == "partitions" and not (
                got["failovers"] > 0 and got["stale_reads"] > 0):
            bad.append(i)
        if not faulted and got["availability"] != 1.0:
            bad.append(i)
        if res.metrics[i]["noops"] != 0:
            bad.append(i)
    if bad:
        raise AssertionError(f"{fig}: lanes {sorted(set(bad))} differ from the reference")
    d = res.drain
    print(f"{fig}: steps {res.steps} (up to 31 idle tail steps included), events {d['events']}, "
          f"wall {res.wall_s:.3f} s ({batch.run.capture_s:.3f} s warm-up and capture), "
          f"{d['events'] / res.wall_s:.1f} events/s, {res.wall_s / res.steps * 1e3:.4f} ms a "
          f"step, geo_schedule launches {launches}")
    print(drain_line(res))
    print(f"{fig}: loop iterations per event {d['loop_iters'] / d['events']:.4f}, windows "
          f"stopped at a fault row (STOP_FAULT) {d['window_stops']['fault']}")
    return res, grid, launches


def replay_line(label, prof) -> str:
    return (f"{label}: {prof['wall_ms_per_replay']:.4f} ms a replay unprofiled, "
            f"{prof['device_kernels_per_step']:.0f} kernels a replay, device busy "
            f"{prof['device_busy_ms_per_step']:.4f} ms, idle share "
            f"{prof['idle_share_unprofiled']:.4f} (unprofiled wall) / "
            f"{prof['idle_share_profiled']:.4f} (profiled)")


# ---------------------------------------------------------------------------
# slice 2: the serving path of the LM stack
# ---------------------------------------------------------------------------

SERVE_ARCH = "llama3.2-3b"
SERVE_MAX_SEQ = 4096  # cut from 32768: the pods' slot caches (135 GB at 32768)
PREFILL_B, PREFILL_S, DECODE_STEPS = 8, 2048, 64  # phase 9a
ROUTER_REQUESTS, ROUTER_RATE = 60, 400.0  # phase 9b
ROUTER_CACHE = 64  # slots of the cache each `gen_done` decode step builds
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/kernels/test_kernels.py
LOGIT_TOL = 0.05  # bf16 logits (tests/models/test_archs.py)
# the reference's kernel test cases (tests/kernels/test_kernels.py)
FLASH_CASES = [
    # (B, S, H, KV, dh, causal, window, chunk_local)
    (2, 256, 4, 2, 64, True, 0, False),
    (1, 512, 4, 4, 128, True, 128, False),
    (2, 256, 8, 2, 120, True, 64, True),
    (1, 128, 2, 1, 64, False, 0, False),
    (1, 384, 6, 6, 32, True, 96, False),
]
DECODE_CASES = [(2, 1024, 8, 2, 64), (4, 512, 4, 4, 128), (1, 2048, 16, 1, 120), (3, 768, 6, 3, 64)]
# beyond the reference's cases: the widest head dim the wrappers take (256,
# each kernel's widest variant), a head dim between variants, and decode's
# row layouts G = 3 (two warps a row, two warps idle: the serving path's)
# and G = 5 (one warp a row) over ragged caches
WIDE_FLASH_CASES = [
    (1, 200, 4, 2, 256, True, 0, False),
    (1, 160, 2, 2, 256, True, 48, True),
    (1, 130, 2, 1, 192, False, 0, False),
]
WIDE_DECODE_CASES = [(2, 333, 6, 2, 128), (1, 257, 3, 1, 256), (2, 300, 10, 2, 256)]
# per query row: ||out - ref||_2 <= ROW_RTOL ||ref||_2 + ROW_ATOL. bf16 rounding
# of P and of the output gives 0.25-0.5% of a row's norm; a dropped 64-key
# tile moves each late causal row of its block by 7% or more (the CPU test
# tests/test_torch_attention_split.py), while the elementwise bf16 limit
# (2e-2 abs + rel) is about one late row's typical output value (~0.03)
ROW_RTOL, ROW_ATOL = 1e-2, 1e-3
DECODE_SPLIT_SWEEP = (2, 3, 4, 6, 8, 12)  # blocks an SM that phase 7 times the decode split at
# through the redesigned kernels' edges: flash with S not a multiple of the
# 128-query block past a 2048 window (cap 50), G = 3 at dh 128, S shorter
# than one key tile, a head dim whose rows are not 16-byte aligned (the
# plain-load path), chunk-local chunks of 256 (tiles inside one chunk take
# the unmasked path); decode with Sc not a multiple of the split, a linear
# cache whose leading splits are all invalid ("tail"), one all-invalid row
# beside valid ones ("dead_row"), the router's B = 1 over several splits,
# G = 20 (two blocks of rows a head) and unaligned rows
EXTRA_FLASH_CASES = [((1, 2100, 16, 1, 256, True, 2048, False), 50.0),
                     ((1, 2113, 6, 2, 128, True, 0, False), 0.0),
                     ((1, 1024, 4, 2, 128, True, 256, True), 0.0),
                     ((2, 37, 4, 2, 64, True, 0, False), 0.0),
                     ((1, 300, 4, 2, 36, True, 0, False), 0.0)]
EXTRA_DECODE_CASES = [((8, 4001, 24, 8, 128), None), ((4, 2048, 16, 1, 256), "tail"),
                      ((3, 1000, 6, 2, 128), "dead_row"), ((1, 300, 24, 8, 128), None),
                      ((2, 700, 40, 2, 64), None), ((2, 500, 6, 2, 34), None)]
# slice 3: the recurrent mixers (tests/kernels/test_kernels.py's cases)
# slice 7: V heads narrower than Q/K heads, (B, S, H, KV, dh, causal, window,
# chunk_local, dv): MLA's 96 / 64 (minicpm3-4b, causal, MHA) and 48 / 32
# (its reduced config), windowed, chunk-local and non-causal, GQA and MQA,
# and the dh-256 variants' narrower V panels (192 / 128, 256 / 40: a dv
# whose rows are not 16-byte aligned)
MLA_FLASH_CASES = [
    (2, 128, 4, 4, 96, True, 0, False, 64),
    (2, 128, 4, 2, 48, True, 32, False, 32),
    (1, 160, 4, 4, 48, True, 32, True, 32),
    (1, 96, 2, 1, 96, False, 0, False, 64),
    (1, 96, 2, 1, 192, False, 0, False, 128),
    (1, 192, 4, 2, 256, True, 64, False, 40),
]
MLSTM_CASES = [(1, 2, 256, 64), (2, 4, 128, 128), (1, 1, 512, 32)]  # (B, H, S, dh)
RGLRU_CASES = [(2, 256, 128), (1, 512, 512), (3, 128, 96)]  # (B, S, E)
# the RG-LRU kernel's exact carry checks: S not a multiple of its 64-step
# chunk, S below one chunk, E not a multiple of its 128-channel tile, an E
# whose rows are not 16-byte aligned (the per-channel load path), B x E
# below one tile column per SM, and 4133 steps over 8 columns (65 handoffs)
RGLRU_EXACT_CASES = [(1, 37, 96), (2, 70, 13), (2, 1000, 200), (1, 4133, 1000), (3, 130, 4096)]
RGLRU_H0_S = (1, 300)  # sequence lengths of the checks from a carry h0
SOFTCAPS = (50.0, 5.0)  # recurrentgemma's cap, and one that tanh saturates
# q is scaled by 8 in the softcap checks: scores ~ N(0, 64) reach past both
# caps (|s| / 5 up to ~6, where tanh saturates)
SOFTCAP_INPUT_SCALE = 8.0


def serve_cfg(n_layers=None):
    """llama3.2-3b at full width with the `max_seq` cut (and optionally
    fewer layers)."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get(SERVE_ARCH), max_seq=SERVE_MAX_SEQ)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def launch_shapes(cfg, batch, seq, cache_len, mixer=None):
    """The shapes the model gives each kernel: flash (B, S, H, KV, dh,
    causal, window, chunk_local) per prefill layer, decode (B, Sc, H, KV,
    dh) per decode layer of the attention mixer `mixer` (default: the
    pattern's first; every attention layer of a config alike). MLA's
    prefill gives flash every head's K (KV = H) at dh = nope + rope and V at
    dv = v_hd (a ninth entry); its decode is plain products (None)."""
    mixer = mixer or cfg.pattern[0][0]
    if mixer == "mla":
        dh = cfg.nope_head_dim + cfg.rope_head_dim
        return (batch, seq, cfg.n_heads, cfg.n_heads, dh, True, 0, False, cfg.v_hd), None
    window = cfg.window if mixer in ("swa", "cla") else 0
    cap = min(cfg.window, cache_len) if window else cache_len
    flash = (batch, seq, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True, window, mixer == "cla")
    return flash, (batch, cap, cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def _randn(shape, dtype, dev, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def flash_dims(case):
    """(B, S, H, KV, dh, causal, window, chunk_local, dv) of a flash case;
    a case of eight leaves V's head dim at dh, a ninth entry sets dv (MLA)."""
    return tuple(case) + (case[4],) * (9 - len(case))


def flash_inputs(case, dtype, dev, seed, scale=1.0):
    """q [B,S,H,dh], k [B,S,KV,dh], v [B,S,KV,dv] in the model's layout; q
    scaled by `scale`."""
    B, S, H, KV, dh, *_, dv = flash_dims(case)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, S, H, dh), dtype, dev, gen, scale), _randn((B, S, KV, dh), dtype, dev, gen),
            _randn((B, S, KV, dv), dtype, dev, gen))


def decode_inputs(case, dtype, dev, seed, valid_slots=None, scale=1.0, pattern=None):
    """q [B,H,dh] (scaled by `scale`), caches [B,Sc,KV,dh], valid [B,Sc]:
    slots <= a random pos in [1, Sc) per row, or the first `valid_slots`
    slots; `pattern` "tail": only the last Sc // 10 slots (every row), or
    "dead_row": row 1 has no valid slot."""
    B, Sc, H, KV, dh = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn((B, H, dh), dtype, dev, gen, scale)
    k, v = _randn((B, Sc, KV, dh), dtype, dev, gen), _randn((B, Sc, KV, dh), dtype, dev, gen)
    if valid_slots is None:
        pos = torch.randint(1, Sc, (B,), generator=gen, device=dev)
    else:
        pos = torch.full((B,), valid_slots - 1, device=dev)
    slots = torch.arange(Sc, device=dev)[None, :]
    valid = slots <= pos[:, None]
    if pattern == "tail":
        valid = (slots >= Sc - max(Sc // 10, 1)).expand(B, Sc).contiguous()
    elif pattern == "dead_row":
        valid[1] = False
    elif pattern is not None:
        raise ValueError(f"unknown valid pattern {pattern!r}")
    return q, k, v, valid


def _to_bhsd(*xs):
    return [x.transpose(1, 2).contiguous() for x in xs]


def check_close(out, ref, tol, label) -> float:
    """|out - ref| <= tol + tol |ref| everywhere; returns max |out - ref|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if not bool(torch.isfinite(out).all()) or bool((err > tol + tol * ref.abs()).any()):
        raise AssertionError(f"{label}: the two differ, max |d| = {err.max().item():.3g} "
                             f"(tol {tol} abs + rel)")
    return err.max().item()


def check_rows(out, ref, label) -> float:
    """Per query row (the last dim is the head dim): ||out - ref||_2 <=
    ROW_RTOL ||ref||_2 + ROW_ATOL. Returns the worst ||out - ref|| / ||ref||."""
    out, ref = out.float(), ref.float()
    d, r = (out - ref).norm(dim=-1), ref.norm(dim=-1)
    bad = ~torch.isfinite(d) | (d > ROW_RTOL * r + ROW_ATOL)
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{label}: {int(bad.sum())} rows differ, first at flat row {i}: "
                             f"||d|| {d.flatten()[i].item():.4g}, ||ref|| {r.flatten()[i].item():.4g} "
                             f"(limit {ROW_RTOL} rel + {ROW_ATOL})")
    return (d / r.clamp_min(1e-30)).max().item()


def flash_case(case, dtype, dev, seed=0, logit_cap=0.0):
    """(run, ref, label): run() calls the kernel through `ops.mha`; ref is
    its plain version on the same inputs, in the model's layout."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, H, KV, dh, causal, window, cl, dv = flash_dims(case)
    q, k, v = flash_inputs(case, dtype, dev, seed, scale=SOFTCAP_INPUT_SCALE if logit_cap else 1.0)
    kw = dict(causal=causal, window=window, chunk_local=cl, logit_cap=logit_cap)
    # one (batch row, KV head) at a time: a launch's [B,H,S,S] float32
    # scores are 34 GB at llama4-scout's prefill, and softmax holds three
    G = H // KV
    ref = q.new_empty((B, S, H, dv))
    for b in range(B):
        for n in range(KV):
            h = slice(n * G, (n + 1) * G)
            part = _to_bhsd(q[b:b + 1, :, h], k[b:b + 1, :, n:n + 1], v[b:b + 1, :, n:n + 1])
            ref[b:b + 1, :, h] = attention_ref(*part, **kw).transpose(1, 2)
    return lambda: ops.mha(q, k, v, **kw), ref, f"flash {case} {dtype} cap {logit_cap}"


def decode_case(case, dtype, dev, seed=0, valid_slots=None, logit_cap=0.0, pattern=None):
    """(run, ref, label): run() calls the kernel through `ops.decode`; ref
    is its plain version on the same inputs."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_ref

    q, k, v, valid = decode_inputs(case, dtype, dev, seed, valid_slots,
                                   scale=SOFTCAP_INPUT_SCALE if logit_cap else 1.0,
                                   pattern=pattern)
    ref = decode_ref(q, k, v, valid, logit_cap=logit_cap)
    return (lambda: ops.decode(q, k, v, valid, logit_cap=logit_cap), ref,
            f"decode {case} {dtype} cap {logit_cap} {pattern or ''}")


def check_case(run, ref, label, dtype, dev, tight=False):
    """The kernel's output within TOL of its plain version; `tight`: also
    per query row within ROW_RTOL, and a second call gives the same bits.
    Returns max |d|, with `tight` (max |d|, worst row ||d|| / ||ref||)."""
    out = run()
    again = run() if tight else out
    if dev.type == "cuda":
        torch.cuda.synchronize()
    e = check_close(out, ref, TOL[str(dtype)[6:]], label)
    if not tight:
        return e
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    return e, check_rows(out, ref, label)


def check_tight(kind, case, dev, seed=0, logit_cap=0.0, valid_slots=None, pattern=None):
    """bf16 through the kernel against its plain version on the same
    inputs: elementwise within TOL, per row within ROW_RTOL, and a second
    call gives the same bits. Returns (max |d|, worst row ||d|| / ||ref||)."""
    bf16 = torch.bfloat16
    if kind == "flash":
        built = flash_case(case, bf16, dev, seed, logit_cap)
    else:
        built = decode_case(case, bf16, dev, seed, valid_slots, logit_cap, pattern)
    return check_case(*built, bf16, dev, tight=True)


def check_flash(case, dtype, dev, seed=0, logit_cap=0.0) -> float:
    """The kernel (through `ops.mha`) against its plain version."""
    return check_case(*flash_case(case, dtype, dev, seed, logit_cap), dtype, dev)


def check_decode(case, dtype, dev, seed=0, valid_slots=None, logit_cap=0.0,
                 pattern=None) -> float:
    """The kernel (through `ops.decode`) against its plain version."""
    return check_case(*decode_case(case, dtype, dev, seed, valid_slots, logit_cap, pattern),
                      dtype, dev)


def flash_work(case, itemsize):
    """(bytes, flops) of one launch: q, k, v read and out written once;
    2·(dh + dv) flops (QK^T and PV) per (query, key) pair the mask keeps."""
    B, S, H, KV, dh, causal, window, cl, dv = flash_dims(case)
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(S)[None, :]
    keep = torch.ones((S, S), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= (kpos // window == qpos // window) if cl else (kpos > qpos - window)
    pairs = int(keep.sum())
    return (B * S * ((H + KV) * dh + (KV + H) * dv) * itemsize,
            2 * (dh + dv) * B * H * pairs)


def decode_work(valid, H, KV, dh, itemsize):
    """(bytes, flops) of one launch: the valid cache slots' K and V, q, the
    mask and out, each moved once; 4·dh flops per (query head, valid slot).
    Only valid slots count: the output does not depend on the others."""
    n_valid = int(valid.sum())
    B, Sc = valid.shape
    nbytes = 2 * n_valid * KV * dh * itemsize + 2 * B * H * dh * itemsize + B * Sc
    return nbytes, 4 * dh * H * n_valid


def time_flash(case, dev, logit_cap=0.0):
    """(kernel, plain, SDPA) ms per call at one bf16 shape, CUDA events.
    SDPA has no logit cap: with one, its time is None."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as binding
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, H, KV, dh, causal, window, cl, dv = flash_dims(case)
    qt, kt, vt = _to_bhsd(*flash_inputs(case, torch.bfloat16, dev, 1))
    out = qt.new_empty((B, H, S, dv))
    k_ms = cuda_ms(lambda: binding.launch(qt, kt, vt, out, dh**-0.5, causal, window, cl,
                                          logit_cap), 10)
    p_ms = cuda_ms(lambda: attention_ref(qt, kt, vt, causal=causal, window=window,
                                         chunk_local=cl, logit_cap=logit_cap), 3)
    if logit_cap:
        return k_ms, p_ms, None
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                            enable_gqa=True), 10)
    return k_ms, p_ms, lib_ms


def time_flash_kernel(case, dev, iters=10) -> float:
    """The bf16 kernel's ms per launch at one shape, CUDA events."""
    from repro_torch.kernels.flash_attention import flash_attention as binding

    B, S, H, KV, dh, causal, window, cl, dv = flash_dims(case)
    qt, kt, vt = _to_bhsd(*flash_inputs(case, torch.bfloat16, dev, 1))
    out = qt.new_empty((B, H, S, dv))
    return cuda_ms(lambda: binding.launch(qt, kt, vt, out, dh**-0.5, causal, window, cl, 0.0),
                   iters)


def host_us(fn, iters: int) -> float:
    """Mean host microseconds a call over `iters` calls: the time to issue
    them, the device left to catch up afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e6


def time_decode(case, dev, valid_slots=None, logit_cap=0.0):
    """Decode at one bf16 shape, CUDA events: `ms` through the wrapper
    `ops.decode` as the model calls it (checks, split plan, allocation and
    both launches), `bare_ms` the C entry point with its arguments made once
    (`ops.prepare`), `host_us` the wrapper's host time a call, `plain_ms` its
    plain version, `library_ms` one SDPA call (None with a logit cap, which
    SDPA lacks); `work` the inputs' (bytes, flops)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as binding
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_ref

    B, Sc, H, KV, dh = case
    q, k, v, valid = decode_inputs(case, torch.bfloat16, dev, 1, valid_slots)
    call = lambda: ops.decode(q, k, v, valid, logit_cap=logit_cap)  # noqa: E731
    args = ops.prepare(q, k, v, valid, logit_cap)[1]
    t = {"ms": cuda_ms(call, 200), "bare_ms": cuda_ms(lambda: binding.run(args), 200),
         "host_us": host_us(call, 200),
         "plain_ms": cuda_ms(lambda: decode_ref(q, k, v, valid, logit_cap=logit_cap), 50),
         "library_ms": None, "work": decode_work(valid, H, KV, dh, 2)}
    if not logit_cap:
        q4, kt, vt, mask = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), valid[:, None, None]
        t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), 200)
    return t


def sweep_decode_split(cases, dev) -> dict:
    """Prints and returns the decode kernel's bare-entry ms at each
    blocks-an-SM target of DECODE_SPLIT_SWEEP, for each (label, case,
    valid_slots, logit_cap) in bf16."""
    from repro_torch.kernels.decode_attention import decode_attention as binding
    from repro_torch.kernels.decode_attention import ops

    res = {}
    for label, case, slots, cap in cases:
        q, k, v, valid = decode_inputs(case, torch.bfloat16, dev, 1, slots)
        for per_sm in DECODE_SPLIT_SWEEP:
            args = ops.prepare(q, k, v, valid, cap, per_sm)[1]
            res[label, per_sm] = cuda_ms(lambda: binding.run(args), 200)
        print(f"decode split {label} cap {cap:g}: bare ms by blocks an SM ({ops.sm_count(dev)} "
              f"SMs; the wrapper's {ops.BLOCKS_PER_SM}): "
              + ", ".join(f"{n}: {res[label, n]:.4f}" for n in DECODE_SPLIT_SWEEP))
    return res


# ---------------------------------------------------------------------------
# slice 8: flash with a key length of its own, decode over an int8 cache
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, dh) of flash's cross route (non-causal, Sk != Sq):
# seamless-m4t's decoder-over-frames shape (32 tokens over 1,024 frames,
# 16/16 heads of 64) is CROSS_MAIN; the others are ragged edges: Sq below
# one 64-row warpgroup, Sk below and across one 64-key tile, Sq past one
# 128-query block and above Sk, grouped heads, dh 120 and 256
CROSS_CASES = [(2, 5, 37, 4, 2, 64), (1, 63, 64, 2, 1, 64), (2, 70, 65, 4, 4, 120),
               (1, 200, 33, 6, 2, 256), (2, 130, 1000, 8, 2, 128)]
# (B, Sc, H, KV, dh, valid slots or None: random positions) of the int8
# entry: h2o-danube-3-4b's ring after a prefill past its window (every slot
# valid) and at random positions, llama3.2-3b's linear cache, and edges
# (Sc ragged, dh not a multiple of the 16-byte load, G = 20)
INT8_DECODE_CASES = [(8, 4096, 32, 8, 120, 4096), (8, 4096, 32, 8, 120, None),
                     (8, 4096, 24, 8, 128, None), (3, 1000, 6, 2, 34, None),
                     (2, 700, 40, 2, 64, None), (1, 64, 32, 8, 120, 1)]


def cross_inputs(case, dtype, dev, seed):
    """q [B,Sq,H,dh], k/v [B,Sk,KV,dh] in the model's layout."""
    B, Sq, Sk, H, KV, dh = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, Sq, H, dh), dtype, dev, gen), _randn((B, Sk, KV, dh), dtype, dev, gen),
            _randn((B, Sk, KV, dh), dtype, dev, gen))


def cross_case(case, dtype, dev, seed=0):
    """(run, ref, label) of flash's cross route: run() through `ops.mha`
    (causal=False, Sk != Sq), ref its plain version on the same inputs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = cross_inputs(case, dtype, dev, seed)
    ref = attention_ref(*_to_bhsd(q, k, v), causal=False).transpose(1, 2)
    return lambda: ops.mha(q, k, v, causal=False), ref, f"flash cross {case} {dtype}"


def check_cross(case, dtype, dev, seed=0, tight=False):
    """The cross route against its plain version: TOL; `tight` (bf16): per
    query row and bit for bit over two calls as `check_tight`."""
    return check_case(*cross_case(case, dtype, dev, seed), dtype, dev, tight=tight)


def cross_work(case, itemsize):
    """(bytes, flops) of one cross launch: q, k, v read and out written
    once; 4·dh flops per (query, key) pair (every pair: no mask)."""
    B, Sq, Sk, H, KV, dh = case
    return (B * (2 * Sq * H + 2 * Sk * KV) * dh * itemsize, 4 * dh * B * H * Sq * Sk)


CROSS_ROUNDS = 5  # the cross route and SDPA timed in turns this many times


def time_cross(case, dev, rounds=CROSS_ROUNDS):
    """(kernel, plain, SDPA) ms per call of the cross route in bf16. The
    kernel and SDPA (on the same tensors, the same function) are timed in
    turns `rounds` times as eager calls (CUDA events: at ~0.03 ms a call
    both are near their host issue), each round printed, and as captured
    graphs (device time, no host issue), which the record takes; the
    faster of the two is named by each measure."""
    import statistics

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as binding
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, Sq, Sk, H, KV, dh = case
    qt, kt, vt = _to_bhsd(*cross_inputs(case, torch.bfloat16, dev, 1))
    out = qt.new_empty((B, H, Sq, dh))
    kern = lambda: binding.launch(qt, kt, vt, out, dh**-0.5, False, 0, False, 0.0)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)  # noqa: E731
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kern, 50))
        ls.append(cuda_ms(sdpa, 50))
    k_med, l_med = statistics.median(ks), statistics.median(ls)
    k_dev, l_dev = graph_ms(kern), graph_ms(sdpa)
    faster = lambda a, b: "the kernel" if a < b else "SDPA"  # noqa: E731
    print(f"flash cross {case} bf16, {rounds} rounds in turns (ms a call, CUDA events): kernel "
          f"{[round(x, 5) for x in ks]}, SDPA {[round(x, 5) for x in ls]}; medians {k_med:.5f} "
          f"vs {l_med:.5f}: {faster(k_med, l_med)} faster; as captured graphs (device time) "
          f"{k_dev:.5f} vs {l_dev:.5f}: {faster(k_dev, l_dev)} faster")
    return k_dev, cuda_ms(lambda: attention_ref(qt, kt, vt, causal=False), 10), l_dev


def int8_inputs(case, dtype, dev, seed):
    """q [B,H,dh] in `dtype`, an int8 cache [B,Sc,KV,dh] with its float32
    scales [B,Sc,KV] (bf16 K/V drawn and quantized as the model quantizes
    them), valid [B,Sc] (`decode_inputs`' positions)."""
    from repro_torch.models.attention import _kv_quantize

    B, Sc, H, KV, dh, slots = case
    q, k, v, valid = decode_inputs((B, Sc, H, KV, dh), torch.bfloat16, dev, seed, slots)
    (k8, ks), (v8, vs) = _kv_quantize(k), _kv_quantize(v)
    return q.to(dtype), k8, v8, ks, vs, valid


def check_decode_int8(case, dev, dtype=torch.bfloat16, seed=0):
    """The int8 entry (through `ops.decode`) against its plain version
    (`_kv_dequantize`, then the plain decode) at TOL, bf16 also per query
    row; a second call gives the same bits; and bit for bit what the same
    dtype's entry gives on the dequantized cache (on the card only: after
    the load it is the same arithmetic). Returns (max |d|, worst row or
    None)."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_int8_ref, kv_dequantize

    q, k8, v8, ks, vs, valid = int8_inputs(case, dtype, dev, seed)
    label = f"decode int8 {case} {dtype}"
    run = lambda: ops.decode(q, k8, v8, valid, k_scale=ks, v_scale=vs)  # noqa: E731
    ref = decode_int8_ref(q, k8, v8, ks, vs, valid)
    e = check_case(run, ref, label, dtype, dev, tight=dtype == torch.bfloat16)
    e, rows = e if isinstance(e, tuple) else (e, None)
    if dev.type == "cuda":
        deq = ops.decode(q, kv_dequantize(k8, ks, dtype), kv_dequantize(v8, vs, dtype), valid)
        if not torch.equal(run(), deq):
            raise AssertionError(f"{label}: not bit for bit the {dtype} entry on the "
                                 f"dequantized cache")
    return e, rows


def int8_work(valid, H, KV, dh, itemsize):
    """(bytes, operations) of one int8 decode call: the valid slots' int8 K
    and V and their float32 scales, q, the mask and out, each moved once;
    4·dh flops per (query head, valid slot) and one multiply per K and V
    element dequantized."""
    n_valid = int(valid.sum())
    B, Sc = valid.shape
    nbytes = 2 * n_valid * KV * (dh + 4) + 2 * B * H * dh * itemsize + B * Sc
    return nbytes, 4 * dh * H * n_valid + 2 * n_valid * KV * dh


def time_decode_int8(case, dev):
    """The int8 entry at one shape (bf16 q), CUDA events: `ms` through the
    wrapper as the model calls it, `plain_ms` its plain version, `bf16_ms`
    the bf16 entry on the dequantized cache (the same arithmetic, twice the
    bytes); `work` the inputs' (bytes, operations). No PyTorch call reads an
    int8 cache: no library time."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_int8_ref, kv_dequantize

    B, Sc, H, KV, dh, _ = case
    q, k8, v8, ks, vs, valid = int8_inputs(case, torch.bfloat16, dev, 1)
    kd, vd = kv_dequantize(k8, ks, q.dtype), kv_dequantize(v8, vs, q.dtype)
    return {"ms": cuda_ms(lambda: ops.decode(q, k8, v8, valid, k_scale=ks, v_scale=vs), 200),
            "plain_ms": cuda_ms(lambda: decode_int8_ref(q, k8, v8, ks, vs, valid), 20),
            "bf16_ms": cuda_ms(lambda: ops.decode(q, kd, vd, valid), 200),
            "work": int8_work(valid, H, KV, dh, 2)}


def prefill_decode(cfg, params, tokens, steps, cache_len, dev):
    """Prefill tokens[:, :-steps], then decode the last `steps` tokens one
    by one (positions continue the prompt). Returns the logits of each call
    as float32 on the CPU: [last prefill position, decode 1, ..., decode n]."""
    from repro_torch.models import model

    tokens = tokens.to(dev)
    n = tokens.shape[1]
    prefill = model.make_prefill_step(cfg, cache_len)
    decode = model.make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": tokens[:, : n - steps]})
    out = [logits.float().cpu()]
    for t in range(n - steps, n):
        pos = torch.full((tokens.shape[0],), t, dtype=torch.int32, device=dev)
        logits, cache = decode(params, tokens[:, t], pos, cache)
        out.append(logits.float().cpu())
    return out


def router(cfg, params, dev, policy, n_requests=ROUTER_REQUESTS):
    """GeoServingEngine over the launcher's three pods on `dev`, a decode
    step of `params` a generation (None: no model). Returns (summary,
    stats, seconds, admits)."""
    from repro_torch.serving.engine import GeoServingEngine, PodConfig, synthetic_workload

    pods = [PodConfig(rtt_us=0, n_slots=12), PodConfig(rtt_us=30_000, n_slots=12),
            PodConfig(rtt_us=100_000, n_slots=12)]
    t0 = time.perf_counter()
    eng = GeoServingEngine(cfg, pods, policy=policy, run_model=params is not None, device=dev,
                           params=params)
    reqs = synthetic_workload(n_requests, len(pods), rate_per_s=ROUTER_RATE)
    for r in reqs:
        eng.submit(r)
    res = eng.run(until_us=120_000_000)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res, eng.stats, time.perf_counter() - t0, len(reqs)


LM_KERNELS = ("decode_attention", "flash_attention", "mlstm_chunk", "rglru_scan")
STRICT_BUILDS = ("decode_attention", "flash_attention", "mlstm_chunk")  # no stack, no spill


def timed_build(name):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(name, verbose=True)
    return time.perf_counter() - t0


def serving_phases(dev, builds):
    """Phases 6-9. Returns the kernel records of decode_attention and
    flash_attention (phase 6 also prints the recurrent kernels' builds)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.geo_schedule import ops as geo_ops
    from repro_torch.models import model, stack
    from repro_torch.models.schema import init_params, param_count

    bf16 = torch.bfloat16
    phase("6 build decode_attention, flash_attention, mlstm_chunk, rglru_scan")
    for name, fut in builds.items():
        secs = fut.result()
        _build.load(name)
        print_build(name, secs, " (nvcc started in phase 2)", strict=name in STRICT_BUILDS)

    phase("7 attention kernels vs plain versions on the card")
    cfg = serve_cfg()
    f_main, d_main = launch_shapes(cfg, PREFILL_B, PREFILL_S, SERVE_MAX_SEQ)
    _, d_router = launch_shapes(cfg, 1, 1, ROUTER_CACHE)
    err_f = err_d = 0.0
    # bf16 also per query row and bit for bit over two calls (check_tight)
    for dt in (torch.float32, bf16):
        for kind, cases in (("flash", FLASH_CASES + WIDE_FLASH_CASES),
                            ("decode", DECODE_CASES + WIDE_DECODE_CASES)):
            for i, case in enumerate(cases):
                rows = ""
                if dt == bf16:
                    e, r = check_tight(kind, case, dev, seed=i)
                    rows = f", worst row ||d||/||ref|| {r:.3g}; two calls equal"
                else:
                    e = (check_flash if kind == "flash" else check_decode)(case, dt, dev, seed=i)
                if kind == "flash":
                    err_f = max(err_f, e)
                else:
                    err_d = max(err_d, e)
                print(f"{kind:6s} {str(case):44s} {str(dt)[6:]:8s} max |d| {e:.3g}{rows}")
    # the serving path's own shapes in float32 too: there the kernel and its
    # plain version differ only by summation order, so 2e-5 sees a dropped
    # chunk or a wrong merge that bf16 rounding of the output would hide
    for dt in (torch.float32, bf16):
        e = (check_flash(f_main, dt, dev), check_decode(d_main, dt, dev),
             check_decode(d_router, dt, dev, valid_slots=1))
        err_f, err_d = max(err_f, e[0]), max(err_d, e[1], e[2])
        print(f"main shapes {str(dt)[6:]} (tol {TOL[str(dt)[6:]]} abs + rel): max |d| flash "
              f"{f_main} {e[0]:.3g}, decode {d_main} {e[1]:.3g}, router decode {d_router} "
              f"(slot 0 valid) {e[2]:.3g}")
    # the edge cases of the redesigned kernels in float32 at 2e-5 (in bf16
    # through check_tight below)
    for i, (case, cap) in enumerate(EXTRA_FLASH_CASES):
        e = check_flash(case, torch.float32, dev, seed=i, logit_cap=cap)
        err_f = max(err_f, e)
        print(f"flash  {str(case):44s} float32  cap {cap:g} max |d| {e:.3g}")
    for i, (case, pat) in enumerate(EXTRA_DECODE_CASES):
        e = check_decode(case, torch.float32, dev, seed=i, pattern=pat)
        err_d = max(err_d, e)
        print(f"decode {str(case):44s} float32  {pat or 'random pos'} max |d| {e:.3g}")
    # bf16 at TOL, per query row and bit for bit over two calls, at the
    # serving shapes and the edge cases
    tight = [("flash", f_main, 0.0, None, None), ("decode", d_main, 0.0, None, None),
             ("decode", d_router, 0.0, 1, None)]
    tight += [("flash", c, cap, None, None) for c, cap in EXTRA_FLASH_CASES]
    tight += [("decode", c, 0.0, None, pat) for c, pat in EXTRA_DECODE_CASES]
    for kind, case, cap, slots, pat in tight:
        e, r = check_tight(kind, case, dev, logit_cap=cap, valid_slots=slots, pattern=pat)
        if kind == "flash":
            err_f = max(err_f, e)
        else:
            err_d = max(err_d, e)
        print(f"rows {kind:6s} {str(case):40s} bf16 cap {cap:g} {pat or ''}: max |d| {e:.3g}, "
              f"worst row ||d||/||ref|| {r:.3g} (limit {ROW_RTOL}); two calls equal")
    f_ms, f_plain, f_lib = time_flash(f_main, dev)
    f_work = flash_work(f_main, 2)
    f_bound, f_by = bound(*f_work, BF16_TENSOR_OPS_PER_S)
    print(f"flash {f_main} bf16: kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, SDPA "
          f"{f_lib:.4f} ms; {f_work[0]} bytes, {f_work[1]:.4g} flops, bound {f_bound:.4g} ms "
          f"({f_by}); {f_work[1] / f_ms / 1e9:.2f} TFLOP/s")
    d_t = time_decode(d_main, dev)
    d_work = d_t["work"]
    d_bound, d_by = bound(*d_work, BF16_TENSOR_OPS_PER_S)
    full = 2 * d_main[0] * d_main[1] * d_main[3] * d_main[4] * 2
    print(f"decode {d_main} bf16: kernel {d_t['ms']:.4f} ms through the wrapper (host "
          f"{d_t['host_us']:.1f} us a call), {d_t['bare_ms']:.4f} ms bare entry point; plain "
          f"{d_t['plain_ms']:.4f} ms, SDPA {d_t['library_ms']:.4f} ms; {d_work[0]} bytes (valid "
          f"slots), {d_work[1]} flops, bound {d_bound:.4g} ms ({d_by}), "
          f"{d_work[0] / d_t['bare_ms'] / 1e9:.3f} TB/s bare; every slot's K+V: {full} bytes, "
          f"{full / HBM_BYTES_PER_S * 1e3:.4g} ms")
    r_t = time_decode(d_router, dev, valid_slots=1)
    print(f"decode {d_router} bf16 (router): kernel {r_t['ms']:.4f} ms through the wrapper "
          f"(host {r_t['host_us']:.1f} us a call), {r_t['bare_ms']:.4f} ms bare; plain "
          f"{r_t['plain_ms']:.4f} ms, SDPA {r_t['library_ms']:.4f} ms, bound "
          f"{bound(*r_t['work'], BF16_TENSOR_OPS_PER_S)[0]:.4g} ms")
    sweep_decode_split([(f"{d_main}, random positions", d_main, None, 0.0),
                        (f"{d_main}, every slot valid", d_main, d_main[1], 0.0)], dev)

    phase("8 model at full width, 2 layers: GPU vs CPU")
    cfg2 = serve_cfg(n_layers=2)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    w_cpu = init_params(stack.build_schema(cfg2), torch.Generator().manual_seed(0), cpu)
    params = {cpu: stack.cast_weights(cfg2, w_cpu),
              dev: stack.cast_weights(cfg2, {k: x.to(dev) for k, x in w_cpu.items()})}
    del w_cpu
    print(f"{cfg2.name} x {cfg2.n_layers} layers: weights drawn on the CPU and copied in "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg2.vocab, (2, 132)))
    logits = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        logits[d] = prefill_decode(cfg2, params[d], tokens, 4, 160, d)
        print(f"{d.type}: prefill 2 x 128 + 4 decode steps in {time.perf_counter() - t0:.2f} s")
    for i, (a, b) in enumerate(zip(logits[dev], logits[cpu])):
        e = check_close(a, b, LOGIT_TOL, f"logits of call {i}")
        print(f"{'prefill' if i == 0 else f'decode {i}'} logits: max |gpu - cpu| {e:.4g}")
    for pol in ("geotp", "fcfs"):
        runs = {d: router(cfg2, params[d], d, pol) for d in (dev, cpu)}
        (rg, sg, tg, _), (rc, sc, tc, _) = runs[dev], runs[cpu]
        if rg != rc or sg.lat_us != sc.lat_us or sg.occ_us != sc.occ_us:
            raise AssertionError(f"router {pol}: GPU {rg} != CPU {rc}")
        print(f"router {pol}: equal on both devices ({tg:.2f} s GPU, {tc:.2f} s CPU): {rg}")
    del params, logits

    phase("9 serving path at full width: llama3.2-3b, 28 layers")
    print(f"CUT: max_seq {SERVE_MAX_SEQ} (registry: 32768) for the pods' slot caches")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    schema = stack.build_schema(cfg)
    params = stack.cast_weights(cfg, init_params(schema, gen, dev))
    torch.cuda.synchronize()
    print(f"{param_count(schema)} parameters drawn on the card (float32) and cast to bf16 "
          f"copies in {time.perf_counter() - t0:.2f} s")
    L = cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S + DECODE_STEPS), generator=gen,
                           device=dev, dtype=torch.int32)
    prefill = model.make_prefill_step(cfg, SERVE_MAX_SEQ)
    decode = model.make_decode_step(cfg)
    fl_ops.reset_launches()
    dec_ops.decode.launches = geo_ops.geo_schedule.launches = 0
    pre_s = []
    for _ in range(2):  # the first call warms the libraries' plans for these shapes
        cache = None
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens[:, :PREFILL_S]})
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    if fl_ops.mha.launches != 2 * L or fl_ops.mha.launches_by_dtype["bfloat16"] != 2 * L:
        raise AssertionError(f"flash launches {fl_ops.mha.launches_by_dtype} != {L} bf16 (the "
                             f"tensor-core kernel) per prefill x 2")
    finite = bool(torch.isfinite(logits.float()).all())
    step_s = []
    for t in range(PREFILL_S, PREFILL_S + DECODE_STEPS):
        pos = torch.full((PREFILL_B,), t, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        logits, cache = decode(params, tokens[:, t], pos, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits.float()).all())
    if dec_ops.decode.launches != L * DECODE_STEPS:
        raise AssertionError(f"decode launches {dec_ops.decode.launches} != {L} x "
                             f"{DECODE_STEPS} steps")
    if not finite:
        raise AssertionError("non-finite logits on the serving path")
    n_pre = PREFILL_B * PREFILL_S
    dec_mean = sum(step_s) / len(step_s)
    dec_rest = sum(step_s[1:]) / (len(step_s) - 1)
    print(f"prefill {PREFILL_B} x {PREFILL_S}: {pre_s[0] * 1e3:.2f} ms (first), "
          f"{pre_s[1] * 1e3:.2f} ms (second) = {n_pre / pre_s[1]:.1f} tokens/s")
    print(f"decode B={PREFILL_B} over a {SERVE_MAX_SEQ}-slot cache: {dec_mean * 1e3:.3f} ms a "
          f"step (mean of {DECODE_STEPS}; {dec_rest * 1e3:.3f} without the first) = "
          f"{PREFILL_B / dec_mean:.1f} tokens/s; launches flash {fl_ops.mha.launches} "
          f"(by dtype {fl_ops.mha.launches_by_dtype}), "
          f"decode {dec_ops.decode.launches}; logits finite")
    del cache, logits
    flash_launches = fl_ops.mha.launches
    decode_launches = dec_ops.decode.launches
    res = {}
    for pol in ("geotp", "fcfs"):
        dec_ops.decode.launches = geo_ops.geo_schedule.launches = 0
        res[pol], stats, secs, admits = router(cfg, params, dev, pol)
        gens = len(stats.occ_us)
        if dec_ops.decode.launches != L * gens:
            raise AssertionError(f"router {pol}: decode launches {dec_ops.decode.launches} "
                                 f"!= {L} x {gens} generations")
        want_geo = admits if pol == "geotp" else 0
        if geo_ops.geo_schedule.launches != want_geo:
            raise AssertionError(f"router {pol}: geo_schedule launches "
                                 f"{geo_ops.geo_schedule.launches} != {want_geo}")
        decode_launches += dec_ops.decode.launches
        print(f"router {pol}: {res[pol]} in {secs:.2f} s; {gens} generations, decode launches "
              f"{dec_ops.decode.launches}, geo_schedule launches "
              f"{geo_ops.geo_schedule.launches}")
    if not res["geotp"]["avg_latency_ms"] < res["fcfs"]["avg_latency_ms"]:
        raise AssertionError(f"geotp avg latency not below fcfs: {res}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/decode_attention.py:64",
         "launches": decode_launches, "max_abs_err": err_d, "ms": d_t["ms"],
         "plain_ms": d_t["plain_ms"], "bound_ms": d_bound, "bound_by": d_by,
         "library_ms": d_t["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
         "launches": flash_launches, "max_abs_err": err_f, "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib},
    ]


# ---------------------------------------------------------------------------
# slice 3: the recurrent mixers (xlstm-350m, recurrentgemma-9b)
# ---------------------------------------------------------------------------

XLSTM_ARCH, RG_ARCH = "xlstm-350m", "recurrentgemma-9b"
XLSTM_B, XLSTM_S = 8, 2048  # phase 11: prefill 8 x 2048, then DECODE_STEPS at B = 8
RG_B, RG_S = 4, 4096  # phase 12: prefill 4 x 4096 (past the 2048 window), then decode at B = 4
RECURRENT_TOL = 0.08  # bf16 recurrent stacks (tests/models/test_archs.py)
# a float32 serving-shape check: kernel and plain version differ only by
# summation order (mLSTM) or by an ulp of expf that the decay damps (RG-LRU),
# so the reference's float32 TOL (a tenth of the cases' limits) sees a
# dropped key block, a wrong rescale or a skipped step
SERVE_F32_TOL = 2e-5
SLICE_BYTES = 4 << 30  # `draw_weights` draws a stacked tensor layer by layer past 4 GiB of float32


def recurrent_shapes(xl, rg):
    """The serving shapes of phases 11-12: mlstm (B, H, S, dh) of xlstm's
    prefill, rglru_scan (B, S, E) of recurrentgemma's, and its swa layers'
    flash and decode launches."""
    m_main = (XLSTM_B, xl.n_heads, XLSTM_S, xl.d_model // xl.n_heads)
    r_main = (RG_B, RG_S, int(rg.rnn_scale * rg.d_model))
    f_rg, d_rg = launch_shapes(rg, RG_B, RG_S, RG_S + DECODE_STEPS, mixer="swa")
    return m_main, r_main, f_rg, d_rg


def mlstm_inputs(case, dtype, dev, seed):
    """The reference kernel test's distribution: q, k, v ~ N(0, 1) [B,H,S,dh],
    logi ~ N(0, 0.25), logf = log sigmoid(N(2, 1)) [B,H,S] float32."""
    B, H, S, dh = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (_randn((B, H, S, dh), dtype, dev, gen) for _ in range(3))
    logi = 0.5 * torch.randn((B, H, S), generator=gen, device=dev)
    logf = torch.nn.functional.logsigmoid(torch.randn((B, H, S), generator=gen, device=dev) + 2)
    return q, k, v, logi, logf


def rglru_inputs(case, dtype, dev, seed):
    """log_a = -0.05 exp(N(0, 1)) float32 and b = sqrt(1 - a^2) N(0, 1) in
    `dtype`, [B,S,E] (the reference kernel test's)."""
    B, S, E = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    log_a = -torch.exp(torch.randn((B, S, E), generator=gen, device=dev)) * 0.05
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1 - a * a, 0, 1)) * torch.randn((B, S, E), generator=gen, device=dev)
    return log_a, b.to(dtype)


def check_mlstm(case, dtype, dev, seed=0, tol=None, tight=False):
    """The kernel (through `ops.mlstm`) against its plain version, at the
    reference test's 10 x TOL unless `tol` is given; returns max |d|.
    `tight`: also per query row within ROW_RTOL, and a second call gives
    the same bits; returns (max |d|, worst row ||d|| / ||ref||)."""
    from repro_torch.kernels.mlstm import ops
    from repro_torch.kernels.mlstm.ref import mlstm_ref

    x = mlstm_inputs(case, dtype, dev, seed)
    out = ops.mlstm(*x)
    again = ops.mlstm(*x) if tight else out
    ref = mlstm_ref(*x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    label = f"mlstm {case} {dtype}"
    e = check_close(out, ref, tol or 10 * TOL[str(dtype)[6:]], label)
    if not tight:
        return e
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    return e, check_rows(out, ref, label)


def check_rglru(case, dtype, dev, seed=0, tol=None) -> float:
    """The kernel (through `ops.rglru_scan`) against its plain version, at
    the reference test's 5 x TOL unless `tol` is given."""
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import rglru_ref

    x = rglru_inputs(case, dtype, dev, seed)
    out, ref = ops.rglru_scan(*x), rglru_ref(*x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return check_close(out, ref, tol or 5 * TOL[str(dtype)[6:]], f"rglru {case} {dtype}")


def rglru_op_inputs(case, dtype, dev, seed):
    """log_a as `rglru_inputs`, gated x ~ N(0, 1) in `dtype` [B,S,E] and a
    carry h0 ~ N(0, 1) float32 [B,E]."""
    B, S, E = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    log_a = -torch.exp(torch.randn((B, S, E), generator=gen, device=dev)) * 0.05
    gx = torch.randn((B, S, E), generator=gen, device=dev).to(dtype)
    return log_a, gx, torch.randn((B, E), generator=gen, device=dev)


def check_rglru_op(case, dtype, dev, seed=0, tol=None, h0=False) -> float:
    """The fused op (`ops.rglru`, b formed in the kernel) against the plain
    composition (`gated_input`, then `rglru_ref`), from the carry h0 if
    `h0`, at the reference test's 5 x TOL unless `tol` is given."""
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import gated_input, rglru_ref

    log_a, gx, h = rglru_op_inputs(case, dtype, dev, seed)
    h = h if h0 else None
    out = ops.rglru(log_a, gx, h0=h)
    ref = rglru_ref(log_a, gated_input(log_a, gx), h)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    label = f"rglru op {case} {dtype}{' from h0' if h0 else ''}"
    return check_close(out, ref, tol or 5 * TOL[str(dtype)[6:]], label)


def rglru_resets(case, dev):
    """(log_a, last): log_a = -inf at scattered (b, t, e), 0 elsewhere, and
    the last reset at or before each t (-1 before the first), [B,S,E]."""
    B, S, E = case
    t = torch.arange(S, device=dev)[None, :, None]
    e = torch.arange(E, device=dev)[None, None, :]
    b = torch.arange(B, device=dev)[:, None, None]
    mask = (7 * t + 3 * e + 5 * b) % 97 == 0
    log_a = torch.where(mask, float("-inf"), 0.0)
    last = torch.cummax(torch.where(mask, t, -1), dim=1).values
    return log_a, last


def check_rglru_exact(case, dtype, dev) -> None:
    """Exact carry checks (torch.equal), whose every step is exact in
    float32. The contract: log_a = 0 (a = 1) and b = 1 give h_t = t + 1
    (exact below 2^24), and log_a = -inf (a = 0) at a reset r restarts h at
    b = 1: h_t = t - r + 1. The fused op from h0: log_a = 0 makes b =
    0 * gx, so h_t = h0; log_a = -inf makes b = gx, so h_t = gx_r."""
    from repro_torch.kernels.rglru import ops

    log_a, last = rglru_resets(case, dev)
    t = torch.arange(case[1], device=dev)[None, :, None]
    want = (t + 1 - last.clamp(min=0)).float().to(dtype)
    out = ops.rglru_scan(log_a, torch.ones(case, dtype=dtype, device=dev))
    if not torch.equal(out, want):
        bad = (out != want).nonzero()[0].tolist()
        raise AssertionError(f"rglru_scan exact carry {case} {dtype}: first difference at "
                             f"{bad}: {out[tuple(bad)].item()} != {want[tuple(bad)].item()}")
    _, gx, h0 = rglru_op_inputs(case, dtype, dev, 7)
    held = gx.float().gather(1, last.clamp(min=0))
    want = torch.where(last >= 0, held, h0[:, None, :]).to(dtype)
    out = ops.rglru(log_a, gx, h0=h0)
    if not torch.equal(out, want):
        bad = (out != want).nonzero()[0].tolist()
        raise AssertionError(f"rglru exact carry from h0 {case} {dtype}: first difference at "
                             f"{bad}: {out[tuple(bad)].item()} != {want[tuple(bad)].item()}")


def check_rglru_repeat(case, dtype, dev) -> None:
    """Two calls of each entry on the same inputs give the same bits."""
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import gated_input

    log_a, gx, h0 = rglru_op_inputs(case, dtype, dev, 3)
    b = gated_input(log_a, gx)
    for name, fn in (("rglru_scan", lambda: ops.rglru_scan(log_a, b)),
                     ("rglru", lambda: ops.rglru(log_a, gx, h0=h0))):
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name} {case} {dtype}: two calls on the same inputs differ")


def rglru_phase(r_main, dev) -> float:
    """Phase 10's RG-LRU checks: the contract on RGLRU_CASES at 5 x TOL, the
    fused op against the plain composition there (with and without h0),
    h0 at RGLRU_H0_S, both dtypes; the exact carry checks; both entries at
    the serving shape `r_main` in float32 at SERVE_F32_TOL and twice bit
    for bit. Returns the largest |d|."""
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for i, case in enumerate(RGLRU_CASES):
            e = check_rglru(case, dt, dev, seed=i)
            eo = max(check_rglru_op(case, dt, dev, seed=i, h0=h) for h in (False, True))
            err = max(err, e, eo)
            print(f"rglru  {str(case):30s} {str(dt)[6:]:8s} max |d| {e:.3g}; fused op {eo:.3g}")
        for i, S in enumerate(RGLRU_H0_S):
            case = (r_main[0], S, r_main[2])
            e = check_rglru_op(case, dt, dev, seed=10 + i, h0=True)
            err = max(err, e)
            print(f"rglru op from h0 {str(case):20s} {str(dt)[6:]:8s} max |d| {e:.3g}")
        for case in RGLRU_EXACT_CASES + [r_main]:
            check_rglru_exact(case, dt, dev)
        print(f"rglru exact carry {str(dt)[6:]}: {RGLRU_EXACT_CASES + [r_main]} equal bit for bit")
    e = check_rglru(r_main, torch.float32, dev, tol=SERVE_F32_TOL)
    eo = check_rglru_op(r_main, torch.float32, dev, tol=SERVE_F32_TOL)
    err = max(err, e, eo)
    for dt in (torch.float32, torch.bfloat16):
        check_rglru_repeat(r_main, dt, dev)
    print(f"rglru {r_main} float32 (tol {SERVE_F32_TOL} abs + rel): contract max |d| {e:.3g}, "
          f"fused op {eo:.3g}; both entries, both dtypes: two calls equal")
    return err


def time_rglru(case, dev) -> dict:
    """CUDA-event ms at the serving shape in float32, in turns (each route
    twice: A B C D E E D C B A): the contract `rglru_scan` on a formed b,
    the fused op `rglru`, the route before the fusion (`gated_input` eager,
    then the contract), the plain version, and `torch.add(log_a, gx)` into
    a third tensor, which moves the same bytes (a yardstick of the rate an
    elementwise pass reaches, not the same function); then decode's step
    (S = 1 from h0) through the fused op and as the eager update it
    replaced."""
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import gated_input, rglru_ref

    log_a, gx, h0 = rglru_op_inputs(case, torch.float32, dev, 1)
    b = gated_input(log_a, gx)
    out = torch.empty_like(gx)
    routes = {"scan": (lambda: ops.rglru_scan(log_a, b), 20),
              "fused": (lambda: ops.rglru(log_a, gx), 20),
              "eager_b_then_scan": (lambda: ops.rglru_scan(log_a, gated_input(log_a, gx)), 20),
              "plain": (lambda: rglru_ref(log_a, b), 2),
              "same_bytes_add": (lambda: torch.add(log_a, gx, out=out), 20)}
    runs = {k: [] for k in routes}
    for k in list(routes) + list(routes)[::-1]:
        runs[k].append(cuda_ms(*routes[k]))
    del b, gx, out
    la1, gx1, _ = rglru_op_inputs((case[0], 1, case[2]), torch.float32, dev, 2)

    def eager_step():
        a = torch.exp(la1[:, 0])
        return a * h0 + torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * gx1[:, 0]

    for k, fn in (("decode_fused", lambda: ops.rglru(la1, gx1, h0=h0)),
                  ("decode_eager", eager_step)):
        runs[k] = [cuda_ms(fn, 200)]
    return {k: sum(v) / len(v) for k, v in runs.items()} | {"runs": runs}


def mlstm_work(case, itemsize):
    """(bytes, flops) of one launch: q, k, v read and out written once, F
    and logi read once; 4·dh flops (q.k and w.v) per (query, key <= query)
    pair."""
    B, H, S, dh = case
    return 4 * B * H * S * dh * itemsize + 2 * B * H * S * 4, 4 * dh * B * H * S * (S + 1) // 2


def rglru_work(case, itemsize):
    """(bytes, flops) of one launch: log_a (float32) and b read, h written
    once; exp, mul and add per element."""
    B, S, E = case
    return B * S * E * (4 + 2 * itemsize), 3 * B * S * E


def time_mlstm(case, dev):
    """(kernel, plain) ms per call at the serving shape, CUDA events: in
    bf16 (the serving path's type: the tensor-core kernel) and in float32."""
    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.mlstm.ref import mlstm_ref

    xm = mlstm_inputs(case, torch.float32, dev, 1)
    xb = mlstm_inputs(case, torch.bfloat16, dev, 1)
    return {"mlstm_bf16": (cuda_ms(lambda: m_ops.mlstm(*xb), 20),
                           cuda_ms(lambda: mlstm_ref(*xb), 3)),
            "mlstm": (cuda_ms(lambda: m_ops.mlstm(*xm), 10), cuda_ms(lambda: mlstm_ref(*xm), 3))}


def draw_weights(cfg, gen, dev):
    """`init_params` then `cast_weights`, tensor by tensor in the schema's
    sorted order (the same draws as one `init_params` call), so the float32
    copies of all the weights never exist at once (37.6 GB at
    recurrentgemma-9b). A stacked tensor whose float32 copy is larger than
    SLICE_BYTES is drawn and cast one layer group at a time into its cast
    tensor (mixtral-8x7b's stacked experts are 30 GB each in float32 at 16
    layers; no earlier phase has one, and its draws differ from one
    `init_params` call)."""
    from repro_torch.models import stack
    from repro_torch.models.schema import init_params

    schema = stack.build_schema(cfg)
    out = {}
    for name in sorted(schema):
        spec = schema[name]
        if spec.axes[0] != "layers" or 4 * int(np.prod(spec.shape)) <= SLICE_BYTES:
            out.update(stack.cast_weights(cfg, init_params({name: spec}, gen, dev)))
            continue
        one = dataclasses.replace(spec, shape=spec.shape[1:], axes=spec.axes[1:])
        for g in range(spec.shape[0]):
            part = stack.cast_weights(cfg, init_params({name: one}, gen, dev))[name]
            if g == 0:
                out[name] = part.new_empty(spec.shape)
            out[name][g] = part
    return out


def _leaf_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_items(tree[k], f"{prefix}.{k}")
        else:
            yield f"{prefix}.{k}", tree[k]


def _copy_tree(dst, src):
    for (_, d), (_, s) in zip(_leaf_items(dst), _leaf_items(src)):
        d.copy_(s)


def front_batch(cfg, tokens, n_front, gen, dev):
    """The prefill batch of `tokens` [B,S]: a vision model's `n_front` patch
    embeddings ahead of them, an encoder-decoder's `n_front` frames with
    them as its decoder tokens (stub frontends: bf16 N(0, 1) rows of
    `frontend_dim`, drawn from `gen` on `dev`). Returns (batch, the decode
    positions' offset: the patches a vision prompt holds before its
    tokens)."""
    B = tokens.shape[0]
    if cfg.frontend == "none":
        return {"tokens": tokens}, 0
    rows = _randn((B, n_front, cfg.frontend_dim), torch.bfloat16, dev, gen)
    if cfg.is_encdec:
        return {"frames": rows, "dec_tokens": tokens}, 0
    return {"patches": rows, "tokens": tokens}, n_front


def layerwise(cfg, params, tokens, steps, cache_len, dev, tol=RECURRENT_TOL, front=None):
    """GPU vs CPU layer by layer: prefill tokens[:, :-steps], then decode
    the last `steps` tokens, every layer run on both devices from the CPU's
    input (hidden state, and for decode the CPU's cache of that layer), so
    the comparison holds each layer's kernels and products on the same
    inputs: a free-running bf16 xLSTM stack amplifies an ulp of difference
    between two GEMMs past any fixed limit within a few layers. Checks every
    layer's output, every cache leaf and the logits within `tol` abs + rel;
    returns the largest |gpu - cpu| of each kind.

    `front` (CPU tensors): a vision model's {"patches"}, embedded ahead of
    the tokens; an encoder-decoder's {"frames"}, whose encoder layers are
    held the same way, and whose decoder layers on both devices take the
    CPU's encoder output as their memory.

    A MoE layer's routing is read on both devices and held by
    `routelog.compare` with the CPU's as the reference: a token whose
    experts differ must be a near tie of the CPU's gates (cuBLAS and the CPU
    round the router's bf16 product or its input differently there), one
    whose kept assignments alone differ must follow such a flip in its row.
    Those tokens are counted, never compared (`worst["flips"]` and
    `worst["kept_only"]` of `worst["decisions"]`; more than
    routelog.MAX_FLIPS of them fails), and every other token's output is
    held at `tol`."""
    from repro_torch.models import routelog, stack
    from repro_torch.models.layers import embed_lookup, rmsnorm

    cpu = torch.device("cpu")
    devs = (cpu, dev)
    B, n = tokens.shape
    S = n - steps
    front = front or {}
    worst = {"hidden": 0.0, "cache": 0.0, "logits": 0.0, "flips": 0, "kept_only": 0,
             "decisions": 0}
    log = routelog.RouteLog()

    def compare(kind, a, b, label):
        a = a.cpu()
        if kind == "hidden" and log.calls:  # a MoE layer, run on the CPU first
            if len(log.calls) != 2:
                raise AssertionError(f"{label}: {len(log.calls)} MoE routings on two devices")
            r_cpu, r_dev = log.calls
            log.calls = []
            agree, flips, kept_only = routelog.compare(
                (r_cpu.topi, r_cpu.kept, r_cpu.gates), (r_dev.topi.cpu(), r_dev.kept.cpu()), label)
            worst["decisions"] += agree.numel()
            worst["flips"] += flips
            worst["kept_only"] += kept_only
            a, b = a[agree], b[agree]
        worst[kind] = max(worst[kind], check_close(a, b, tol, label))

    def head(x):
        out = {d: stack._head(params[d], rmsnorm(x.to(d), params[d]["final_ln"])) for d in devs}
        return out[dev], out[cpu]

    enc_out = None
    with log:
        if cfg.is_encdec:
            x, pos_e = stack._embed_inputs(cfg, params[cpu], {"frames": front["frames"]})
            for g in range(cfg.n_enc_layers):
                out = {d: stack._encoder_layer(cfg, stack._layer(params[d], "eblk0", g), x.to(d),
                                               pos_e.to(d)) for d in devs}
                compare("hidden", out[dev], out[cpu], f"encoder eblk0[{g}] output")
                x = out[cpu]
            out = {d: rmsnorm(x.to(d), params[d]["enc_final_ln"]) for d in devs}
            compare("hidden", out[dev], out[cpu], "encoder output")
            enc_out = out[cpu]
            front = {}
        x, positions = stack._embed_inputs(cfg, params[cpu], {**front, "tokens": tokens[:, :S]})
        offset = positions.shape[1] - S  # a vision prompt's patches
        enc_len = 0 if enc_out is None else enc_out.shape[1]
        caches = {d: stack.init_cache(cfg, B, cache_len, d, enc_len=enc_len) for d in devs}
        mem = {d: None if enc_out is None else enc_out.to(d) for d in devs}
        for pfx, g, mixer, fk in stack._layers(cfg):
            out = {d: stack._prefill_layer(cfg, stack._layer(params[d], pfx, g), pfx, mixer, fk,
                                           x.to(d), positions.to(d),
                                           stack._layer_cache(caches[d], pfx, g), cache_len,
                                           mem[d])
                   for d in devs}
            compare("hidden", out[dev], out[cpu], f"prefill {pfx}[{g}] {mixer} output")
            x = out[cpu]
        compare("logits", *head(x[:, -1]), "prefill logits")
        for (name, a), (_, b) in zip(_leaf_items(caches[dev]), _leaf_items(caches[cpu])):
            compare("cache", a, b, f"prefill cache {name}")
        for t in range(S, n):
            x = embed_lookup(params[cpu]["embed"], tokens[:, t], stack.ACT_DTYPE)[:, None]
            pos = torch.full((B,), offset + t, dtype=torch.int32)
            for pfx, g, mixer, fk in stack._layers(cfg):
                views = {d: stack._layer_cache(caches[d], pfx, g) for d in devs}
                _copy_tree(views[dev], views[cpu])  # the GPU's layer starts from the CPU's state
                out = {d: stack._decode_layer(cfg, stack._layer(params[d], pfx, g), pfx, mixer, fk,
                                              x.to(d), pos.to(d), views[d]) for d in devs}
                compare("hidden", out[dev], out[cpu], f"decode {t} {pfx}[{g}] {mixer} output")
                for (name, a), (_, b) in zip(_leaf_items(views[dev]), _leaf_items(views[cpu])):
                    compare("cache", a, b, f"decode {t} {pfx}[{g}] cache {name}")
                x = out[cpu]
            compare("logits", *head(x[:, 0]), f"decode {t} logits")
    differ = worst["flips"] + worst["kept_only"]
    if differ > routelog.MAX_FLIPS * max(worst["decisions"], 1):
        raise AssertionError(f"{differ} of {worst['decisions']} MoE routing decisions differ "
                             f"between the devices (limit {routelog.MAX_FLIPS} of them)")
    return worst


def model_phase(arch, n_layers_cpu, prompt, dev, serve, *, full=None, tol=RECURRENT_TOL,
                with_router=True, front=0, cache_len=None, cpu_cfg=None):
    """GPU vs CPU at `n_layers_cpu` layers (one period plus the tail; or
    `cpu_cfg`), layer by layer within `tol`, the weights drawn on the card
    and copied to the CPU; then the model at full width (`full`, a cut of
    the registry's config where it must be): prefill `serve` = (B, S)
    twice, DECODE_STEPS decode steps, and (`with_router`) the router geotp
    vs fcfs over pods of `full`. A frontend's model takes `front` patches
    (vision, ahead of the S tokens) or frames (the encoder's, S decoder
    tokens) in the full-width run, FRONT_CPU in the check's;
    `cache_len` defaults to the prompt plus the decode steps. Returns the
    measured numbers and the kernel launch counts of the full-width run
    (counts set to 0 just before it and read just after), and the MoE
    assignments the first prefill dropped (its routing recorded; the second
    prefill, the timed one, runs without the recorder)."""
    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.geo_schedule import ops as geo_ops
    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.rglru import ops as r_ops
    from repro_torch.models import model, routelog, stack
    from repro_torch.models.schema import param_count

    cpu = torch.device("cpu")
    full = full or registry.get(arch)
    cfg_s = cpu_cfg or dataclasses.replace(full, n_layers=n_layers_cpu)
    t0 = time.perf_counter()
    params = {dev: draw_weights(cfg_s, torch.Generator(device=dev).manual_seed(0), dev)}
    params[cpu] = {k: x.cpu() for k, x in params[dev].items()}
    print(f"{arch} x {n_layers_cpu} layers at full width ({param_count(stack.build_schema(cfg_s))} "
          f"parameters): weights drawn on the card and copied to the CPU in "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, full.vocab, (2, prompt + 4)))
    n_cpu = FRONT_CPU if full.frontend != "none" else 0
    batch_cpu, off_cpu = front_batch(full, tokens, n_cpu, torch.Generator().manual_seed(1), cpu)
    batch_cpu.pop("tokens", None), batch_cpu.pop("dec_tokens", None)
    t0 = time.perf_counter()
    worst = layerwise(cfg_s, params, tokens, 4, off_cpu + prompt + 8, dev, tol, front=batch_cpu)
    flips = (f"; MoE routing decisions that differ between cuBLAS and the CPU, of "
             f"{worst['decisions']}: {worst['flips']} expert flips at near ties, "
             f"{worst['kept_only']} kept / dropped only (those tokens' outputs not compared)"
             if worst["decisions"] else "")
    fed = (f" after {n_cpu} patch embeddings" if full.frontend == "vision" else
           f" over {n_cpu} frames" if full.is_encdec else "")
    print(f"layer by layer, prefill 2 x {prompt}{fed} + 4 decode steps "
          f"({time.perf_counter() - t0:.2f} s): max |gpu - cpu| hidden {worst['hidden']:.4g}, "
          f"cache leaves {worst['cache']:.4g}, "
          f"logits {worst['logits']:.4g} (limit {tol} abs + rel){flips}")
    del params

    B, S = serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = draw_weights(full, gen, dev)
    torch.cuda.synchronize()
    n_par = param_count(stack.build_schema(full))
    n_bytes = sum(x.numel() * x.element_size() for x in params.values())
    print(f"{arch} at full width, {full.n_layers} layers: {n_par} parameters ({n_bytes} bytes) "
          f"drawn on the card and cast tensor by tensor in {time.perf_counter() - t0:.2f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    tokens = torch.randint(0, full.vocab, (B, S + DECODE_STEPS), generator=gen, device=dev,
                           dtype=torch.int32)
    batch, offset = front_batch(full, tokens[:, :S], front, gen, dev)
    cache_len = cache_len or offset + S + DECODE_STEPS
    prefill = model.make_prefill_step(full, cache_len)
    decode = model.make_decode_step(full)
    counters = (m_ops.mlstm, r_ops.rglru, r_ops.rglru_scan, fl_ops.mha, dec_ops.decode)
    for c in counters:
        c.launches = 0
    fl_ops.reset_launches()
    m_ops.reset_launches()
    dec_ops.reset_launches()
    pre_s, log = [], routelog.RouteLog()
    # the first call warms the libraries' plans for these shapes and records
    # the routing; the second is timed
    for record in (log, contextlib.nullcontext()):
        cache = None
        t0 = time.perf_counter()
        with record:
            logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    dropped = log.dropped()
    del log
    per_prefill = {c.__name__: c.launches // 2 for c in counters}
    cross = fl_ops.mha.cross_launches
    del batch
    finite = bool(torch.isfinite(logits.float()).all())
    step_s = []
    before = {c.__name__: c.launches for c in counters}
    for t in range(S, S + DECODE_STEPS):
        pos = torch.full((B,), offset + t, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        logits, cache = decode(params, tokens[:, t], pos, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits.float()).all())
    if not finite:
        raise AssertionError(f"{arch}: non-finite logits on the serving path")
    per_step = {c.__name__: (c.launches - before[c.__name__]) / DECODE_STEPS for c in counters}
    dec_mean = sum(step_s) / len(step_s)
    moe = (f"; MoE assignments dropped past the capacity {dropped} of "
           f"{B * S * full.top_k * full.n_layers} (capacity factor {full.capacity_factor})"
           if full.n_experts else "")
    n_tok = B * (front + S)  # a vision prompt's patches or the encoder's frames count too
    what = (f" ({front} patches + {S} tokens a row)" if full.frontend == "vision" else
            f" ({front} frames + {S} decoder tokens a row)" if full.is_encdec else "")
    print(f"prefill {B} x {S}{what}: {pre_s[0] * 1e3:.2f} ms (first), {pre_s[1] * 1e3:.2f} ms "
          f"(second) = {n_tok / pre_s[1]:.1f} tokens/s; launches per prefill {per_prefill} (cross "
          f"route {cross // 2}){moe}")
    print(f"decode B={B}: {dec_mean * 1e3:.3f} ms a step (mean of {DECODE_STEPS}; "
          f"{sum(step_s[1:]) / (len(step_s) - 1) * 1e3:.3f} without the first) = "
          f"{B / dec_mean:.1f} tokens/s; launches per step {per_step}; logits finite")
    del cache, logits
    res = {}
    # an encoder-decoder's router step decodes over its pods' empty memory:
    # the cross step is zeros without a launch (counted as an empty call)
    per_gen = dict(per_step)
    if full.is_encdec:
        per_gen["decode"] -= full.n_layers
    for pol in ("geotp", "fcfs") if with_router else ():
        before = {c.__name__: c.launches for c in counters}
        empty = dec_ops.decode.empty_calls
        geo_ops.geo_schedule.launches = 0
        res[pol], stats, secs, admits = router(full, params, dev, pol)
        gens = len(stats.occ_us)
        want_geo = admits if pol == "geotp" else 0
        if geo_ops.geo_schedule.launches != want_geo:
            raise AssertionError(f"router {pol}: geo_schedule launches "
                                 f"{geo_ops.geo_schedule.launches} != {want_geo}")
        used = {c.__name__: c.launches - before[c.__name__] for c in counters}
        if any(used[k] != n * gens for k, n in per_gen.items()):
            raise AssertionError(f"router {pol}: launches {used} != {per_gen} x {gens} "
                                 f"generations")
        empty = dec_ops.decode.empty_calls - empty
        if empty != (full.n_layers * gens if full.is_encdec else 0):
            raise AssertionError(f"router {pol}: {empty} decode calls over an empty memory")
        # the router's clock is simulated: its summary is the CPU's without a model
        want = router(registry.reduced(arch), None, cpu, pol)[0]
        if res[pol] != want:
            raise AssertionError(f"router {pol}: {res[pol]} != the CPU's {want}")
        print(f"router {pol}: {res[pol]} in {secs:.2f} s (equal to the CPU's); {gens} "
              f"generations, launches {used}, geo_schedule {geo_ops.geo_schedule.launches}")
    if res and not res["geotp"]["avg_latency_ms"] < res["fcfs"]["avg_latency_ms"]:
        raise AssertionError(f"{arch}: geotp avg latency not below fcfs: {res}")
    launches = {c.__name__: c.launches for c in counters}
    if fl_ops.mha.launches_by_dtype["bfloat16"] != fl_ops.mha.launches:
        raise AssertionError(f"{arch}: flash launches by dtype {fl_ops.mha.launches_by_dtype}: "
                             f"every one must be bf16 (the tensor-core kernel)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"flash launches by dtype {fl_ops.mha.launches_by_dtype}; peak device memory "
          f"{peak:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return {"per_prefill": per_prefill, "per_step": per_step, "launches": launches,
            "cross": fl_ops.mha.cross_launches,
            "decode_by_cache": dict(dec_ops.decode.launches_by_cache),
            "mlstm_by_dtype": dict(m_ops.mlstm.launches_by_dtype),
            "prefill_s": pre_s[1], "step_s": dec_mean, "worst": worst, "dropped": dropped,
            "tokens_per_s": n_tok / pre_s[1],
            "router": res, "peak_gib": peak}


def recurrent_phases(dev, records):
    """Phases 10-12. Adds the mlstm_chunk and rglru_scan records to
    `records` (by name) and folds the softcapped checks and the
    recurrentgemma launches into the attention kernels' records."""
    from repro_torch.configs import registry

    phase("10 recurrent kernels and the attention kernels' logit cap vs plain versions")
    errs = {"mlstm_chunk": 0.0, "flash_attention": 0.0, "decode_attention": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        for i, case in enumerate(MLSTM_CASES):
            rows = ""
            if dt == torch.bfloat16:  # the tensor-core kernel: per row, bit for bit
                e, r = check_mlstm(case, dt, dev, seed=i, tight=True)
                rows = f", worst row ||d||/||ref|| {r:.3g}; two calls equal"
            else:
                e = check_mlstm(case, dt, dev, seed=i)
            errs["mlstm_chunk"] = max(errs["mlstm_chunk"], e)
            print(f"mlstm  {str(case):30s} {str(dt)[6:]:8s} max |d| {e:.3g}{rows}")
        for cap in SOFTCAPS:
            ef = max(check_flash(c, dt, dev, seed=i, logit_cap=cap)
                     for i, c in enumerate(FLASH_CASES))
            ed = max(check_decode(c, dt, dev, seed=i, logit_cap=cap)
                     for i, c in enumerate(DECODE_CASES))
            errs["flash_attention"] = max(errs["flash_attention"], ef)
            errs["decode_attention"] = max(errs["decode_attention"], ed)
            print(f"cap {cap:4.0f} {str(dt)[6:]:8s}: FLASH_CASES max |d| {ef:.3g}, DECODE_CASES "
                  f"max |d| {ed:.3g}")
    xl, rg = registry.get(XLSTM_ARCH), registry.get(RG_ARCH)
    m_main, r_main, f_rg, d_rg = recurrent_shapes(xl, rg)
    errs["rglru_scan"] = rglru_phase(r_main, dev)
    # the serving shapes: mlstm in float32 at SERVE_F32_TOL and in bf16; the
    # capped attention in both dtypes
    em = check_mlstm(m_main, torch.float32, dev, tol=SERVE_F32_TOL)
    emb, rmb = check_mlstm(m_main, torch.bfloat16, dev, tol=TOL["bfloat16"], tight=True)
    errs["mlstm_chunk"] = max(errs["mlstm_chunk"], em, emb)
    print(f"mlstm {m_main} float32 (tol {SERVE_F32_TOL} abs + rel): max |d| {em:.3g}")
    print(f"mlstm {m_main} bf16 (tol {TOL['bfloat16']} abs + rel): max |d| {emb:.3g}, worst row "
          f"||d||/||ref|| {rmb:.3g} (limit {ROW_RTOL}); two calls equal")
    for dt in (torch.float32, torch.bfloat16):
        ef = check_flash(f_rg, dt, dev, logit_cap=rg.attn_softcap)
        ed = check_decode(d_rg, dt, dev, logit_cap=rg.attn_softcap)
        errs["flash_attention"] = max(errs["flash_attention"], ef)
        errs["decode_attention"] = max(errs["decode_attention"], ed)
        print(f"{RG_ARCH} shapes {str(dt)[6:]}, cap {rg.attn_softcap}: flash {f_rg} max |d| "
              f"{ef:.3g}, decode {d_rg} max |d| {ed:.3g}")
    # bf16 per query row and bit for bit over two calls; decode over random
    # positions and over the full ring (the path's state after the prefill)
    for kind, case, slots in (("flash", f_rg, None), ("decode", d_rg, None),
                              ("decode", d_rg, d_rg[1])):
        e, r = check_tight(kind, case, dev, logit_cap=rg.attn_softcap, valid_slots=slots)
        name = "flash_attention" if kind == "flash" else "decode_attention"
        errs[name] = max(errs[name], e)
        print(f"rows {kind:6s} {str(case):40s} bf16 cap {rg.attn_softcap} "
              f"{'full ring' if slots else ''}: max |d| {e:.3g}, worst row ||d||/||ref|| "
              f"{r:.3g} (limit {ROW_RTOL}); two calls equal")
    t = time_mlstm(m_main, dev)
    tr = time_rglru(r_main, dev)
    m_work, r_work = mlstm_work(m_main, 4), rglru_work(r_main, 4)
    mb_work = mlstm_work(m_main, 2)
    m_bound, m_by = bound(*m_work, FP32_OPS_PER_S)
    mb_bound, mb_by = bound(*mb_work, BF16_TENSOR_OPS_PER_S)
    r_bound, r_by = bound(*r_work, FP32_OPS_PER_S)
    print(f"mlstm {m_main} bf16 (tensor cores): kernel {t['mlstm_bf16'][0]:.4f} ms, plain "
          f"{t['mlstm_bf16'][1]:.4f} ms; {mb_work[0]} bytes, {mb_work[1]:.4g} flops, bound "
          f"{mb_bound:.4g} ms ({mb_by}, bf16 tensor cores; bytes "
          f"{mb_work[0] / HBM_BYTES_PER_S * 1e3:.4g} ms); "
          f"{mb_work[1] / t['mlstm_bf16'][0] / 1e9:.2f} TFLOP/s")
    print(f"mlstm {m_main} float32: kernel {t['mlstm'][0]:.4f} ms, plain {t['mlstm'][1]:.4f} ms; "
          f"{m_work[0]} bytes, {m_work[1]:.4g} flops, bound {m_bound:.4g} ms ({m_by}, float32 on "
          f"the CUDA cores; {m_work[1] / TF32_TENSOR_OPS_PER_S * 1e3:.4g} ms on TF32 tensor "
          f"cores); "
          f"{m_work[1] / t['mlstm'][0] / 1e9:.2f} TFLOP/s")
    print(f"rglru {r_main} float32, {r_work[0]} bytes, bound {r_bound:.4g} ms ({r_by}); ms a "
          f"call (each route's two runs {tr['runs']}):")
    for k, label in (("scan", "the contract rglru_scan (b given)"),
                     ("fused", "the fused op rglru (b formed in the kernel)"),
                     ("eager_b_then_scan", "eager b formation, then rglru_scan"),
                     ("plain", "plain version (a host loop over t)"),
                     ("same_bytes_add", "torch.add(log_a, gx): the same bytes, yardstick")):
        print(f"  {label}: {tr[k]:.4f} ms = {tr[k] / r_bound:.3f} x bound, "
              f"{r_work[0] / tr[k] / 1e9:.3f} TB/s")
    print(f"rglru decode step {(r_main[0], 1, r_main[2])} from h0: fused op "
          f"{tr['decode_fused']:.5f} ms (one launch), the eager update it replaced "
          f"{tr['decode_eager']:.5f} ms (8 launches)")
    sweep_decode_split([(f"{d_rg}, full ring", d_rg, d_rg[1], rg.attn_softcap)], dev)
    f_t = time_flash(f_rg, dev, rg.attn_softcap)
    # every ring slot is valid after the 4096-token prefill, as on the path
    d_t = time_decode(d_rg, dev, valid_slots=d_rg[1], logit_cap=rg.attn_softcap)
    f_work, d_work = flash_work(f_rg, 2), d_t["work"]
    print(f"flash {f_rg} bf16 cap {rg.attn_softcap}: kernel {f_t[0]:.4f} ms, plain "
          f"{f_t[1]:.4f} ms; "
          f"{f_work[1]:.4g} flops, bound {bound(*f_work, BF16_TENSOR_OPS_PER_S)[0]:.4g} ms; "
          f"{f_work[1] / f_t[0] / 1e9:.2f} TFLOP/s")
    print(f"decode {d_rg} bf16 cap {rg.attn_softcap}: kernel {d_t['ms']:.4f} ms through the "
          f"wrapper (host {d_t['host_us']:.1f} us a call), {d_t['bare_ms']:.4f} ms bare; plain "
          f"{d_t['plain_ms']:.4f} ms; {d_work[0]} bytes (valid slots), bound "
          f"{bound(*d_work, BF16_TENSOR_OPS_PER_S)[0]:.4g} ms; "
          f"{d_work[0] / d_t['bare_ms'] / 1e9:.3f} TB/s bare")

    phase(f"11 {XLSTM_ARCH}: GPU vs CPU at 8 layers, then full width")
    xs = model_phase(XLSTM_ARCH, len(xl.pattern), 128, dev, (XLSTM_B, XLSTM_S))
    n_mlstm = sum(m == "mlstm" for m, _ in xl.pattern) * xl.n_groups
    if (xs["per_prefill"]["mlstm"] != n_mlstm
            or xs["per_prefill"]["rglru_scan"] + xs["per_prefill"]["rglru"] != 0):
        raise AssertionError(f"{XLSTM_ARCH}: launches per prefill {xs['per_prefill']}, want "
                             f"{n_mlstm} mlstm")
    if xs["mlstm_by_dtype"]["bfloat16"] != xs["launches"]["mlstm"]:
        raise AssertionError(f"{XLSTM_ARCH}: mlstm launches by dtype {xs['mlstm_by_dtype']}: "
                             f"every one must be bf16 (the tensor-core kernel)")
    print(f"mlstm launches by dtype {xs['mlstm_by_dtype']}")

    phase(f"12 {RG_ARCH}: GPU vs CPU at 5 layers, then full width")
    rs = model_phase(RG_ARCH, len(rg.pattern) + len(rg.tail), 128, dev, (RG_B, RG_S))
    mixers = [m for m, _ in rg.pattern] * rg.n_groups + [m for m, _ in rg.tail]
    # the RG-LRU layers run the fused op in prefill and decode, never the bare contract
    want_pre = {"rglru": mixers.count("rglru"), "rglru_scan": 0, "mha": mixers.count("swa")}
    want_step = {"rglru": mixers.count("rglru"), "rglru_scan": 0, "decode": mixers.count("swa")}
    if (any(rs["per_prefill"][k] != v for k, v in want_pre.items())
            or any(rs["per_step"][k] != v for k, v in want_step.items())):
        raise AssertionError(f"{RG_ARCH}: launches per prefill {rs['per_prefill']} (want "
                             f"{want_pre}), per decode step {rs['per_step']} (want {want_step})")
    print(f"{RG_ARCH}: prefill {RG_B} x {RG_S} {rs['prefill_s'] * 1e3:.2f} ms, decode "
          f"{rs['step_s'] * 1e3:.3f} ms a step; RG-LRU launches {want_pre['rglru']} a prefill "
          f"and {want_step['rglru']} a decode step (fused op)")

    by_name = {r["name"]: r for r in records}
    for name, err in errs.items():
        if name in by_name:
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name["flash_attention"]["launches"] += rs["launches"]["mha"]
    by_name["decode_attention"]["launches"] += rs["launches"]["decode"]
    records += [
        {"name": "mlstm_chunk", "route": "cuda", "source": "src/repro_torch/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/mlstm/mlstm.py:94", "launches": xs["launches"]["mlstm"],
         "max_abs_err": errs["mlstm_chunk"], "ms": t["mlstm_bf16"][0],
         "plain_ms": t["mlstm_bf16"][1], "bound_ms": mb_bound, "bound_by": mb_by,
         "library_ms": None},
        {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru/rglru.py:52",
         "launches": rs["launches"]["rglru"] + rs["launches"]["rglru_scan"],
         "max_abs_err": errs["rglru_scan"], "ms": tr["scan"], "plain_ms": tr["plain"],
         "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": None},
    ]
    return records


# ---------------------------------------------------------------------------
# slice 7: the MoE and MLA families (mixtral-8x7b, llama4-scout, minicpm3-4b)
# ---------------------------------------------------------------------------

MIXTRAL_ARCH, LLAMA4_ARCH, MINICPM_ARCH = "mixtral-8x7b", "llama4-scout-17b-a16e", "minicpm3-4b"
# depth cuts: the full models do not fit one card (mixtral's experts alone are
# ~45 B parameters, ~90 GB in bf16; llama4's ~218 GB)
MIXTRAL_LAYERS = 16  # of 32: ~2.86 GB a layer in bf16, ~46 GB of weights
LLAMA4_LAYERS = 12  # of 48: three whole periods (3 cla + 1 NoPE gqa), ~54 GB
MIXTRAL_B, MIXTRAL_S = 4, 4608  # past the 4096 window: the ring wraps, the band skip runs
LLAMA4_B, LLAMA4_S = 2, 10240  # past the 8192 chunk: chunk-local masking bites
MINICPM_B, MINICPM_S = 8, 2048
MINICPM_MAX_SEQ = 4096  # cut from 32768 for the pods' caches, as llama's
MOE_CPU_PROMPT = 128  # the GPU-vs-CPU period's prompt (2 x 128, then 4 decode steps)
MLA_SOFTCAPS = (0.0, 50.0)


def mla_flash_phase(dev) -> tuple:
    """Phase 13: flash with V heads narrower than its Q/K heads against the
    plain version: MLA_FLASH_CASES in both dtypes with and without a cap
    (bf16 per row and bit for bit), minicpm3-4b's prefill launch in float32
    at TOL and bf16 per row; times there. Returns (max |d|, the timing)."""
    from repro_torch.configs import registry

    phase("13 flash_attention with V heads narrower than Q/K (MLA) vs plain version")
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for i, case in enumerate(MLA_FLASH_CASES):
            for cap in MLA_SOFTCAPS:
                rows = ""
                if dt == torch.bfloat16:
                    e, r = check_tight("flash", case, dev, seed=i, logit_cap=cap)
                    rows = f", worst row ||d||/||ref|| {r:.3g}; two calls equal"
                else:
                    e = check_flash(case, dt, dev, seed=i, logit_cap=cap)
                err = max(err, e)
                print(f"flash  {str(case):50s} {str(dt)[6:]:8s} cap {cap:g} max |d| {e:.3g}{rows}")
    mini = registry.get(MINICPM_ARCH)
    f_mla, _ = launch_shapes(mini, MINICPM_B, MINICPM_S, MINICPM_S + DECODE_STEPS)
    e32 = check_flash(f_mla, torch.float32, dev)
    e16, r16 = check_tight("flash", f_mla, dev)
    err = max(err, e32, e16)
    print(f"{MINICPM_ARCH} prefill shape {f_mla}: float32 max |d| {e32:.3g} (tol "
          f"{TOL['float32']}), bf16 max |d| {e16:.3g}, worst row ||d||/||ref|| {r16:.3g} (limit "
          f"{ROW_RTOL}); two calls equal")
    k_ms, p_ms, lib_ms = time_flash(f_mla, dev)
    work = flash_work(f_mla, 2)
    b_ms, b_by = bound(*work, BF16_TENSOR_OPS_PER_S)
    print(f"flash {f_mla} bf16 (dh {f_mla[4]}, dv {f_mla[8]}): kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, SDPA on the same tensors {lib_ms:.4f} ms; {work[0]} bytes, "
          f"{work[1]:.4g} flops, bound {b_ms:.4g} ms ({b_by}); {work[1] / k_ms / 1e9:.2f} TFLOP/s")
    return err, {"case": f_mla, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                 "bound_ms": b_ms, "bound_by": b_by}


def want_launches(cfg) -> tuple:
    """(per prefill, per decode step) launches of flash and decode that the
    layer pattern implies: one flash a gqa / swa / cla / mla layer, one
    decode a gqa / swa / cla layer (MLA's decode is plain products); an
    encoder-decoder adds one flash an encoder layer and, in every decoder
    layer, a cross-attention: one flash a prefill, one decode a step."""
    mixers = [m for m, _ in cfg.pattern] * cfg.n_groups + [m for m, _ in cfg.tail]
    attn = sum(m in ("gqa", "swa", "cla") for m in mixers)
    cross = cfg.n_layers if cfg.is_encdec else 0
    none = {"mlstm": 0, "rglru": 0, "rglru_scan": 0}
    return ({"mha": attn + mixers.count("mla") + cfg.n_enc_layers + cross, "decode": 0, **none},
            {"mha": 0, "decode": attn + cross, **none})


def first_decode_valid(mixer, S, Sc) -> int:
    """Valid slots of a decode launch at position S over an Sc-slot cache:
    the slots <= S of a linear cache or a swa ring, those of S's chunk in
    a cla ring (`attention.gqa_decode`'s mask)."""
    return (S % Sc if mixer == "cla" else min(S, Sc - 1)) + 1


def path_shape_checks(full, serve, dev, with_router, front=0, cache_len=None) -> tuple:
    """The attention kernels against their plain versions at the shapes the
    full-width run gives them, for each gqa / swa / cla mixer of the pattern
    (MLA's prefill launch is phase 13's; its decode is plain products):
    flash at the prefill, decode over the cache at the first decode step
    (its valid slots: a full swa ring past the window, a cla ring's
    current chunk, a linear cache up to the position) and over random
    positions; with the router, its B = 1 decode over ROUTER_CACHE slots
    (slot 0 valid). float32 at TOL (there kernel and plain version differ
    only by summation order), bf16 at TOL, per query row and bit for bit
    over two calls. A vision model's prefill holds `front` patches ahead of
    the S tokens; `cache_len` defaults to the prompt plus DECODE_STEPS (an
    encoder-decoder's encoder and cross shapes are phase 17's). Returns max
    |d| of (flash, decode)."""
    B, S = serve
    if full.frontend == "vision":
        S += front
    cases = []
    for mixer in dict.fromkeys(m for m, _ in full.pattern):
        if mixer not in ("gqa", "swa", "cla"):  # MLA's prefill launch: phase 13
            continue
        f, d = launch_shapes(full, B, S, cache_len or S + DECODE_STEPS, mixer=mixer)
        cases += [("flash", f, None, mixer),
                  ("decode", d, first_decode_valid(mixer, S, d[1]), mixer),
                  ("decode", d, None, mixer)]
        if with_router:
            cases.append(("decode", launch_shapes(full, 1, 1, ROUTER_CACHE, mixer=mixer)[1], 1,
                          f"{mixer}, router"))
    err = {"flash": 0.0, "decode": 0.0}
    for kind, case, slots, label in cases:
        if kind == "flash":
            e32 = check_flash(case, torch.float32, dev)
        else:
            e32 = check_decode(case, torch.float32, dev, valid_slots=slots)
        e16, r16 = check_tight(kind, case, dev, valid_slots=slots)
        err[kind] = max(err[kind], e32, e16)
        valid = "" if kind == "flash" else f", {slots or 'random'} valid slots"
        print(f"path shape {kind:6s} {str(case):44s} ({label}{valid}): float32 max |d| {e32:.3g} "
              f"(tol {TOL['float32']}), bf16 max |d| {e16:.3g}, worst row ||d||/||ref|| "
              f"{r16:.3g} (limit {ROW_RTOL}); two calls equal")
    return err["flash"], err["decode"]


def serve_phase(num, arch, full, serve, dev, with_router=True, cut=None, **kw):
    """Phases 14-16, 18-19: the attention kernels at the path's shapes, GPU
    vs CPU over one period at full width, then `full` at (B, S) = `serve`,
    then (`with_router`) the router; `kw` goes to model_phase (a frontend's
    `front`, `cache_len`, `cpu_cfg`). Checks the launches against the layer
    pattern's. Returns model_phase's record with the shape checks' max |d|
    under "err"."""
    phase(f"{num} {arch}: attention at the path's shapes, GPU vs CPU over one period at full "
          f"width, then {full.n_layers} layers")
    for line in cut or ():
        print(f"CUT: {line}")
    err = path_shape_checks(full, serve, dev, with_router, kw.get("front", 0),
                            kw.get("cache_len"))
    res = model_phase(arch, full.period + len(full.tail), MOE_CPU_PROMPT, dev, serve, full=full,
                      tol=LOGIT_TOL, with_router=with_router, **kw)
    pre, step = want_launches(full)
    if (any(res["per_prefill"][k] != v for k, v in pre.items())
            or any(res["per_step"][k] != v for k, v in step.items())):
        raise AssertionError(f"{arch}: launches per prefill {res['per_prefill']} (want {pre}), "
                             f"per decode step {res['per_step']} (want {step})")
    B, S = serve
    print(f"{arch}: prefill {B} x {S} {res['prefill_s'] * 1e3:.2f} ms = "
          f"{res['tokens_per_s']:.1f} tokens/s, decode {res['step_s'] * 1e3:.3f} ms a step; "
          f"flash {pre['mha']} a prefill, decode {step['decode']} a step (the pattern's); peak "
          f"device memory {res['peak_gib']:.2f} GiB")
    return dict(res, err=err)


def moe_mla_phases(dev, records):
    """Phases 13-16. Folds the MLA flash checks and the new paths' flash
    and decode launches into the attention kernels' records."""
    from repro_torch.configs import registry

    err_f, mla_t = mla_flash_phase(dev)
    runs = {}
    reg = registry.get(MIXTRAL_ARCH)
    mx = dataclasses.replace(reg, n_layers=MIXTRAL_LAYERS)
    runs[MIXTRAL_ARCH] = serve_phase(14, MIXTRAL_ARCH, mx, (MIXTRAL_B, MIXTRAL_S), dev, cut=[
        f"n_layers {mx.n_layers} (registry: {reg.n_layers}): {reg.n_layers} layers of 8 experts "
        f"are ~90 GB of bf16 weights; the router's pods hold {mx.n_layers} layers too"])
    reg = registry.get(LLAMA4_ARCH)
    l4 = dataclasses.replace(reg, n_layers=LLAMA4_LAYERS)
    runs[LLAMA4_ARCH] = serve_phase(15, LLAMA4_ARCH, l4, (LLAMA4_B, LLAMA4_S), dev,
                                    with_router=False, cut=[
        f"n_layers {l4.n_layers} (registry: {reg.n_layers}), three whole periods: "
        f"{reg.n_layers} layers of 16 experts are ~218 GB of bf16 weights; no router phase "
        f"(its pods' linear NoPE caches would not fit beside the weights)"])
    reg = registry.get(MINICPM_ARCH)
    mini = dataclasses.replace(reg, max_seq=MINICPM_MAX_SEQ)
    runs[MINICPM_ARCH] = serve_phase(16, MINICPM_ARCH, mini, (MINICPM_B, MINICPM_S), dev, cut=[
        f"max_seq {mini.max_seq} (registry: {reg.max_seq}) for the router's pods' caches, as "
        f"llama's"])
    by_name = {r["name"]: r for r in records}
    fl, dec = by_name["flash_attention"], by_name["decode_attention"]
    fl["max_abs_err"] = max(fl["max_abs_err"], err_f, *(r["err"][0] for r in runs.values()))
    dec["max_abs_err"] = max(dec["max_abs_err"], *(r["err"][1] for r in runs.values()))
    for res in runs.values():
        fl["launches"] += res["launches"]["mha"]
        dec["launches"] += res["launches"]["decode"]
    return records, runs, mla_t


# ---------------------------------------------------------------------------
# slice 8: internvl2-26b (vision frontend), seamless-m4t-large-v2
# (encoder-decoder, cross-attention), the int8 KV cache
# ---------------------------------------------------------------------------

INTERNVL_ARCH, SEAMLESS_ARCH, H2O_ARCH = "internvl2-26b", "seamless-m4t-large-v2", "h2o-danube-3-4b"
# InternVL2's dynamic resolution: 4 tiles of 448^2 and a thumbnail at 256
# tokens each = 1,280 patch embeddings, then 768 text tokens: S = 2,048
INTERNVL_B, INTERNVL_P, INTERNVL_T, INTERNVL_CACHE = 4, 1280, 768, 4096
INTERNVL_MAX_SEQ = 2048  # the router's pods: 3 x 12 slots x 48 layers at 2,048 = 14.5 GB
# ~20 s of speech at the stacked-fbank rate: 1,024 frames of 160; 32 decoder tokens
SEAMLESS_B, SEAMLESS_FRAMES, SEAMLESS_DEC, SEAMLESS_CACHE = 8, 1024, 32, 256
SEAMLESS_MAX_SEQ = 4096  # the router's pods, as llama's
H2O_B, H2O_S, INT8_STEPS = 8, 4608, 16  # past the 4,096 window: the ring wraps
FRONT_CPU = 64  # patches / frames of the GPU-vs-CPU checks (phases 18a, 19a)
INT8_REL = 0.05  # tests/models/test_int8_cache.py: decode logits, relative to their largest
CROSS_MAIN = (SEAMLESS_B, SEAMLESS_DEC, SEAMLESS_FRAMES, 16, 16, 64)  # seamless's cross launch


def slice8_kernel_phase(dev) -> dict:
    """Phase 17: flash's cross route on CROSS_CASES and CROSS_MAIN, flash at
    seamless's encoder shape (non-causal) and h2o-danube-3-4b's prefill
    (dh 120, swa 4096), decode at seamless's cross step (every slot valid),
    the int8 entry on INT8_DECODE_CASES (h2o's ring and llama's linear
    cache at B = 8 over 4,096 slots), each in float32 at TOL and in bf16 at
    TOL, per query row and bit for bit over two calls, the int8 entry also
    bit for bit the bf16 entry on the dequantized cache; decode over an
    empty memory (zeros, no launch); then CUDA-event times against the
    bounds. Returns the max |d| and timings."""
    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attention import ops as dec_ops

    phase("17 flash with a key length of its own, flash at dh 120, decode over an int8 cache "
          "and over an empty memory vs plain versions")
    bf16, f32 = torch.bfloat16, torch.float32
    err = {"cross": 0.0, "flash": 0.0, "decode": 0.0, "int8": 0.0}
    for i, case in enumerate(CROSS_CASES + [CROSS_MAIN]):
        e32 = check_cross(case, f32, dev, seed=i)
        e16, r16 = check_cross(case, bf16, dev, seed=i, tight=True)
        err["cross"] = max(err["cross"], e32, e16)
        print(f"flash cross (B, Sq, Sk, H, KV, dh) {str(case):28s}: float32 max |d| {e32:.3g}, "
              f"bf16 max |d| {e16:.3g}, worst row ||d||/||ref|| {r16:.3g}; two calls equal")
    sm = registry.get(SEAMLESS_ARCH)
    h2o = registry.get(H2O_ARCH)
    enc = (SEAMLESS_B, SEAMLESS_FRAMES, sm.n_heads, sm.n_kv_heads, sm.hd, False, 0, False)
    f_h2o, d_h2o = launch_shapes(h2o, H2O_B, H2O_S, H2O_S + INT8_STEPS)
    x_dec = (SEAMLESS_B, SEAMLESS_FRAMES, sm.n_heads, sm.n_kv_heads, sm.hd)
    for kind, case, slots, label in (("flash", enc, None, "seamless encoder"),
                                     ("flash", f_h2o, None, "h2o prefill"),
                                     ("decode", x_dec, SEAMLESS_FRAMES, "seamless cross step")):
        e32 = (check_flash(case, f32, dev) if kind == "flash"
               else check_decode(case, f32, dev, valid_slots=slots))
        e16, r16 = check_tight(kind, case, dev, valid_slots=slots)
        err[kind] = max(err[kind], e32, e16)
        print(f"{kind} {case} ({label}): float32 max |d| {e32:.3g}, bf16 max |d| {e16:.3g}, "
              f"worst row {r16:.3g}; two calls equal")
    for i, case in enumerate(INT8_DECODE_CASES):
        e32, _ = check_decode_int8(case, dev, f32, seed=i)
        e16, r16 = check_decode_int8(case, dev, bf16, seed=i)
        err["int8"] = max(err["int8"], e32, e16)
        same = ("; bit for bit the same dtype's entry on the dequantized cache"
                if dev.type == "cuda" else "")
        print(f"decode int8 (B, Sc, H, KV, dh, valid) {str(case):30s}: float32 max |d| {e32:.3g}, "
              f"bf16 max |d| {e16:.3g}, worst row {r16:.3g}; two calls equal{same}")
    launches, empty = dec_ops.decode.launches, dec_ops.decode.empty_calls
    q = torch.randn((SEAMLESS_B, sm.n_heads, sm.hd), device=dev).to(bf16)
    none = torch.zeros((SEAMLESS_B, 0, sm.n_kv_heads, sm.hd), dtype=bf16, device=dev)
    z = dec_ops.decode(q, none, none, torch.ones((SEAMLESS_B, 0), dtype=torch.bool, device=dev))
    if (z.shape != q.shape or bool(z.any()) or dec_ops.decode.launches != launches
            or dec_ops.decode.empty_calls != empty + 1):
        raise AssertionError("decode over an empty memory: not zeros without a launch")
    print("decode over an empty memory (Sc = 0): zeros of q's shape, no launch (an empty call)")

    t = {}
    c_ms, c_plain, c_lib = time_cross(CROSS_MAIN, dev)
    c_work = cross_work(CROSS_MAIN, 2)
    c_bound, c_by = bound(*c_work, BF16_TENSOR_OPS_PER_S)
    t["cross"] = {"ms": c_ms, "plain_ms": c_plain, "library_ms": c_lib, "bound_ms": c_bound,
                  "bound_by": c_by}
    print(f"flash cross {CROSS_MAIN} bf16: kernel {c_ms:.4f} ms (device), plain {c_plain:.4f} "
          f"ms, SDPA {c_lib:.4f} ms (device); {c_work[0]} bytes, {c_work[1]:.4g} flops, "
          f"bound {c_bound:.4g} ms ({c_by}), {c_work[0] / c_ms / 1e9:.3f} TB/s")
    h_ms = time_flash_kernel(f_h2o, dev)
    h_work = flash_work(f_h2o, 2)
    h_bound, h_by = bound(*h_work, BF16_TENSOR_OPS_PER_S)
    print(f"flash {f_h2o} bf16 (h2o prefill, dh 120): kernel {h_ms:.4f} ms; {h_work[1]:.4g} "
          f"flops, bound {h_bound:.4g} ms ({h_by}), {h_work[1] / h_ms / 1e9:.2f} TFLOP/s (the "
          f"plain version's [B,H,S,S] scores need 65 GB here, and SDPA takes no sliding "
          f"window: neither is timed)")
    i8 = time_decode_int8(INT8_DECODE_CASES[0], dev)
    i_bound, i_by = bound(*i8["work"], BF16_TENSOR_OPS_PER_S)
    t["int8"] = {"ms": i8["ms"], "plain_ms": i8["plain_ms"], "library_ms": None,
                 "bound_ms": i_bound, "bound_by": i_by}
    print(f"decode int8 {INT8_DECODE_CASES[0]} (h2o's full ring): {i8['ms']:.4f} ms through the "
          f"wrapper, plain {i8['plain_ms']:.4f} ms, the bf16 entry on the dequantized cache "
          f"{i8['bf16_ms']:.4f} ms; {i8['work'][0]} bytes, bound {i_bound:.4g} ms ({i_by}), "
          f"{i8['work'][0] / i8['ms'] / 1e9:.3f} TB/s; no PyTorch call reads an int8 cache")
    i8l = time_decode_int8(INT8_DECODE_CASES[2], dev)
    print(f"decode int8 {INT8_DECODE_CASES[2]} (llama's linear cache, random positions): "
          f"{i8l['ms']:.4f} ms, plain {i8l['plain_ms']:.4f} ms, bf16 entry {i8l['bf16_ms']:.4f} "
          f"ms, bound {bound(*i8l['work'], BF16_TENSOR_OPS_PER_S)[0]:.4g} ms")
    return {"err": err, "times": t}


def int8_phase(dev) -> dict:
    """Phase 19d: h2o-danube-3-4b at full size from one set of weights, its
    bf16 and int8 caches: prefill H2O_B x H2O_S (past the window: the ring
    wraps) equal logits bit for bit (the prefill attends over bf16 K/V in
    both), then INT8_STEPS decode steps of each, the int8 logits within
    INT8_REL of the bf16 run's largest, and one int8 decode launch a layer
    a step."""
    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.models import model

    phase(f"19d {H2O_ARCH}: the int8 KV cache against bf16 at full size")
    cfgs = {"bf16": registry.get(H2O_ARCH)}
    cfgs["int8"] = dataclasses.replace(cfgs["bf16"], kv_cache_dtype="int8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = draw_weights(cfgs["bf16"], gen, dev)
    B, S = H2O_B, H2O_S
    tokens = torch.randint(0, cfgs["bf16"].vocab, (B, S + INT8_STEPS), generator=gen,
                           device=dev, dtype=torch.int32)
    L = cfgs["bf16"].n_layers
    fl_ops.reset_launches()
    dec_ops.reset_launches()
    logits, caches, pre_s = {}, {}, {}
    for name, cfg in cfgs.items():
        prefill = model.make_prefill_step(cfg, S + INT8_STEPS)
        for _ in range(2):  # the second call is timed
            caches[name] = None
            t0 = time.perf_counter()
            logits[name], caches[name] = prefill(params, {"tokens": tokens[:, :S]})
            torch.cuda.synchronize()
            pre_s[name] = time.perf_counter() - t0
    if not torch.equal(logits["bf16"], logits["int8"]):
        raise AssertionError("int8 prefill logits differ from the bf16 run's")
    k = caches["int8"]["blk0"]["k"]
    if k.dtype != torch.int8 or k.shape[2] != cfgs["int8"].window:
        raise AssertionError(f"int8 cache leaf {k.dtype} {tuple(k.shape)}: not an int8 ring")
    flash = fl_ops.mha.launches
    step_s = {"bf16": [], "int8": []}
    worst = 0.0
    decode = {n: model.make_decode_step(c) for n, c in cfgs.items()}
    for t in range(S, S + INT8_STEPS):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        for name in cfgs:
            t0 = time.perf_counter()
            logits[name], _ = decode[name](params, tokens[:, t], pos, caches[name])
            torch.cuda.synchronize()
            step_s[name].append(time.perf_counter() - t0)
        a, b = logits["bf16"].float(), logits["int8"].float()
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"int8 decode {t}: non-finite logits")
        rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-9)).item()
        worst = max(worst, rel)
        if rel >= INT8_REL:
            raise AssertionError(f"int8 decode {t}: logits {rel:.4g} of the bf16 run's largest "
                                 f"away (limit {INT8_REL})")
    by = dec_ops.decode.launches_by_cache
    if by["int8"] != L * INT8_STEPS or by["bfloat16"] != L * INT8_STEPS:
        raise AssertionError(f"decode launches {by} != {L} x {INT8_STEPS} of each cache")
    if flash != 4 * L or fl_ops.mha.launches_by_dtype["bfloat16"] != 4 * L:
        raise AssertionError(f"flash launches {fl_ops.mha.launches_by_dtype} != 4 prefills x {L}")
    ms = {n: sum(v) / len(v) * 1e3 for n, v in step_s.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"prefill {B} x {S} (past the {cfgs['int8'].window} window): bf16 "
          f"{pre_s['bf16'] * 1e3:.2f} ms = {B * S / pre_s['bf16']:.1f} tokens/s, int8 "
          f"{pre_s['int8'] * 1e3:.2f} ms = {B * S / pre_s['int8']:.1f} tokens/s; logits equal bit "
          f"for bit")
    print(f"decode B={B}, {INT8_STEPS} steps: bf16 {ms['bf16']:.3f} ms a step, int8 "
          f"{ms['int8']:.3f} ms a step; int8 logits within {worst:.4g} of the bf16 run's largest "
          f"(limit {INT8_REL}); decode launches by cache {by} ({L} a step each); peak device "
          f"memory {peak:.2f} GiB")
    del params, caches, logits
    torch.cuda.empty_cache()
    return {"int8": by["int8"], "bf16": by["bfloat16"], "flash": flash, "prefill_s": pre_s,
            "step_ms": ms, "rel": worst, "peak_gib": peak}


def slice8_phases(dev, records):
    """Phases 17-19. Adds the records of flash's cross route and decode's
    int8 entry, and folds the new paths' bf16 flash and decode launches and
    phase 17's checks into the attention kernels' records."""
    from repro_torch.configs import registry

    k17 = slice8_kernel_phase(dev)
    runs = {}
    reg = registry.get(INTERNVL_ARCH)
    ivl = dataclasses.replace(reg, max_seq=INTERNVL_MAX_SEQ)
    runs[INTERNVL_ARCH] = serve_phase(
        18, INTERNVL_ARCH, ivl, (INTERNVL_B, INTERNVL_T), dev, front=INTERNVL_P,
        cache_len=INTERNVL_CACHE, cut=[
            f"max_seq {ivl.max_seq} (registry: {reg.max_seq}) for the router's pods' caches "
            f"(3 x 12 slots x {ivl.n_layers} layers: 14.5 GB at 2,048, 29 GB at 4,096, beside "
            f"39.8 GB of weights); the serve run's own cache holds {INTERNVL_CACHE} slots"])
    reg = registry.get(SEAMLESS_ARCH)
    sm = dataclasses.replace(reg, max_seq=SEAMLESS_MAX_SEQ)
    runs[SEAMLESS_ARCH] = serve_phase(
        19, SEAMLESS_ARCH, sm, (SEAMLESS_B, SEAMLESS_DEC), dev, front=SEAMLESS_FRAMES,
        cache_len=SEAMLESS_CACHE, cpu_cfg=dataclasses.replace(sm, n_layers=1, n_enc_layers=1),
        cut=[f"max_seq {sm.max_seq} (registry: {reg.max_seq}) for the router's pods' caches, as "
             f"llama's"])
    i8 = int8_phase(dev)
    by_name = {r["name"]: r for r in records}
    fl, dec = by_name["flash_attention"], by_name["decode_attention"]
    err = k17["err"]
    fl["max_abs_err"] = max(fl["max_abs_err"], err["flash"], *(r["err"][0] for r in runs.values()))
    dec["max_abs_err"] = max(dec["max_abs_err"], err["decode"],
                             *(r["err"][1] for r in runs.values()))
    for res in runs.values():
        fl["launches"] += res["launches"]["mha"] - res["cross"]
        dec["launches"] += res["decode_by_cache"]["bfloat16"]
    fl["launches"] += i8["flash"]
    dec["launches"] += i8["bf16"]
    cross = runs[SEAMLESS_ARCH]["cross"]
    want = 2 * registry.get(SEAMLESS_ARCH).n_layers
    if cross != want:  # the timed and the warm-up prefill
        raise AssertionError(f"flash cross-route launches {cross} != {want}")
    records.append(dict({"name": "flash_attention_cross", "route": "cuda",
                         "source": "src/repro_torch/csrc/flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
                         "launches": cross, "max_abs_err": err["cross"]}, **k17["times"]["cross"]))
    records.append(dict({"name": "decode_attention_int8", "route": "cuda",
                         "source": "src/repro_torch/csrc/decode_attention.cu",
                         "replaces": "src/repro/kernels/decode_attention/decode_attention.py:64",
                         "launches": i8["int8"], "max_abs_err": err["int8"]},
                        **k17["times"]["int8"]))
    return records, runs, i8


# ---------------------------------------------------------------------------
# slice 11: continuation (Simulator.resume) and the port's smoke path
# ---------------------------------------------------------------------------

# phase 5e: fig11's online segments at fig11's own size, the chain as
# `repro_torch.bench.figures.fig11_online` runs it (T = QUICK_T = 48,
# `figures.fig11_bank()`: ycsb_bank(48, theta=0.9, dist_ratio=0.6),
# FIG11_SEGMENTS, 8 s segments)
# (preset, segment, events, commits, aborts, throughput_tps, final clock us)
# of fig11's online loop run through the JAX reference on the CPU (its
# single-world `sim.run` / `sim.resume` chain, nothing recorded), printed
# by `PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_bench_smoke.py`.
# Events and commits are cumulative; a resumed segment's throughput is its
# new commits over 8 s, the first's the metrics' (commits over 7 s).
FIG11_ONLINE_REF = [
    ("ssp", 0, 13899, 624, 0, 89.14285714285714, 7998678),
    ("ssp", 1, 26244, 1309, 0, 85.625, 15998159),
    ("ssp", 2, 37185, 1894, 12, 73.125, 23998119),
    ("ssp", 3, 52608, 2748, 12, 106.75, 31996165),
    ("geotp", 0, 17097, 889, 0, 127.0, 7999298),
    ("geotp", 1, 23970, 1306, 24, 52.125, 15995472),
    ("geotp", 2, 38671, 2234, 27, 116.0, 23994777),
    ("geotp", 3, 47795, 2817, 32, 72.875, 31993053),
]
# phase 5f: each smoke leg's (preset, seed, events, commits, aborts) as the
# JAX reference gives them for the reference smoke's cells
# (`benchmarks/run.py::smoke`, run through `benchmarks.common.run_sweep` on
# the CPU with strategy="map" and record=False; the same command as
# FIG11_ONLINE_REF). The drained and the single-event leg share the grid's
# numbers (the reference's steps are bitwise-interchangeable).
_SMOKE_GRID = [
    ("ssp", 0, 3550, 193, 0), ("ssp-local", 0, 3970, 256, 0), ("scalardb", 0, 1473, 73, 0),
    ("geotp", 0, 3879, 233, 0), ("ssp", 1, 4537, 253, 0), ("ssp-local", 1, 4397, 278, 0),
    ("scalardb", 1, 1771, 77, 0), ("geotp", 1, 4715, 278, 0), ("ssp", 2, 4613, 259, 0),
    ("ssp-local", 2, 4835, 316, 0), ("scalardb", 2, 1551, 86, 0), ("geotp", 2, 5025, 314, 0),
    ("ssp", 3, 3322, 186, 0), ("ssp-local", 3, 3708, 234, 0), ("scalardb", 3, 1427, 75, 0),
    ("geotp", 3, 3746, 228, 0),
]
SMOKE_REF = {
    "grid": _SMOKE_GRID,
    "single": _SMOKE_GRID,
    "faults": [("ssp", 0, 3541, 195, 54), ("geotp", 0, 3329, 191, 67)],
    "partitions": [("ssp", 0, 2802, 140, 31), ("geotp", 0, 3241, 179, 41)],
    "protocols": [
        ("ssp", 0, 3550, 246, 0), ("geotp", 0, 3879, 292, 0), ("fastc", 0, 8479, 770, 0),
        ("tiga", 0, 4208, 378, 0), ("opta", 0, 5079, 332, 85), ("ssp", 1, 4537, 313, 0),
        ("geotp", 1, 4715, 350, 0), ("fastc", 1, 8695, 778, 0), ("tiga", 1, 4321, 385, 0),
        ("opta", 1, 5335, 351, 74),
    ],
}


def fig11_online_phase(device=None) -> int:
    """Phase 5e: fig11's online loop through the port (`figures.fig11_online`:
    each preset a single-lane chain of `run`, then `with_states` (tau_true
    edited) and `resume` a segment); every segment equal to
    FIG11_ONLINE_REF and two geo_schedule launches a step. Returns the
    launches."""
    from repro_torch.bench import figures
    from repro_torch.core.engine import batch
    from repro_torch.kernels.geo_schedule import ops

    t0 = time.perf_counter()
    bank = figures.fig11_bank()
    print(f"bank built in {time.perf_counter() - t0:.2f} s")
    ref = iter(FIG11_ONLINE_REF)
    tot = dict(launches=0, bad=0, steps=0, wall=0.0)
    seen = {}

    def check(preset, i, rtt, res, m):
        launches = ops.geo_schedule.launches
        ops.geo_schedule.launches = 0
        on_card = res.states.now.device.type == "cuda"
        if launches != (2 * res.steps if on_card else 0):
            raise AssertionError(f"{preset} segment {i}: geo_schedule launches {launches} "
                                 f"!= 2 x {res.steps} steps")
        got = (preset, i, m["events"], m["commits"], m["aborts"], m["throughput_tps"],
               int(res.states.now[0]))
        want = next(ref)
        seg_events, seen[preset] = m["events"] - seen.get(preset, 0), m["events"]
        print(f"{preset:5s} segment {i} tau_true {rtt} ms: events {got[2]} (+{seg_events}) "
              f"commits {got[3]} aborts {got[4]} throughput {got[5]} tps now {got[6]} us; "
              f"{res.steps} steps, {res.wall_s:.3f} s ({batch.run.capture_s:.3f} s warm-up "
              f"and capture), {seg_events / res.wall_s:.1f} events/s, "
              f"{res.wall_s / max(res.steps, 1) * 1e3:.4f} ms a step, geo_schedule launches "
              f"{launches}: {'the reference' if got == want else f'REFERENCE {want}'}")
        tot["bad"] += got != want
        tot["launches"] += launches
        tot["steps"] += res.steps
        tot["wall"] += res.wall_s

    ops.geo_schedule.launches = 0
    figures.fig11_online(bank, device=device, on_segment=check)
    if tot["bad"]:
        raise AssertionError(f"fig11 online: {tot['bad']} segments differ from FIG11_ONLINE_REF")
    print(f"fig11 online: {len(FIG11_ONLINE_REF)} segments equal to the reference; "
          f"{tot['steps']} steps, {tot['wall']:.3f} s, {tot['steps'] / tot['wall']:.1f} steps/s, "
          f"geo_schedule launches {tot['launches']}")
    return tot["launches"]


def smoke_phase(device=None) -> int:
    """Phase 5f: `repro_torch.bench.smoke` with its bench file in a temporary
    directory: every guard holds, every leg's cells equal SMOKE_REF, the
    file holds the entry and one sweep a leg, two geo_schedule launches a
    step. Returns the launches."""
    import tempfile

    from repro_torch.bench import smoke
    from repro_torch.kernels.geo_schedule import ops

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "BENCH_engine.json"
        ops.geo_schedule.launches = 0
        run = smoke.smoke(path, device=device)
        launches = ops.geo_schedule.launches
        bench = json.loads(path.read_text())
    if run.rc != 0:
        raise AssertionError("the port's smoke failed a guard")
    if bench["smoke"] != json.loads(json.dumps(run.entry)):
        raise AssertionError("the bench file's smoke entry is not the one the smoke recorded")
    tags = sorted(f"smoke_{name}" for name in smoke.LEGS)
    if sorted(bench["sweeps"]) != tags or any("steps" not in bench["sweeps"][t] for t in tags):
        raise AssertionError(f"bench file sweeps {sorted(bench['sweeps'])} != {tags}")
    env = {k: run.entry[k] for k in ("torch_backend", "device_name", "power_limit")}
    print(f"bench file: the smoke entry ({len(run.entry)} keys) and sweeps {tags}; {env}")
    steps = sum(r.steps for r in run.results.values())
    on_card = next(iter(run.results.values())).states.now.device.type == "cuda"
    if launches != (2 * steps if on_card else 0):
        raise AssertionError(f"geo_schedule launches {launches} != 2 x {steps} steps")
    bad = []
    for name in smoke.LEGS:
        res, cells = run.results[name], smoke.leg_cells()[name][0]
        got = [(c["preset"], c["seed"], m["events"], m["commits"], m["aborts"])
               for c, m in zip(cells, res.metrics)]
        diff = [(g, w) for g, w in zip(got, SMOKE_REF[name]) if g != w]
        if diff or len(got) != len(SMOKE_REF[name]):
            bad.append((name, diff))
        d = res.drain
        print(f"{name:10s} {len(res)} lanes: {res.steps} steps, {run.walls[name]:.3f} s "
              f"(run {res.wall_s:.3f} s), {res.events / run.walls[name]:.1f} events/s, drain "
              f"hit rate {d['drain_hit_rate']}, mean window {d['mean_window_len']}: "
              f"{'the reference' if not diff else diff}")
    if bad:
        raise AssertionError(f"smoke legs differ from SMOKE_REF: {bad}")
    print(f"smoke: every leg's cells equal to the reference; {steps} steps, geo_schedule "
          f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# slice 12: the sequential lanes (strategy="map", engine.simulate)
# ---------------------------------------------------------------------------

# phase 5g (a): the 12 presets at fig5's YCSB deployment (4 data sources at
# paper RTTs, 1M records per node, zipf 0.9, 20% distributed, 5 ops), cut to
# T = 8 and a 0.2 s horizon (for the script's time: by then every lane has
# committed, and CRASH_HEAVY's first crash, at 0.1 s, has aborted
# transactions and failed reads over), fault-free and under CRASH_HEAVY with
# replicas
SEQ_T, SEQ_N = 8, 64
SEQ_HORIZON_S, SEQ_WARMUP_S = 0.2, 0.05
SEQ_SCHEDULES = {"fault-free": {},
                 "crash-heavy": dict(faults=CRASH_HEAVY, replica_tau=(60_000,) * 4,
                                     repl_lag_us=250_000)}
# (b): phase 5's world (fig5's YCSB deployment at T = 128) for geotp, seed 0,
# its horizon cut from fig5's 10 s / 2 s to fit the phase's time: run untimed
# to the warm-up, then timed over 0.15 s, past the start-up burst
SEQ_MAIN_WARMUP_S, SEQ_MAIN_HORIZON_S = 0.3, 0.45


def seq_bank(terminals, txns, seed=0):
    from repro_torch.core import workloads

    return workloads.make_ycsb_bank(
        workloads.YCSBConfig(num_ds=4, records_per_node=1_000_000, ops_per_txn=5,
                             dist_ratio=0.2, theta=0.9, seed=seed), terminals, txns)


def seq_grid(schedule):
    from repro_torch.core.engine import Grid
    from repro_torch.core.protocols import PRESETS

    return Grid([dict(preset=p, **SEQ_SCHEDULES[schedule]) for p in sorted(PRESETS)])


def seq_run(schedule, drain, strategy, device):
    """Phase 5g (a)'s grid through `run_grid(strategy=...)` on `device`:
    (RunResult, geo_schedule launches counted over the run)."""
    from repro_torch.core.engine import Simulator
    from repro_torch.kernels.geo_schedule import ops

    bank = seq_bank(SEQ_T, SEQ_N)
    sim = Simulator.from_bank(bank, horizon_s=SEQ_HORIZON_S, warmup_s=SEQ_WARMUP_S, drain=drain,
                              track_slots=True, device=device)
    ops.geo_schedule.launches = 0
    res = sim.run_grid(seq_grid(schedule), bank, strategy=strategy)
    return res, ops.geo_schedule.launches


def seq_cpu_run(schedule, drain):
    """Phase 5g (a)'s map lanes on the CPU (eager, one thread), in a process
    of its own: a stand-in for the RunResult with the
    final states as numpy arrays."""
    import types

    from repro_torch.core.engine.state import tree_map

    torch.set_num_threads(1)
    res, _ = seq_run(schedule, drain, "map", "cpu")
    return types.SimpleNamespace(steps=res.steps, events=res.events, wall_s=res.wall_s,
                                 states=tree_map(lambda x: x.numpy(), res.states))


def start_seq_cpu_runs():
    """Phase 5g (a)'s four CPU runs, one process each."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    return pool, {(sch, drain): pool.submit(seq_cpu_run, sch, drain)
                  for sch in SEQ_SCHEDULES for drain in (False, True)}


def map_line(label, res, launches) -> str:
    """Events/s, host ms an event and launches of a map run on the card."""
    return (f"{label}: {len(res)} lanes, {res.steps} sequential steps, {res.events} events, "
            f"{res.wall_s:.3f} s, {res.events / res.wall_s:.1f} events/s, "
            f"{res.wall_s / res.events * 1e3:.4f} host ms an event, geo_schedule launches "
            f"{launches} ({launches / res.events:.4f} an event)")


def states_equal_but(a, b, skip, what) -> None:
    bad = [(n, lanes) for n, lanes in leaf_mismatches(a, b) if n not in skip]
    for name, lanes in bad:
        print(f"MISMATCH leaf {name} lanes {lanes}")
    if bad:
        raise AssertionError(f"{len(bad)} SimState leaves differ: {what}")
    print(f"every SimState leaf{' but ' + '/'.join(skip) if skip else ''} equal: {what}")


def branch_costs(dev, n=2000) -> tuple[float, float]:
    """Host us of one eager op at the handlers' sizes (a [1, 4] `torch.where`)
    and of one host read of a predicate after it (`handlers._flags`: the
    device-to-host copy and its wait): a handler's inner branch costs one
    read as a host branch, or both bodies' ops as a masked write."""
    from repro_torch.core.engine.handlers import _flags

    x = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    m = x > 0
    p = m.any(1)
    times = []
    for read in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            y = torch.where(m, x, 1)
            if read:
                _flags(p)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n * 1e6)
        del y
    op_us, read_us = times[0], times[1] - times[0]
    print(f"host cost on the card: one eager [1, 4] op {op_us:.2f} us, one host read of a "
          f"predicate after it {read_us:.2f} us (= {read_us / op_us:.1f} ops)")
    return op_us, read_us


def seq_main_warm(device):
    """Phase 5g (b)'s untimed prefix: phase 5's world for geotp, single-event,
    to the warm-up, the map lane through `engine.simulate` and the vmap lane
    through `run_grid`, equal on every leaf. Returns (bank, the map lane's
    state, the vmap RunResult)."""
    from repro_torch.core.engine import Grid, Simulator, simulate
    from repro_torch.core.netmodel import PAPER_RTT_MS, derive_tau_ds_us, make_net_params

    bank = seq_bank(T_MAIN, 256)
    sim = Simulator.from_bank(bank, horizon_s=SEQ_MAIN_WARMUP_S, warmup_s=0.05, drain=False,
                              device=device)
    tau = make_net_params(PAPER_RTT_MS).tau_dm
    cfg = dataclasses.replace(sim.cfg, lockstep=False)
    state, m = simulate(cfg, bank, tau, derive_tau_ds_us(tau), 30, device=sim.device)
    if m["noops"] != 0:
        raise AssertionError(f"engine.simulate: {m['noops']} noops")
    vres = sim.run_grid(Grid([dict(preset="geotp", seed=0)], banks=[bank]), strategy="vmap")
    states_equal_but(state, vres.states, (), f"T={T_MAIN} geotp to the warm-up, map vs vmap lane")
    return bank, state, vres


def seq_main_timed(bank, warm, vwarm, device) -> tuple[int, dict]:
    """Phase 5g (b)'s timed span, from the warm-up to the horizon, in both
    modes: the map lane through `engine.simulate(state=)` and the vmap lane
    through `resume`, from copies of the warm states. Each mode's map lane
    equals its vmap lane on every leaf but `fused`; the two map lanes agree
    but the drain telemetry. The vmap lane's rate leaves out its capture.
    Returns (geo_schedule launches, the numbers printed)."""
    from repro_torch.core.engine import Simulator, batch, simulate
    from repro_torch.core.engine.metrics import drain_stats
    from repro_torch.core.engine.state import tree_map
    from repro_torch.core.netmodel import PAPER_RTT_MS, derive_tau_ds_us, make_net_params
    from repro_torch.kernels.geo_schedule import ops

    tau = make_net_params(PAPER_RTT_MS).tau_dm
    base = int(warm.iters[0])
    launches, out, runs = 0, {}, {}
    for drain in (False, True):
        mode = "drained" if drain else "single-event"
        sim = Simulator.from_bank(bank, horizon_s=SEQ_MAIN_HORIZON_S,
                                  warmup_s=SEQ_MAIN_WARMUP_S, drain=drain, device=device)
        cfg = dataclasses.replace(sim.cfg, lockstep=False)
        state = tree_map(torch.clone, warm)
        ops.geo_schedule.launches = 0
        t0 = time.perf_counter()
        state, m = simulate(cfg, bank, tau, derive_tau_ds_us(tau), 30, state=state,
                            device=sim.device)
        wall = time.perf_counter() - t0
        n = ops.geo_schedule.launches
        events = m["events"] - base
        if n <= 0 and state.now.device.type == "cuda":
            raise AssertionError(f"T={T_MAIN} geotp {mode}: no geo_schedule launch")
        if m["noops"] != 0 or m["commits"] <= 0:
            raise AssertionError(f"engine.simulate {mode}: {m['noops']} noops, "
                                 f"{m['commits']} commits")
        vcopy = vwarm.with_states(tree_map(torch.clone, vwarm.states))
        vcopy = dataclasses.replace(vcopy, cfg=dataclasses.replace(vcopy.cfg, drain=drain))
        vres = sim.resume(vcopy, horizon_s=SEQ_MAIN_HORIZON_S, warmup_s=SEQ_MAIN_WARMUP_S)
        vcap = batch.run.capture_s
        vevents = vres.events - base
        drained = ""
        if drain:
            d = drain_stats(state, horizon_us=cfg.horizon_us)
            drained = (f", drain hit rate {d['drain_hit_rate']}, mean window "
                       f"{d['mean_window_len']}")
        print(f"{mode}, engine.simulate(state=) from {SEQ_MAIN_WARMUP_S} s: {events} events, "
              f"{wall:.3f} s, {events / wall:.1f} events/s, {wall / events * 1e3:.4f} host ms "
              f"an event, geo_schedule launches {n} ({n / events:.4f} an event){drained}; the "
              f"vmap lane resumed: {vres.steps} steps, {vres.wall_s:.3f} s with "
              f"{vcap:.3f} s of capture, {vevents / (vres.wall_s - vcap):.1f} events/s "
              f"without it")
        if vevents != events:
            raise AssertionError(f"{events} events, the vmap lane {vevents}")
        states_equal_but(state, vres.states, ("fused",), f"T={T_MAIN} geotp, {mode}: map vs vmap")
        runs[drain] = state
        launches += n
        out["main", mode] = dict(events=events, wall_s=wall, launches=n,
                                 vmap_wall_s=vres.wall_s - vcap)
    states_equal_but(runs[True], runs[False], TELEMETRY, f"T={T_MAIN} geotp, drained vs single")
    return launches, out


def sequential_phase(device=None) -> tuple[int, dict]:
    """Phase 5g: the sequential lanes on the card. (a) the 12 presets
    through `run_grid(strategy="map")`, drained and single-event,
    fault-free and crash-heavy: every leaf but `fused` equal to the card's
    vmap lanes, geo_schedule launched eagerly, and every leaf equal to the
    CPU's map lanes; (b) phase 5's world for geotp through `engine.simulate`
    in both modes, from the warm-up to the horizon, each equal to its lane
    of a vmap run on every leaf but `fused`. Every timed run has the host to
    itself: the CPU's map lanes (four processes) run beside (b)'s untimed
    prefix. Returns (the map runs' geo_schedule launches, the numbers
    printed)."""
    from repro_torch.core.engine import batch
    from repro_torch.core.engine.state import tree_map

    launches, out, cards = 0, {}, {}
    if torch.cuda.is_available() and device != "cpu":
        out["branch"] = branch_costs(torch.device("cuda"))
    for sch in SEQ_SCHEDULES:
        for drain in (False, True):
            mode = "drained" if drain else "single-event"
            card, n = seq_run(sch, drain, "map", device)
            vmap, _ = seq_run(sch, drain, "vmap", device)
            vcap = batch.run.capture_s
            if n <= 0 and card.states.now.device.type == "cuda":
                raise AssertionError(f"{sch} {mode}: no geo_schedule launch on the map lanes")
            for i, m in enumerate(card.metrics):
                if m["noops"] != 0 or m["commits"] <= 0:
                    raise AssertionError(f"{sch} {mode} lane {i}: {m['noops']} noops, "
                                         f"{m['commits']} commits")
            print(map_line(f"{sch} {mode}, map on the card", card, n))
            print(f"{sch} {mode}, vmap on the card: {vmap.steps} lockstep steps, "
                  f"{vmap.wall_s:.3f} s with {vcap:.3f} s of capture, "
                  f"{vmap.events / (vmap.wall_s - vcap):.1f} events/s without it "
                  f"({card.wall_s / (vmap.wall_s - vcap):.2f}x the map lanes' wall)")
            states_equal_but(card.states, vmap.states, ("fused",),
                             f"{sch} {mode}, card: map vs vmap lanes")
            if sch == "crash-heavy":
                d = card.drain
                if not (d["abort_causes"]["crash"] > 0 and d["failovers"] > 0):
                    raise AssertionError(f"the schedule did not bite: {d}")
            launches += n
            cards[sch, drain] = card
            out[sch, mode] = dict(events=card.events, wall_s=card.wall_s, launches=n,
                                  vmap_wall_s=vmap.wall_s - vcap)

    print(f"CUT (b): phase 5's world (fig5 YCSB, T={T_MAIN}) for geotp, seed 0, untimed to "
          f"{SEQ_MAIN_WARMUP_S} s, timed to {SEQ_MAIN_HORIZON_S} s (fig5: 10 s / 2 s)")
    pool, cpu = start_seq_cpu_runs()
    bank, warm, vwarm = seq_main_warm(device)
    for (sch, drain), fut in cpu.items():
        card, cpu_res = cards[sch, drain], fut.result()
        mode = "drained" if drain else "single-event"
        if (cpu_res.steps, cpu_res.events) != (card.steps, card.events):
            raise AssertionError(f"{sch} {mode}: CPU {cpu_res.steps} steps / "
                                 f"{cpu_res.events} events, card {card.steps} / {card.events}")
        states_equal_but(card.states, tree_map(torch.from_numpy, cpu_res.states), (),
                         f"{sch} {mode}, map lanes: card vs CPU ({cpu_res.wall_s:.2f} s)")
    pool.shutdown()
    n, main = seq_main_timed(bank, warm, vwarm, device)
    out.update(main)
    return launches + n, out


# ---------------------------------------------------------------------------
# slice 13: the paper's figure sweeps through the port (repro_torch.bench)
# ---------------------------------------------------------------------------

# phase 5h: every figure of `figures.ALL_FIGURES` but fig11, fig16 and fig17
# (phases 5c-5e run those uncut), each sweep at the reference's quick widths
# (QUICK_T = 48, fig5's T 16 / 32 / 64, every cell and bank), only the
# horizon cut: FIGURES_CUT = (horizon, warmup) s, the warmup min(its own,
# 0.15): fig18's 0 stays 0
FIGURES_5H = ("fig1_motivation", "fig5_overall", "fig7_dist_ratio", "fig8_latency_cdf",
              "fig9_tpcc", "fig10_network", "fig12_ablation", "table1_heterogeneous",
              "fig13_yugabyte", "fig14_txn_length", "fig15_multiregion", "fig18_protocols")
FIGURES_CUT = (0.6, 0.15)
# {sweep tag: each lane's (preset, events, commits, aborts, crc32 of its
# hist_all as int32 bytes)} as the JAX reference gives them for phase 5h's
# sweeps at FIGURES_CUT on the CPU (`benchmarks/figures.py`'s functions with
# `run_sweep` cut, nothing saved), printed by
# `PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_figures.py`
FIGURES_REF = {
    'fig1': [
        ('ssp', 16928, 939, 0, 1234280703), ('ssp', 8944, 483, 0, 497032421),
        ('ssp', 5136, 270, 0, 4137428601), ('ssp', 3781, 209, 0, 3198326785),
        ('ssp', 3046, 157, 0, 2423067867), ('ssp', 3082, 40, 0, 2922786445),
        ('ssp', 3604, 146, 0, 3980824225), ('ssp', 2979, 143, 0, 207648897),
        ('ssp', 2436, 127, 0, 3732618499), ('ssp', 1949, 93, 0, 1841700295),
    ],
    'fig5_ycsb_T16': [
        ('ssp', 637, 16, 0, 2693801418), ('ssp-local', 718, 30, 0, 1745502829),
        ('scalardb', 362, 12, 0, 3875925303), ('geotp', 761, 32, 0, 1452862473),
    ],
    'fig5_ycsb_T32': [
        ('ssp', 1047, 38, 0, 2356245791), ('ssp-local', 1131, 45, 0, 3445196706),
        ('scalardb', 574, 26, 0, 4153535130), ('geotp', 1153, 45, 0, 3833942986),
    ],
    'fig5_ycsb_T64': [
        ('ssp', 2492, 89, 0, 1747390005), ('ssp-local', 2571, 107, 0, 2128920002),
        ('scalardb', 1299, 48, 0, 455011344), ('geotp', 2653, 111, 0, 3795263399),
    ],
    'fig5_tpcc_T16': [
        ('ssp', 737, 25, 0, 1052789633), ('geotp', 848, 27, 0, 970185008),
    ],
    'fig5_tpcc_T32': [
        ('ssp', 1621, 51, 0, 3268324282), ('geotp', 1683, 61, 0, 3158532648),
    ],
    'fig7': [
        ('ssp', 2397, 113, 0, 156276135), ('ssp-local', 2397, 113, 0, 156276135),
        ('chiller', 2397, 113, 0, 156276135), ('geotp', 2397, 113, 0, 156276135),
        ('quro', 2397, 113, 0, 156276135), ('ssp', 2417, 99, 0, 2294263006),
        ('ssp-local', 2427, 111, 0, 2343029101), ('chiller', 2476, 111, 0, 3906147048),
        ('geotp', 2476, 113, 0, 2810051205), ('quro', 2417, 99, 0, 2294263006),
        ('ssp', 2143, 64, 0, 1042796970), ('ssp-local', 2112, 75, 0, 3655234571),
        ('chiller', 2283, 89, 0, 2535526017), ('geotp', 2269, 83, 0, 1999300656),
        ('quro', 2143, 64, 0, 1042796970), ('ssp', 1975, 41, 0, 2887661766),
        ('ssp-local', 1965, 61, 0, 3347487073), ('chiller', 2186, 74, 0, 1737275367),
        ('geotp', 2212, 71, 0, 329615761), ('quro', 1975, 41, 0, 2887661766),
        ('ssp', 2253, 106, 0, 927093277), ('ssp-local', 2253, 106, 0, 927093277),
        ('chiller', 2253, 106, 0, 927093277), ('geotp', 2253, 106, 0, 927093277),
        ('quro', 2259, 105, 0, 3192022124), ('ssp', 1958, 71, 0, 1973254933),
        ('ssp-local', 2216, 106, 0, 684460822), ('chiller', 2249, 102, 0, 2137685263),
        ('geotp', 2323, 101, 0, 1470615163), ('quro', 1959, 73, 0, 369477427),
        ('ssp', 1814, 50, 0, 2947322547), ('ssp-local', 1870, 64, 0, 1487923379),
        ('chiller', 1952, 70, 0, 669172248), ('geotp', 2033, 76, 0, 4022480613),
        ('quro', 1818, 50, 0, 873147359), ('ssp', 1716, 34, 0, 215672298),
        ('ssp-local', 1869, 59, 0, 2107789098), ('chiller', 2014, 63, 0, 3728230160),
        ('geotp', 2128, 67, 0, 3925068445), ('quro', 1742, 35, 0, 4065832843),
        ('ssp', 408, 4, 0, 2161373223), ('ssp-local', 408, 4, 0, 2161373223),
        ('chiller', 408, 4, 0, 2161373223), ('geotp', 408, 4, 0, 2161373223),
        ('quro', 557, 8, 0, 296462562), ('ssp', 516, 8, 0, 3317275331),
        ('ssp-local', 509, 11, 0, 3153310626), ('chiller', 466, 8, 0, 300838069),
        ('geotp', 574, 7, 0, 83510079), ('quro', 531, 7, 0, 2269369302),
        ('ssp', 663, 11, 0, 3169923284), ('ssp-local', 624, 12, 0, 2964545000),
        ('chiller', 627, 13, 0, 1567376415), ('geotp', 754, 8, 0, 672990090),
        ('quro', 643, 8, 0, 3911931157), ('ssp', 671, 7, 0, 2363630216),
        ('ssp-local', 630, 9, 0, 1760798833), ('chiller', 688, 20, 0, 362431096),
        ('geotp', 1068, 24, 0, 1317371415), ('quro', 693, 7, 0, 2877345665),
    ],
    'fig8': [
        ('ssp', 2143, 64, 0, 1042796970), ('ssp-local', 2112, 75, 0, 3655234571),
        ('geotp', 2269, 83, 0, 1999300656), ('ssp', 1814, 50, 0, 2947322547),
        ('ssp-local', 1870, 64, 0, 1487923379), ('geotp', 2033, 76, 0, 4022480613),
        ('ssp', 663, 11, 0, 3169923284), ('ssp-local', 624, 12, 0, 2964545000),
        ('geotp', 754, 8, 0, 672990090),
    ],
    'fig9': [
        ('ssp', 1311, 49, 0, 45931070), ('chiller', 1511, 73, 0, 2232088041),
        ('geotp', 1568, 73, 0, 3893617802), ('ssp', 3114, 65, 0, 3049496647),
        ('chiller', 3405, 86, 0, 1067490174), ('geotp', 3481, 84, 0, 4228130806),
    ],
    'fig10': [
        ('ssp', 7457, 381, 0, 3487171446), ('geotp', 8214, 435, 0, 279346996),
        ('ssp', 4240, 213, 0, 540345699), ('geotp', 4773, 258, 0, 662701967),
        ('ssp', 2414, 127, 0, 2133517277), ('geotp', 2679, 153, 0, 1629008967),
        ('ssp', 4283, 225, 0, 1902011899), ('geotp', 4609, 267, 0, 3969694828),
        ('ssp', 3974, 201, 0, 1603544191), ('geotp', 4540, 258, 0, 3649794595),
        ('ssp', 3776, 193, 0, 1165141396), ('geotp', 4220, 232, 0, 1098565051),
    ],
    'fig12': [
        ('ssp', 2289, 71, 0, 2211003712), ('geotp-o1', 2530, 91, 0, 2683838244),
        ('geotp-o1o2', 2415, 94, 0, 2473433086), ('geotp', 2415, 94, 0, 2473433086),
        ('ssp', 2289, 71, 0, 2211003712), ('geotp-o1', 2530, 91, 0, 2683838244),
        ('geotp-o1o2', 2415, 94, 0, 2473433086), ('geotp', 2415, 94, 0, 2473433086),
        ('ssp', 1727, 44, 0, 2392094332), ('geotp-o1', 2126, 72, 0, 3900235971),
        ('geotp-o1o2', 2135, 76, 0, 4203063260), ('geotp', 2135, 76, 0, 4203063260),
        ('ssp', 865, 17, 0, 4053693379), ('geotp-o1', 938, 25, 0, 410271420),
        ('geotp-o1o2', 946, 16, 0, 2041877204), ('geotp', 946, 16, 0, 2041877204),
        ('ssp', 374, 4, 0, 1444929338), ('geotp-o1', 417, 3, 0, 299704038),
        ('geotp-o1o2', 400, 2, 0, 2042571748), ('geotp', 400, 2, 0, 2042571748),
    ],
    'table1': [
        ('ssp', 2008, 73, 0, 78115800), ('geotp', 2347, 103, 0, 3844495231),
        ('ssp', 1755, 41, 0, 231043379), ('geotp', 2061, 66, 0, 2844833949),
        ('ssp', 2006, 72, 0, 2664330751), ('geotp', 2301, 102, 0, 150806213),
        ('ssp', 1768, 42, 0, 60415028), ('geotp', 2066, 67, 0, 1110361929),
        ('ssp', 2011, 73, 0, 2022600897), ('geotp', 2348, 103, 0, 2689564638),
        ('ssp', 1754, 42, 0, 3997002187), ('geotp', 2064, 69, 0, 1083494389),
    ],
    'fig13': [
        ('ssp', 2417, 99, 0, 2294263006), ('geotp', 2476, 113, 0, 2810051205),
        ('yugabyte-like', 3162, 154, 0, 226554470), ('ssp', 1958, 71, 0, 1973254933),
        ('geotp', 2323, 101, 0, 1470615163), ('yugabyte-like', 2801, 143, 0, 2586891190),
        ('ssp', 516, 8, 0, 3317275331), ('geotp', 574, 7, 0, 83510079),
        ('yugabyte-like', 545, 14, 0, 411937178),
    ],
    'fig14_ops5': [
        ('ssp', 1958, 71, 0, 1973254933), ('geotp', 2323, 101, 0, 1470615163),
    ],
    'fig14_ops15': [
        ('ssp', 987, 3, 0, 1048439352), ('geotp', 1143, 8, 0, 1095862039),
    ],
    'fig14_ops25': [
        ('ssp', 1019, 7, 0, 2850081044), ('geotp', 1146, 10, 0, 4279590877),
    ],
    'fig14_rounds': [
        ('ssp', 2191, 81, 0, 112832631), ('geotp', 2213, 93, 0, 2377416668),
        ('ssp', 2030, 56, 0, 3201280696), ('geotp', 2030, 57, 0, 3795863074),
        ('ssp', 2017, 40, 0, 2254476742), ('geotp', 1976, 47, 0, 3356007588),
        ('ssp', 1744, 59, 0, 2704040009), ('geotp', 1988, 84, 0, 2164929094),
        ('ssp', 1761, 43, 0, 966990521), ('geotp', 1887, 53, 0, 552716629),
        ('ssp', 1712, 28, 0, 3147944997), ('geotp', 1697, 35, 0, 1354157291),
    ],
    'fig15': [
        ('ssp', 1958, 71, 0, 1973254933), ('geotp', 2323, 101, 0, 1470615163),
        ('ssp', 926, 33, 0, 2898812477), ('geotp', 989, 44, 0, 245692274),
    ],
    'fig18': [
        ('ssp', 3794, 190, 0, 2993876947), ('geotp', 4124, 248, 0, 794283051),
        ('fastc', 5836, 454, 0, 3711685151), ('opta', 4202, 248, 0, 2403678558),
        ('tiga', 1825, 138, 0, 3645265538), ('tiga', 1933, 130, 0, 4134107850),
        ('tiga', 4749, 295, 0, 1971390354), ('ssp', 2289, 109, 0, 3201524982),
        ('geotp', 2415, 138, 0, 311550104), ('fastc', 3341, 247, 0, 2119379801),
        ('opta', 2530, 138, 0, 3611239064), ('tiga', 1649, 118, 0, 146833115),
        ('tiga', 1528, 99, 0, 874719330), ('tiga', 2769, 159, 0, 2958096267),
        ('ssp', 818, 28, 0, 499377385), ('geotp', 806, 34, 0, 825070020),
        ('fastc', 1370, 86, 0, 2770873359), ('opta', 4495, 77, 340, 2905888842),
        ('tiga', 1459, 103, 0, 719653290), ('tiga', 792, 36, 0, 60220614),
        ('tiga', 775, 31, 0, 910807582), ('ssp', 592, 15, 0, 3439371851),
        ('geotp', 750, 31, 0, 1996181337), ('fastc', 1415, 90, 0, 3121978183),
        ('opta', 2845, 50, 201, 2056053491), ('tiga', 1401, 97, 0, 724121783),
        ('tiga', 839, 40, 0, 241061425), ('tiga', 683, 25, 0, 701457068),
    ],
}


def hist_digest(hist) -> int:
    """crc32 of a histogram's int32 bytes (a tensor or an array)."""
    import zlib

    h = hist.detach().cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    return zlib.crc32(np.ascontiguousarray(h, dtype=np.int32).tobytes())


def figures_phase(device=None, rows_path=None) -> int:
    """Phase 5h: each sweep of FIGURES_5H through `figures.run` (the figure's
    own cells and banks, `run_sweep` on the captured lockstep lanes) at
    FIGURES_CUT: every lane's events, commits, aborts and hist_all digest
    equal to FIGURES_REF, two geo_schedule launches a step; each grid's
    lanes, steps, seconds and events/s. The figures' row code turns the
    results into their payloads (its lines go to `rows_path`, default
    build/figures_5h_rows.txt) and `claims.validate` prints its verdicts on
    them (not gated: the horizon is cut). Returns the launches."""
    import contextlib
    import io
    import tempfile

    from repro_torch.bench import claims, figures
    from repro_torch.bench.common import save
    from repro_torch.kernels.geo_schedule import ops

    h, w = FIGURES_CUT
    opts = figures.Options(device=device, horizon_s=h, warmup_s=w, record=False, save=False)
    launches = steps = events = 0
    wall, bad, lines = 0.0, [], io.StringIO()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in FIGURES_5H:
            sweeps, rows = figures.SWEEPS[name]
            out = []
            for s in sweeps(True):
                ops.geo_schedule.launches = 0
                res = figures.run(s, opts)
                n = ops.geo_schedule.launches
                if n != (2 * res.steps if res.states.now.device.type == "cuda" else 0):
                    raise AssertionError(f"{s.tag}: geo_schedule launches {n} != 2 x "
                                         f"{res.steps} steps")
                got = [(c["preset"], m["events"], m["commits"], m["aborts"],
                        hist_digest(res.world(i).hist_all))
                       for i, (c, m) in enumerate(zip(s.cells, res.metrics))]
                want = FIGURES_REF[s.tag]
                diff = [(i, g, r) for i, (g, r) in enumerate(zip(got, want)) if g != r]
                if diff or len(got) != len(want):
                    bad.append((s.tag, diff))
                cap, K = opts.log[-1]["capture_s"], (s.bank or s.banks[0]).key.shape[-1]
                print(f"{s.tag}: {len(s.cells)} lanes, T={s.terminals}, K={K}, "
                      f"{res.steps} steps, {res.events} events, {res.wall_s:.3f} s ({cap:.3f} s "
                      f"warm-up and capture), {res.events / res.wall_s:.1f} events/s, "
                      f"{res.wall_s / max(res.steps, 1) * 1e3:.4f} ms a step, geo_schedule "
                      f"launches {n}: {'every lane the reference' if not diff else diff}",
                      flush=True)
                with contextlib.redirect_stdout(lines):
                    out += rows(opts.sweep(s), res)
                launches, steps, events = launches + n, steps + res.steps, events + res.events
                wall += res.wall_s
            save(name, out, tmp)
        checks = claims.validate(tmp)
    path = pathlib.Path(rows_path or ROOT / "build" / "figures_5h_rows.txt")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(lines.getvalue())
    if bad:
        raise AssertionError(f"phase 5h: lanes differ from FIGURES_REF: {bad}")
    n_ok = sum(ok for _, ok, _ in checks)
    for name, ok, detail in checks:
        print(f"[{'PASS' if ok else 'FAIL'}] {name} :: {detail}")
    print(f"{n_ok}/{len(checks)} claims validated on the cut payloads (printed, not gated)")
    print(f"phase 5h: {len(FIGURES_REF)} grids, {sum(map(len, FIGURES_REF.values()))} lanes "
          f"equal to the reference; {steps} steps, {events} events, {wall:.3f} s in the runs, "
          f"{events / wall:.1f} events/s, {time.perf_counter() - t_phase:.1f} s with the banks "
          f"and rows; geo_schedule launches {launches}; the rows' lines in {path}")
    return launches


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
KERNEL_NAMES = ("geo_schedule", "decode_attention", "flash_attention", "mlstm_chunk",
                "rglru_scan", "flash_attention_cross", "decode_attention_int8")


def kernels_line(records) -> str:
    """The JSON line of every kernel's record; each holds all KERNEL_KEYS,
    every kernel of the port is there, and each was launched on its path."""
    if sorted(r["name"] for r in records) != sorted(KERNEL_NAMES):
        raise AssertionError(f"kernel records {[r['name'] for r in records]} != {KERNEL_NAMES}")
    for r in records:
        if set(r) != set(KERNEL_KEYS):
            raise AssertionError(f"{r['name']}: keys {sorted(r)} != {sorted(KERNEL_KEYS)}")
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was never launched on its path")
    return json.dumps({"kernels": records})


def main() -> int:
    t_start = time.perf_counter()
    phase("1 environment")
    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.geo_schedule import ops
    from repro_torch.kernels.geo_schedule.ref import geo_schedule_ref

    from repro_torch.device import smi_line

    smi = smi_line(torch.device("cuda", 0))
    kind = torch.cuda.get_device_name(0)
    print("device", kind, "count", torch.cuda.device_count())
    print(smi)
    dev = torch.device("cuda")
    # the default, stated: float32 products (the plain versions) stay float32
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("2 build")
    # the LM stack's kernels compile beside this one and phases 3-5 (phase 6 waits)
    pool = concurrent.futures.ThreadPoolExecutor(len(LM_KERNELS))
    builds = {name: pool.submit(timed_build, name) for name in LM_KERNELS}
    pool.shutdown(wait=False)
    # the CPU runs of phases 4-4c (~25-75 s each, eager) beside the builds and
    # phases 3-4b
    cpu_pool, cpu_runs = start_cpu_runs()
    t0 = time.perf_counter()
    _build.build("geo_schedule", verbose=True)
    _build.load("geo_schedule")
    print_build("geo_schedule", time.perf_counter() - t0)

    phase("3 geo_schedule kernel vs plain version on the card")
    max_err = 0.0
    for seed, (n, d, k) in enumerate(GEO_CASES):
        args = [x.to(dev) for x in geo_inputs(n, d, k, seed)]
        err = check_kernel(args, f"N={n:4d} D={d:2d} K={k:2d}", ops.geo_schedule,
                           geo_schedule_ref)
        max_err = max(max_err, err)
    # the main path's two launch shapes; the plain version's mean of the two
    # is the kernel record's plain time (each step launches each shape once);
    # the wrapper's time here is its host issue: the record's device time
    # comes from the windowed captured step's trace (phase 5b)
    kern_ms = plain_ms = 0.0
    work = np.zeros(2)
    for label, host_args in step_launches(B_MAIN, D_MAIN, K_MAIN, seed=99).items():
        args = [x.to(dev) for x in host_args]
        shape = f"{label} tau[{args[0].shape[0]},{args[0].shape[1]}] c[{args[3].shape[1]}]"
        max_err = max(max_err, check_kernel(args, shape, ops.geo_schedule, geo_schedule_ref))
        k_ms = cuda_ms(lambda: ops.geo_schedule(*args), 2000)
        p_ms = cuda_ms(lambda: geo_schedule_ref(*args), 500)
        w = geo_work(*host_args)
        b_ms, b_by = bound(*w)
        print(f"{shape}: wrapper {k_ms:.5f} ms/call (host issue of one eager call), plain "
              f"{p_ms:.5f} ms/call, {w[0]} bytes, {w[1]} ops, bound {b_ms:.3g} ms ({b_by})")
        kern_ms, plain_ms, work = kern_ms + k_ms / 2, plain_ms + p_ms / 2, work + np.array(w) / 2
    bound_ms, bound_by = bound(*work)
    print(f"per launch, mean of the two: wrapper {kern_ms:.5f} ms (host issue), plain "
          f"{plain_ms:.5f} ms, bound {bound_ms:.3g} ms ({bound_by}); max |dp| over all cases "
          f"{max_err:.3g} (the device time a launch inside the captured steps: phases 5, 5b)")

    phase("4 end to end: GPU vs CPU, all 12 presets, single-event step (drain=False)")
    bank16, grid12 = presets_grid()
    single12 = gpu_vs_cpu(bank16, grid12, False, cpu=cpu_result(cpu_runs, "presets", False))[0]

    phase("4b end to end: GPU vs CPU, all 12 presets, windowed drain (drain=True)")
    drained12 = gpu_vs_cpu(bank16, grid12, True, cpu=cpu_result(cpu_runs, "presets", True))[0]
    leaves_but_telemetry_equal(drained12["cuda"].states, single12["cuda"].states,
                               "phase 4b vs phase 4 on the card")
    del single12, drained12

    phase("4c end to end with faults: GPU vs CPU, 12 presets x CRASH_HEAVY / PART_HEAVY "
          "(replicas), single-event and windowed")
    launches_faults = fault_small_phase(cpu_runs)
    cpu_pool.shutdown()

    phase("5 main path: fig5 YCSB, T=128, 16 lanes, single-event step (drain=False)")
    print(f"CUT: horizon {HORIZON_S} s / warmup {WARMUP_S} s (fig5: 10 s / 2 s)")
    t0 = time.perf_counter()
    grid = main_grid()
    print(f"banks built in {time.perf_counter() - t0:.2f} s")
    single, launches = main_path(grid, drain=False)

    phase("5b main path drained: fig5 YCSB, T=128, 16 lanes, windowed drain (drain=True)")
    drained, launches_b = main_path(grid, drain=True)
    leaves_but_telemetry_equal(drained.states, single.states, "phase 5b vs phase 5")
    check_candidates(drained.states)
    print(f"events/s: drained {drained.events / drained.wall_s:.1f}, single-event "
          f"{single.events / single.wall_s:.1f} ({single.wall_s / drained.wall_s:.4f}x); "
          f"steps {drained.steps} vs {single.steps} ({drained.steps / single.steps:.4f})")
    launches += launches_b + launches_faults
    del single, drained

    s16 = fig_sweep("fig16")
    phase(f"5c fig16 at paper size: T={s16.terminals}, crashes and the fault-free control x "
          f"ssp / geotp, horizon {s16.horizon_s} s, the captured windowed step")
    res16, _, l16 = fig_phase("fig16")
    del res16

    s17 = fig_sweep("fig17")
    phase(f"5d fig17 at paper size: T={s17.terminals}, partitions / degrades / fault-free x "
          f"ssp / geotp, replicas at 30 ms, lag 500 ms")
    res17, grid17, l17 = fig_phase("fig17")
    launches += l16 + l17
    del res17

    phase("5-5d profiles of the captured replays: phase 5's, 5b's and 5d's grids")
    # the profiles run on a quiet host: the LM kernels' builds end first
    concurrent.futures.wait(builds.values())
    geo_single_ms = geo_ms(profile_replays(grid, dev, drain=False))
    prof_5b = profile_replays(grid, dev, drain=True)
    geo_dev_ms = geo_ms(prof_5b)
    print(f"geo_schedule device time a launch: {geo_dev_ms:.7f} ms in the windowed graph, "
          f"{geo_single_ms:.7f} ms in the single-event graph")
    del grid
    prof_5d = profile_replays(grid17, dev, drain=True, bank=s17.bank, terminals=s17.terminals)
    print(replay_line("phase 5b's fault-free replay (fig5, T=128, 16 lanes)", prof_5b))
    print(replay_line(f"phase 5d's faulted replay (fig17, T={s17.terminals}, 6 lanes, F=3)",
                      prof_5d))

    lm_records = recurrent_phases(dev, serving_phases(dev, builds))
    lm_records = moe_mla_phases(dev, lm_records)[0]
    lm_records = slice8_phases(dev, lm_records)[0]

    from repro_torch.bench import figures

    phase(f"5e fig11-online-T{figures.QUICK_T}: fig11's online segments through "
          f"Simulator.resume, {len(figures.FIG11_SEGMENTS)} x {figures.FIG11_SEGMENT_S} s a "
          f"preset")
    launches += fig11_online_phase()

    phase("5f the port's smoke (repro_torch.bench.smoke): fig5 YCSB, T=32, five legs")
    launches += smoke_phase()

    phase(f"5g the sequential lanes on the card: strategy=\"map\" and engine.simulate, 12 "
          f"presets at T={SEQ_T} and fig5's world at T={T_MAIN}")
    t0 = time.perf_counter()
    launches += sequential_phase()[0]
    print(f"phase 5g: {time.perf_counter() - t0:.1f} s; the script so far "
          f"{time.perf_counter() - t_start:.1f} s")

    h, w = FIGURES_CUT
    phase(f"5h the paper's figures at full width: {len(FIGURES_5H)} figures, "
          f"{len(FIGURES_REF)} grids at the quick widths, horizon cut to {h} s (warmup {w} s)")
    t0 = time.perf_counter()
    launches += figures_phase()
    print(f"phase 5h: {time.perf_counter() - t0:.1f} s; the script so far "
          f"{time.perf_counter() - t_start:.1f} s")

    print(kernels_line([{
        "name": "geo_schedule",
        "route": "cuda",
        "source": "src/repro_torch/csrc/geo_schedule.cu",
        "replaces": "src/repro/kernels/geo_schedule/geo_schedule.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": geo_dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + lm_records))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
