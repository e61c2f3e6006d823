"""Roofline analysis: three terms per (arch x shape x mesh), with the H100's
constants (port of `repro.launch.roofline`).

  compute term    = FLOPs / (chips * PEAK_FLOPS)     [dense bf16 a GPU]
  memory term     = HBM bytes / (chips * HBM_BW)
  collective term = collective bytes / (chips * link rate)

The card is the SXM5 H100 ("NVIDIA H100 80GB HBM3, 700.00 W"). The record
keys are the reference's, so that two records compare key for key; on this
card the link classes mean:

* ``ici`` — the NVLink domain of one node: the 8 GPUs of an HGX board
  (NVLink 4 through the NVSwitches), so a group whose device ids span at
  most ``pod_stride`` = 8 stays inside a node;
* ``dcn`` — InfiniBand between nodes (NDR, one 400 Gb/s port a GPU).

FLOPs and HBM bytes come from the analytic model (`models.flops`), exact for
the stack's products. Collective bytes come from the dry run's record
(`launch.dryrun`: a table derived from the sharding rules), or, with
``--hlo-dir``, from a loop-aware parse of the reference's optimized HLO dumps
(while-body collectives multiplied by their trip counts). The HLO functions
are the reference's, copied; the port writes no HLO of its own.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun results/torch/dryrun.json --out results/torch/roofline.json
"""

from __future__ import annotations

import argparse
import json
import math
import re
from pathlib import Path

PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores, NVIDIA H100 80GB HBM3, 700.00 W
HBM_BW = 3.35e12  # bytes/s, NVIDIA H100 80GB HBM3, 700.00 W
NVLINK_BW = 450e9  # bytes/s a direction, NVLink 4 in an 8-GPU HGX node (H100 SXM5)
IB_BW = 50e9  # bytes/s a GPU between nodes, NDR InfiniBand (400 Gb/s), H100 SXM5 nodes
GPUS_PER_NODE = 8  # the default pod_stride: ids farther apart cross InfiniBand

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{(\d+)(?:,(\d+))?")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_COMP_RE = re.compile(r"^(?:ENTRY )?%?([\w\.\-]+)(?:\.clone)? \([^)]*\) -> ", re.M)
_WHILE_RE = re.compile(r"while\(.*?\), condition=%?([\w\.\-]+), body=%?([\w\.\-]+)")
_CMP_RE = re.compile(r"compare\(%?[\w\.\-]+, %?([\w\.\-]+)\), direction=LT")
_CALL_RE = re.compile(r"(?:call|fusion)\(.*?\).*?(?:to_apply|calls)=%?([\w\.\-]+)")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def split_computations(hlo: str) -> dict:
    """name -> body text."""
    comps = {}
    starts = [(m.start(), m.group(1)) for m in _COMP_RE.finditer(hlo)]
    for i, (pos, name) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else len(hlo)
        comps[name] = hlo[pos:end]
    return comps


def span_link(span: int, pod_stride: int) -> str:
    """A group whose device ids span more than `pod_stride` crosses nodes."""
    return "dcn" if span > pod_stride else "ici"


def _classify_link(line: str, pod_stride: int) -> str:
    g = _GROUPS_RE.search(line)
    if g and g.group(2) is not None:
        return "dcn" if abs(int(g.group(2)) - int(g.group(1))) >= pod_stride else "ici"
    gi = _GROUPS_IOTA_RE.search(line)
    if gi:
        group_size = int(gi.group(2))
        dims = [int(x) for x in gi.group(3).split(",")]
        transpose = gi.group(4)
        # contiguous groups: stride 1; spanning more than pod_stride ids => dcn
        if transpose:
            # transposed iota: members stride by the product of the trailing dims
            stride = 1
            perm = [int(x) for x in transpose.split(",")]
            if perm and perm[0] != 0:
                stride = math.prod(dims[1:]) if len(dims) > 1 else 1
            return span_link(group_size * stride, pod_stride)
        return span_link(group_size, pod_stride)
    return "ici"


def loop_aware_collectives(hlo: str, pod_stride: int = GPUS_PER_NODE) -> dict:
    """{"<kind>/<link>": result bytes, "<kind>/count": ops} over an optimized
    HLO module, each collective multiplied by the trip counts of the while
    loops around it."""
    comps = split_computations(hlo)
    # trip counts per body computation
    trip: dict = {}
    for name, body in comps.items():
        for m in _WHILE_RE.finditer(body):
            cond, wbody = m.group(1), m.group(2)
            t = None
            cbody = comps.get(cond, "")
            cm = _CMP_RE.search(cbody)
            if cm:
                km = re.search(re.escape(cm.group(1)) + r" = s32\[\] constant\((\d+)\)", cbody)
                if km:
                    t = int(km.group(1))
            trip.setdefault(name, []).append((wbody, t if t else 1))
    # multiplier per computation: DFS from the entry
    entry = None
    for name in comps:
        if "ENTRY" in comps[name][:200] or name.endswith("main") or ".main" in name:
            entry = name
    if entry is None:
        entry = list(comps)[-1]
    mult = {entry: 1}
    stack = [entry]
    while stack:
        cur = stack.pop()
        for wbody, t in trip.get(cur, []):
            m = mult.get(cur, 1) * max(t, 1)
            if mult.get(wbody, 0) < m:
                mult[wbody] = m
                stack.append(wbody)
    # then through call / fusion edges with multiplier 1
    changed = True
    passes = 0
    while changed and passes < 10:
        changed = False
        passes += 1
        for name, body in comps.items():
            base = mult.get(name)
            if base is None:
                continue
            for cm in _CALL_RE.finditer(body):
                callee = cm.group(1)
                if callee in comps and mult.get(callee, 0) < base:
                    mult[callee] = base
                    changed = True

    out: dict = {}
    for name, body in comps.items():
        m = mult.get(name, 1)
        for line in body.splitlines():
            cm = _COLL_RE.search(line)
            if not cm:
                continue
            kind = cm.group(3)
            nbytes = _shape_bytes(cm.group(1) or cm.group(2))
            key = f"{kind}/{_classify_link(line, pod_stride)}"
            out[key] = out.get(key, 0) + nbytes * m
            out[f"{kind}/count"] = out.get(f"{kind}/count", 0) + m
    return out


# ring-collective traffic factor applied to the RESULT-shape bytes
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_seconds(colls: dict) -> tuple:
    """(NVLink seconds, InfiniBand seconds) of a collectives table."""
    ici = dcn = 0.0
    for key, nbytes in colls.items():
        if key.endswith("/count"):
            continue
        kind, link = key.split("/")
        traffic = nbytes * _TRAFFIC_FACTOR.get(kind, 1.0)
        if link == "dcn":
            dcn += traffic / IB_BW
        else:
            ici += traffic / NVLINK_BW
    return ici, dcn


def cell_terms(cfg, cell, chips: int, remat: str = "full") -> dict:
    """The analytic model's numbers for one cell over `chips` GPUs: FLOPs
    (`cell_flops`, `remat`'s recompute included), HBM bytes, and the compute
    and memory terms in seconds."""
    from repro_torch.models import flops as fl

    ff = fl.cell_flops(cfg, cell, remat=remat)
    hbm = fl.cell_hbm_bytes(cfg, cell)
    return {
        "analytic_flops": ff["total"],
        "model_flops": ff["model"],
        "useful_ratio": ff["model"] / max(ff["total"], 1),
        "analytic_hbm_bytes": hbm,
        "t_compute_s": ff["total"] / (chips * PEAK_FLOPS),
        "t_memory_s": hbm / (chips * HBM_BW),
    }


def analyze_cell(rec: dict, hlo_dir: str | None) -> dict:
    from repro_torch.configs import registry
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get(rec["arch"])
    cell = {c.name: c for c in LM_SHAPES}[rec["shape"]]
    chips = 512 if rec["mesh"] == "2x16x16" else 256

    out = dict(rec)
    out["chips"] = chips
    out.update(cell_terms(cfg, cell, chips))

    colls = rec.get("collectives", {})
    if hlo_dir:
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x', '-')}"
        p = Path(hlo_dir) / f"{tag}.hlo.txt"
        if p.exists():
            colls = loop_aware_collectives(p.read_text())
            out["collectives_loop_aware"] = colls
    # collective bytes are whole-program; per-chip share = /chips
    t_ici, t_dcn = collective_seconds(colls)
    out["t_collective_s"] = (t_ici + t_dcn) / chips
    out["t_collective_ici_s"] = t_ici / chips
    out["t_collective_dcn_s"] = t_dcn / chips

    terms = {
        "compute": out["t_compute_s"],
        "memory": out["t_memory_s"],
        "collective": out["t_collective_s"],
    }
    out["bottleneck"] = max(terms, key=terms.get)
    bound = max(terms.values())
    out["roofline_step_s"] = bound
    out["roofline_fraction"] = out["t_compute_s"] / max(bound, 1e-30)
    out["mfu_bound"] = out["model_flops"] / (chips * PEAK_FLOPS) / max(bound, 1e-30)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/torch/dryrun.json")
    ap.add_argument("--hlo-dir", default=None,
                    help="a directory of the reference's HLO dumps to parse (the port writes none)")
    ap.add_argument("--out", default="results/torch/roofline.json")
    ap.add_argument("--markdown", default="results/torch/roofline.md")
    args = ap.parse_args(argv)

    with open(args.dryrun) as f:
        recs = json.load(f)
    out = []
    for rec in recs:
        if rec.get("status") != "ok":
            out.append(rec)
            continue
        out.append(analyze_cell(rec, args.hlo_dir))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)

    rows = [r for r in out if r.get("status") == "ok"]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    Path(args.markdown).parent.mkdir(parents=True, exist_ok=True)
    with open(args.markdown, "w") as f:
        f.write(
            "| arch | shape | mesh | compute s | memory s | collective s (ici/dcn) | "
            "bottleneck | useful FLOP ratio | MFU bound |\n|---|---|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            f.write(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['t_compute_s']:.4g} | "
                f"{r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} "
                f"({r['t_collective_ici_s']:.3g}/{r['t_collective_dcn_s']:.3g}) | "
                f"{r['bottleneck']} | {r['useful_ratio']:.2f} | {r['mfu_bound']:.3f} |\n"
            )
    print(f"wrote {args.out} and {args.markdown} ({len(rows)} cells)")
    return out


if __name__ == "__main__":
    main()
