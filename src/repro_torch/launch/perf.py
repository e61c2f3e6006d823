"""Perf hillclimb driver: run a named variant of a chosen cell, re-build +
re-analyze, and append (hypothesis, before, after) to
results/torch/perf_iterations.json (port of `repro.launch.perf`).

    PYTHONPATH=src python -m repro_torch.launch.perf --variant mixtral_remat

A cell is built as `launch.dryrun` builds it (tensors on `meta`, the planning
mesh: no device is touched, no card is needed). The terms are the roofline's
with the H100's constants (`launch.roofline`): the analytic model's FLOPs and
HBM bytes, and the collectives derived from the sharding rules
(`dryrun.rule_collectives`). There is no compiler, so no temp bytes (None)
and no HLO (``hlo_tag`` names nothing written). The two decode variants
(`qwen2_int8_kv`, `xlstm_tp_off`) reach `dist.sharding.cache_shardings`,
which neither package has, and raise as the reference's do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib


def _analyze(cfg, cell, multi_pod=False, accum=None, remat="full", hlo_tag=None):
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod)
    fn, args, in_sh, out_sh, extra = dryrun.build_cell(cfg, cell, mesh, accum=accum, remat=remat)
    chips = 512 if multi_pod else 256
    t = rl.cell_terms(cfg, cell, chips, remat=remat)
    colls = dryrun.rule_collectives(cfg, cell, mesh, in_sh[0], extra["accum"], remat=remat)
    t_ici, t_dcn = rl.collective_seconds(colls)
    terms = {
        "t_compute_s": t["t_compute_s"],
        "t_memory_s": t["t_memory_s"],
        "t_collective_s": (t_ici + t_dcn) / chips,
    }
    bound = max(terms.values())
    return {
        **terms,
        "bottleneck": max(terms, key=terms.get),
        "roofline_step_s": bound,
        "mfu_bound": t["model_flops"] / (chips * rl.PEAK_FLOPS) / max(bound, 1e-30),
        "useful_ratio": t["useful_ratio"],
        "temp_bytes": None,
        "collectives": {k: v for k, v in colls.items() if not k.endswith("count")},
        **extra,
    }


def variant_qwen2_int8_kv():
    """HYPOTHESIS: qwen2-72b decode_32k is memory-bound; KV-cache reads are
    1.37 TB of the 1.66 TB step traffic (83%). int8 cache (+f32 per-token-head
    scales) cuts cache bytes ~1.94x => memory term 0.00725 -> ~0.0040 s
    (~1.8x), bottleneck stays memory. Accuracy cost measured at <1.5% max
    logit deviation (tests/models/test_int8_cache.py).
    The seconds above were reckoned for the reference's TPU mesh; the port
    prints its own, with the H100's constants."""
    from repro_torch.configs import registry
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get("qwen2-72b")
    cell = {c.name: c for c in LM_SHAPES}["decode_32k"]
    before = _analyze(cfg, cell)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    after = _analyze(cfg8, cell, hlo_tag="qwen2_int8_kv")
    return "qwen2-72b/decode_32k/16x16", variant_qwen2_int8_kv.__doc__, before, after


def variant_mixtral_remat_policy():
    """HYPOTHESIS: mixtral-8x7b train_4k is compute-bound with useful-FLOP
    ratio 0.51; full per-group remat contributes 1x extra forward (factor 4/6).
    Saving matmul outputs (checkpoint_dots policy) recomputes only elementwise
    ops: factor 4.0 -> ~3.1 => compute term 3.15 -> ~2.45 s (1.29x), useful
    ratio 0.51 -> ~0.66, provided the saved dots still fit HBM.
    The seconds above were reckoned for the reference's TPU mesh; the port
    prints its own, with the H100's constants."""
    from repro_torch.configs import registry
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get("mixtral-8x7b")
    cell = {c.name: c for c in LM_SHAPES}["train_4k"]
    before = _analyze(cfg, cell, remat="full")
    after = _analyze(cfg, cell, remat="dots", hlo_tag="mixtral_dots")
    return "mixtral-8x7b/train_4k/16x16", variant_mixtral_remat_policy.__doc__, before, after


def variant_mixtral_capacity():
    """HYPOTHESIS: MoE capacity factor 1.25 processes 25% more expert tokens
    than top-2 routing needs; cf=1.0 (drop-on-overflow, standard practice)
    cuts expert+dispatch FLOPs by 20% => compute term additionally ~1.1x.
    The ratio above was reckoned for the reference's TPU mesh; the port
    prints its own terms, with the H100's constants."""
    from repro_torch.configs import registry
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get("mixtral-8x7b")
    cell = {c.name: c for c in LM_SHAPES}["train_4k"]
    before = _analyze(cfg, cell, remat="dots")
    cfg2 = dataclasses.replace(cfg, capacity_factor=1.0)
    after = _analyze(cfg2, cell, remat="dots", hlo_tag="mixtral_cf1")
    return "mixtral-8x7b/train_4k/16x16", variant_mixtral_capacity.__doc__, before, after


def variant_xlstm_tp_off():
    """HYPOTHESIS: xlstm-350m decode_32k is the most collective-heavy cell
    (K/C = 13): d_model=1024 sharded 16-way leaves 64-wide per-chip matmuls
    and an all-reduce per block. Dropping TP for this small model (params
    replicated on the model axis, pure batch parallelism + sequence-sharded
    ring conv states) removes the per-block all-reduces; params bytes/chip
    rise 16x but stay tiny (0.5 GB bf16) — net win iff K_before > (P*(16-1)/16)/BW.
    The figures above were reckoned for the reference's TPU mesh; the port
    prints its own, with the H100's constants."""
    from repro_torch.configs import registry
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import roofline as rl
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get("xlstm-350m")
    cell = {c.name: c for c in LM_SHAPES}["decode_32k"]
    before = _analyze(cfg, cell)

    # monkey-patch decode rules: no tensor parallelism
    orig = sh.decode_rules

    def no_tp_rules(mesh):
        r = dict(orig(mesh))
        r.update({"heads": None, "kv": None, "mlp": None, "vocab": None})
        return r

    sh.decode_rules = no_tp_rules
    try:
        after = _analyze(cfg, cell, hlo_tag="xlstm_no_tp")
        # params replicated: per-chip memory term must account full param reads
        P_bytes = cfg.params_dense() * 2
        extra = P_bytes * (256 - 1) / 256 / rl.HBM_BW  # was sharded, now full
        after["t_memory_s"] = after["t_memory_s"] + extra * 256 / 256
        after["note"] = "memory term adjusted: params replicated (read full copy/chip)"
        terms = {k: after[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s")}
        after["bottleneck"] = max(terms, key=terms.get)
        after["roofline_step_s"] = max(terms.values())
    finally:
        sh.decode_rules = orig
    return "xlstm-350m/decode_32k/16x16", variant_xlstm_tp_off.__doc__, before, after


VARIANTS = {
    "qwen2_int8_kv": variant_qwen2_int8_kv,
    "mixtral_remat": variant_mixtral_remat_policy,
    "mixtral_capacity": variant_mixtral_capacity,
    "xlstm_tp_off": variant_xlstm_tp_off,
}


def run_variant(name: str, log="results/torch/perf_iterations.json") -> dict:
    """Run one variant, print its terms before and after, and append the
    entry to `log` (an entry of the same variant is replaced)."""
    cell, hypothesis, before, after = VARIANTS[name]()
    entry = {
        "variant": name,
        "cell": cell,
        "hypothesis": " ".join(hypothesis.split()),
        "before": before,
        "after": after,
        "speedup_dominant": before["roofline_step_s"] / max(after["roofline_step_s"], 1e-30),
    }
    p = pathlib.Path(log)
    prior = json.loads(p.read_text()) if p.exists() else []
    prior = [e for e in prior if e["variant"] != name] + [entry]
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(prior, indent=1))
    print(f"[{name}] {cell}")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "roofline_step_s",
              "mfu_bound", "useful_ratio"):
        print(f"  {k:18s} before={before.get(k)}  after={after.get(k)}")
    print(f"  dominant-term speedup: {entry['speedup_dominant']:.2f}x")
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--log", default="results/torch/perf_iterations.json")
    args = ap.parse_args(argv)
    return run_variant(args.variant, args.log)


if __name__ == "__main__":
    main()
