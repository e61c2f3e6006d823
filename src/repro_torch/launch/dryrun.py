"""Multi-node dry run: build every (architecture x input shape) cell on the
production meshes and extract the roofline's inputs (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
        --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/torch/dryrun.json

The planning tools touch no device: a cell's arguments are tensors on the
`meta` device (shapes and dtypes, no storage) and its mesh is a planning
shape (`launch.mesh.make_production_mesh`) that carries no devices, as the
reference forces host devices and never runs them. So these entry points
need no card, and they are the one set of the port's entry points that do
not default to it.

For each cell this records what the reference records, from other sources
since there is no compiler:

* per-device memory: each argument's bytes divided by the product of the
  mesh axes its partition spec splits it over (`argument_size_in_bytes`),
  and the same for the outputs under the output specs plus 8 bytes a leaf
  for the table of the output tuple (`output_size_in_bytes`), which is how
  XLA's `memory_analysis` counts them. There is no temp or code size;
* ``flops``: `torch.utils.flop_counter.FlopCounterMode` over the step on
  meta, divided by the mesh's size (the per-device share that XLA's cost
  analysis gives); ``bytes_accessed`` is -1, the reference's value when the
  cost analysis has none;
* ``collectives``: a table **derived from the sharding rules, not parsed**
  from HLO (`rule_collectives`), in the reference's key format, each group
  classified by the span of its device ids as `roofline._classify_link`
  classifies an HLO replica group;
* ``lower_s`` / ``compile_s``: the seconds to build the cell and to trace
  its step on meta.

A cell whose step cannot run on meta records ``status: "error"`` with the
reason, as the reference records a cell that fails to compile. The prefill
and decode cells reach `dist.sharding.cache_shardings`, which neither the
reference's sharding module nor the port's has: they fail as the
reference's do.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.launch.roofline import GPUS_PER_NODE, span_link

# XLA returns a step's outputs as one tuple: a pointer a leaf in its table
OUTPUT_TUPLE_ENTRY_BYTES = 8
ACT_BYTES = 2  # bf16 activations and weights gathered for the products
GRAD_BYTES = 4  # float32 gradients


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def build_cell(cfg, cell, mesh, accum: int | None = None, remat="full"):
    """Returns (fn, abstract_args, in_specs, out_specs, extra)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import data_size
    from repro_torch.models import model as mdl
    from repro_torch.models import stack
    from repro_torch.optim import adamw

    specs = mdl.input_specs(cfg, cell)

    if cell.kind == "train":
        if accum is None:
            per_dev = max(cell.global_batch // data_size(mesh), 1)
            accum = max(1, min(16, per_dev // 2))
            while cell.global_batch % accum or (cell.global_batch // accum) % data_size(mesh):
                accum //= 2
                accum = max(accum, 1)
                if accum == 1:
                    break
        opt = adamw.AdamWConfig()
        fn = mdl.make_train_step(cfg, opt, accum=accum, remat=remat)
        ap, ao = mdl.abstract_train_state(cfg)
        p_sh = sh.param_shardings(cfg, mesh, "train")
        o_sh = sh.opt_shardings(p_sh, mesh)
        b_sh = sh.batch_shardings(mesh, specs["batch"])
        args = (ap, ao, specs["batch"])
        in_sh = (p_sh, o_sh, b_sh)
        out_sh = (p_sh, o_sh, None)
        return fn, args, in_sh, out_sh, {"accum": accum}

    from repro_torch.models.schema import abstract_params

    ap = abstract_params(stack.build_schema(cfg))
    p_sh = sh.param_shardings(cfg, mesh, "decode")

    if cell.kind == "prefill":
        cache_len = cell.seq_len + 128
        fn = mdl.make_prefill_step(cfg, cache_len)
        b_sh = sh.batch_shardings(mesh, specs["batch"])
        # output cache sharding mirrors the decode cache layout
        enc_len = cell.seq_len if cfg.is_encdec else 0
        c_spec = stack.decode_cache_specs(cfg, cell.global_batch, cache_len, enc_len)
        c_sh = sh.cache_shardings(cfg, mesh, c_spec, cell.global_batch)
        l_sh = sh.logits_sharding(cfg, mesh, cell.global_batch)
        args = (ap, specs["batch"])
        return fn, args, (p_sh, b_sh), (l_sh, c_sh), {}

    # decode
    fn = mdl.make_decode_step(cfg)
    c_sh = sh.cache_shardings(cfg, mesh, specs["cache"], cell.global_batch)
    tok_sh = sh.batch_shardings(mesh, specs["token"])
    l_sh = sh.logits_sharding(cfg, mesh, cell.global_batch)
    args = (ap, specs["token"], specs["pos"], specs["cache"])
    return fn, args, (p_sh, tok_sh, tok_sh, c_sh), (l_sh, c_sh), {}


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------


def _pairs(tree, spec):
    """(tensor, its spec) for every tensor leaf of `tree`; a spec of None
    (or a missing one) replicates the whole subtree."""
    if isinstance(tree, torch.Tensor):
        yield tree, spec or ()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, spec.get(k) if isinstance(spec, dict) else None)
    elif isinstance(tree, (tuple, list)):
        fits = isinstance(spec, (tuple, list)) and len(spec) == len(tree)
        for v, s in zip(tree, spec if fits else [None] * len(tree)):
            yield from _pairs(v, s)


def _axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def shard_bytes(x: torch.Tensor, spec: tuple, mesh) -> int:
    """One device's bytes of `x` split by `spec` over `mesh`."""
    shape = list(x.shape)
    for i, entry in enumerate(spec):
        k = math.prod(mesh.shape[a] for a in _axes(entry))
        shape[i] = -(-shape[i] // k)
    return math.prod(shape) * x.element_size()


def per_device_bytes(tree, spec, mesh) -> int:
    return sum(shard_bytes(x, s, mesh) for x, s in _pairs(tree, spec))


def output_bytes(outs, spec, mesh) -> int:
    """`per_device_bytes` of a step's outputs plus the output tuple's table."""
    n = sum(1 for _ in _pairs(outs, spec))
    return per_device_bytes(outs, spec, mesh) + OUTPUT_TUPLE_ENTRY_BYTES * n


# ---------------------------------------------------------------------------
# the collectives table, derived from the sharding rules
# ---------------------------------------------------------------------------


def group_span(mesh, axes) -> int:
    """The span of device ids (row-major over the mesh's axes) of a group
    that varies `axes`: 1 + sum of (size - 1) x stride over those axes."""
    span, stride = 1, 1
    for name, size in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
        if name in axes:
            span += (size - 1) * stride
        stride *= size
    return span


def rule_collectives(cfg, cell, mesh, p_sh: dict, accum: int, remat="full",
                     pod_stride: int = GPUS_PER_NODE) -> dict:
    """The collectives of one train step under the train rules, as
    {"<kind>/<link>": result bytes on one device, "<kind>/count": ops},
    counted per layer, per microbatch and per forward pass (the forward, and
    the recompute under remat "full" / "dots"; the encoder and the tail are
    not recomputed):

    * FSDP: each weight split over the data axes is all-gathered over them
      (its bf16 bytes after the model split) once a forward pass;
    * the gradients' all-reduce over the data axes (float32, after the model
      split), once a microbatch;
    * tensor parallelism over "model": each block (a layer's mixer, FFN or
      cross-attention) with a weight split over "model" all-reduces its
      output once a forward pass and its input's gradient once in the
      backward ([rows, tokens, d_model] in bf16); the vocab-split embedding
      all-reduces its lookup and the head its input's gradient, once a
      microbatch, and the loss the row max and row sum of the vocab-split
      logits (float32).

    All-gather for the weights and all-reduce for the rest, none of it
    reduce-scatter, as the reference's compiled HLO shows."""
    from repro_torch.launch.mesh import data_axes, data_size
    from repro_torch.models import stack

    if cell.kind != "train":
        raise ValueError(f"rule_collectives models train cells, got a {cell.kind} cell")
    out: dict = {}

    def add(kind, axes, nbytes, count):
        if count <= 0 or nbytes <= 0:
            return
        key = f"{kind}/{span_link(group_span(mesh, axes), pod_stride)}"
        out[key] = out.get(key, 0) + nbytes * count
        out[f"{kind}/count"] = out.get(f"{kind}/count", 0) + count

    data, dsize = data_axes(mesh), data_size(mesh)
    msize = mesh.shape.get("model", 1)
    recompute = remat in (True, "full", "dots")
    schema = stack.build_schema(cfg)

    def split(spec, over) -> int:
        return math.prod(mesh.shape[a] for e in spec for a in _axes(e) if a in over)

    def passes(name) -> int:
        return 2 if recompute and name.startswith("blk") else 1

    blocks: dict = {}
    for name, spec in p_sh.items():
        ps = schema[name]
        layers = ps.shape[0] if ps.axes and ps.axes[0] == "layers" else 1
        per_layer = math.prod(ps.shape) // layers // split(spec, ("model",))
        if split(spec, data) > 1:
            add("all-gather", data, per_layer * ACT_BYTES, layers * accum * passes(name))
        if dsize > 1:
            add("all-reduce", data, per_layer * GRAD_BYTES, layers * accum)
        if "." in name:
            blk = name.rsplit(".", 1)[0]
            tp = blocks.get(blk, (layers, False))[1] or split(spec, ("model",)) > 1
            blocks[blk] = (layers, tp)

    if msize > 1:
        rows = max(cell.global_batch // accum // dsize, 1)
        enc_tokens = cell.seq_len
        tokens = max(cell.seq_len // 4, 128) if cfg.is_encdec else cell.seq_len
        for blk, (layers, tp) in blocks.items():
            if tp:
                x = rows * (enc_tokens if blk.startswith("eblk") else tokens) * cfg.d_model
                add("all-reduce", ("model",), x * ACT_BYTES, layers * accum * (passes(blk) + 1))
        x = rows * tokens * cfg.d_model * ACT_BYTES
        if split(p_sh["embed"], ("model",)) > 1:
            add("all-reduce", ("model",), x, accum)
        head = p_sh.get("lm_head", p_sh["embed"])
        if split(head, ("model",)) > 1:
            add("all-reduce", ("model",), x, accum)
            add("all-reduce", ("model",), rows * tokens * 4, 2 * accum)
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def trace(fn, args):
    """Run `fn(*args)` (tensors on meta) under the FLOP counter: (outputs,
    total FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        outs = fn(*args)
    return outs, counter.get_total_flops()


def run_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import LM_SHAPES

    cfg = registry.get(arch)
    cell = {c.name: c for c in LM_SHAPES}[shape]
    mname = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mname, "kind": cell.kind}
    if shape == "long_500k" and not cfg.long_context_capable:
        rec["status"] = "skipped"
        rec["reason"] = "pure full-attention arch; long_500k skipped per DESIGN.md"
        return rec

    try:
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod)
        fn, args, in_sh, out_sh, extra = build_cell(cfg, cell, mesh)
        rec.update(extra)
        t1 = time.time()
        outs, flops = trace(fn, args)
        t2 = time.time()
    except Exception as e:  # the reference's record of a cell that fails to compile
        return {"arch": arch, "shape": shape, "mesh": mname, "status": "error",
                "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
    rec["status"] = "ok"
    rec["lower_s"] = round(t1 - t0, 1)
    rec["compile_s"] = round(t2 - t1, 1)
    rec["argument_size_in_bytes"] = per_device_bytes(args, in_sh, mesh)
    rec["output_size_in_bytes"] = output_bytes(outs, out_sh, mesh)
    rec["flops"] = float(flops / mesh.size)
    rec["bytes_accessed"] = -1.0
    rec["collectives"] = rule_collectives(cfg, cell, mesh, in_sh[0], extra["accum"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun.json")
    ap.add_argument("--hlo-dir", default=None,
                    help="the reference's option; the port has no HLO, so nothing is written")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.models.config import LM_SHAPES

    archs = registry.names() if (args.all or not args.arch) else [args.arch]
    shapes = [c.name for c in LM_SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out.read_text()) if out.exists() else []
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mname = "2x16x16" if mp else "16x16"
                if (arch, shape, mname) in done:
                    print(f"[skip-done] {arch} {shape} {mname}", flush=True)
                    continue
                print(f"[dryrun] {arch} {shape} {mname} ...", flush=True)
                rec = run_cell(arch, shape, mp)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != (arch, shape, mname)] + [rec]
                out.write_text(json.dumps(results, indent=1))
                status = rec.get("status")
                msg = rec.get("error", "")[:120] if status == "error" else (
                    f"flops={rec.get('flops', 0):.3g} compile={rec.get('compile_s', 0)}s"
                    if status == "ok"
                    else rec.get("reason", "")
                )
                print(f"[{status}] {arch} {shape} {mname} {msg}", flush=True)
    return results


if __name__ == "__main__":
    main()
