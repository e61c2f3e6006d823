"""Times hand-written kernels of the training and serving paths with CUDA events,
on one card: the backward kernels of flash attention (B3's), of the mLSTM
(B5's) and of the RG-LRU (B4's), and decode attention's int8 entry (B2's).

    python3 time_backwards.py [--tree DIR] [--iters N] [--only GROUPS]
                              [--save FILE | --compare FILE]

`--tree` times another checkout of this repository (its own `chip_smoke.py`
and `src/repro_torch`, its kernels built into its own `build/`), so an
earlier design can be timed beside this one on the same card: unpack a
commit with `git archive <commit> | tar -x -C build/<dir>` and run the two
trees in turns (earlier, this, this, earlier). The shapes are the tree's
own `chip_smoke.BWD_MAIN` (llama3.2-3b, 20e), `BWD_RG` (recurrentgemma-9b's
local attention, 21d) and the mLSTM's [2, 4, 2048, 256] (xlstm-350m, 21d),
all bf16; the RG-LRU backward's fused and contract entries at 21b's shape
(`recurrent_train_shapes`, recurrentgemma-9b's [2, 2048, 4096]) in
float32; the int8 entry at `INT8_DECODE_CASES[0]` (h2o-danube-3-4b's full
ring) and `[2]` (llama3.2-3b's linear cache), each beside the bf16 entry on
the dequantized cache, both as bare entry points (split and merge, no
wrapper). Each input comes from the tree's own forward.
`--only` takes a comma-separated subset of the groups flash, mlstm, rglru
and int8 (default: all).

`--save FILE` writes the RG-LRU backward's outputs at 21b's shape for each
entry (contract, fused, fused_h0; float32) with a digest of their inputs;
`--compare FILE` makes the inputs in this tree, says whether their digest
is the saved one, and whether every output equals the saved one bit for
bit (so a redesign can be held to the kernel it replaces: save with
`--tree` the earlier checkout).

Prints the card's name and power limit, one line a shape and, last, one
JSON object of the milliseconds a call. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

MLSTM_MAIN = (2, 4, 2048, 256)
RGLRU_ENTRIES = ("contract", "fused", "fused_h0")
GROUPS = ("flash", "mlstm", "rglru", "int8")
DECODE_ITERS = 200  # calls a CUDA-event timing of a decode entry (~0.05 ms a call)


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes (None for a missing one), in order."""
    import torch

    h = hashlib.sha256()
    for x in tensors:
        h.update(b"none" if x is None else x.contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def rglru_outputs(cs, r_ops, case, dev) -> dict:
    """For each entry: the digest of the backward's inputs and its outputs
    on the CPU."""
    import torch

    out = {}
    for entry in RGLRU_ENTRIES:
        args, kw = cs.rglru_bwd_inputs(case, torch.float32, dev, 1, entry)
        got = r_ops.rglru_bwd(*args, **kw)
        out[entry] = {"inputs": digest(list(args) + [kw.get("h0")]),
                      "outputs": [None if x is None else x.cpu() for x in got]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent),
                    help="the checkout whose kernels are timed (default: this one)")
    ap.add_argument("--iters", type=int, default=10, help="calls a CUDA-event timing")
    ap.add_argument("--only", default=",".join(GROUPS), help="groups timed (default: all)")
    io = ap.add_mutually_exclusive_group()
    io.add_argument("--save", help="write the RG-LRU backward's outputs at 21b's shape here")
    io.add_argument("--compare", help="hold this tree's RG-LRU backward to a --save file")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only: unknown groups {sorted(only - set(GROUPS))}")
    tree = pathlib.Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("time_backwards.py: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.rglru import ops as r_ops

    if pathlib.Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s chip_smoke.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    out = {}
    if "flash" in only:
        for key, case in (("flash_main", cs.BWD_MAIN), ("flash_rg", cs.BWD_RG)):
            fargs, kw = cs.bwd_inputs(case, bf16, dev, 1)
            out[key] = cs.cuda_ms(lambda: f_ops.mha_backward(*fargs, **kw), args.iters)
            print(f"flash backward {case} bf16: {out[key]:.4f} ms", flush=True)
    if "mlstm" in only:
        margs = cs.mlstm_bwd_inputs(MLSTM_MAIN, bf16, dev, 1)
        out["mlstm"] = cs.cuda_ms(lambda: m_ops.mlstm_bwd(*margs), args.iters)
        print(f"mlstm backward {MLSTM_MAIN} bf16: {out['mlstm']:.4f} ms", flush=True)
    r_main = cs.recurrent_train_shapes()[1]
    if "rglru" in only:
        for entry in ("fused", "contract"):
            rargs, kw = cs.rglru_bwd_inputs(r_main, f32, dev, 1, entry)
            out[f"rglru_{entry}"] = cs.cuda_ms(lambda: r_ops.rglru_bwd(*rargs, **kw), args.iters)
            print(f"rglru backward {r_main} float32 {entry}: {out[f'rglru_{entry}']:.4f} ms",
                  flush=True)
    if "int8" in only:  # the bare entry points (split and merge, no wrapper)
        from repro_torch.kernels.decode_attention import decode_attention as d_bind
        from repro_torch.kernels.decode_attention import ops as d_ops
        from repro_torch.kernels.decode_attention.ref import kv_dequantize

        for key, i in (("int8_h2o", 0), ("int8_llama", 2)):
            case = cs.INT8_DECODE_CASES[i]
            q, k8, v8, ks, vs, valid = cs.int8_inputs(case, bf16, dev, 1)
            kd, vd = kv_dequantize(k8, ks, bf16), kv_dequantize(v8, vs, bf16)
            a8 = d_ops.prepare(q, k8, v8, valid, k_scale=ks, v_scale=vs)[1]
            ab = d_ops.prepare(q, kd, vd, valid)[1]
            out[key] = cs.cuda_ms(lambda: d_bind.run(a8), DECODE_ITERS)
            out[f"{key}_bf16"] = cs.cuda_ms(lambda: d_bind.run(ab), DECODE_ITERS)
            print(f"decode int8 {case}: {out[key]:.4f} ms, the bf16 entry on the dequantized "
                  f"cache {out[f'{key}_bf16']:.4f} ms (bare entry points)", flush=True)
    if args.save or args.compare:
        got = rglru_outputs(cs, r_ops, r_main, dev)
        if args.save:
            torch.save(got, args.save)
            print(f"rglru backward {r_main} float32: outputs of {', '.join(got)} saved to "
                  f"{args.save}", flush=True)
        else:
            saved = torch.load(args.compare)
            same = {}
            for entry, g in got.items():
                s = saved[entry]
                same[entry] = {"inputs": g["inputs"] == s["inputs"],
                               "outputs": [(a is None and b is None) or (
                                   a is not None and b is not None and torch.equal(a, b))
                                   for a, b in zip(g["outputs"], s["outputs"])]}
            out["rglru_bitwise"] = same
            print(f"rglru backward {r_main} float32 against {args.compare} (inputs equal; "
                  f"dlog_a, dx, dh0 equal bit for bit): {same}", flush=True)
    print(json.dumps({"tree": str(tree), "device": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
