"""Times the hand-written backward kernels of flash attention (B3's) and of the
mLSTM (B5's) at the training path's shapes, with CUDA events, on one card.

    python3 time_backwards.py [--tree DIR] [--iters N]

`--tree` times another checkout of this repository (its own `chip_smoke.py`
and `src/repro_torch`, its kernels built into its own `build/`), so an
earlier design can be timed beside this one on the same card: unpack a
commit with `git archive <commit> | tar -x -C build/<dir>` and run the two
trees in turns (earlier, this, this, earlier). The shapes are the tree's
own `chip_smoke.BWD_MAIN` (llama3.2-3b, 20e), `BWD_RG` (recurrentgemma-9b's
local attention, 21d) and the mLSTM's [2, 4, 2048, 256] (xlstm-350m, 21d),
all bf16; each input comes from the tree's own forward. Prints the card's
name and power limit, one line a shape and, last, one JSON object of the
milliseconds a call. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

MLSTM_MAIN = (2, 4, 2048, 256)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent),
                    help="the checkout whose kernels are timed (default: this one)")
    ap.add_argument("--iters", type=int, default=10, help="calls a CUDA-event timing")
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("time_backwards.py: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.mlstm import ops as m_ops

    if pathlib.Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s chip_smoke.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    for key, case in (("flash_main", cs.BWD_MAIN), ("flash_rg", cs.BWD_RG)):
        fargs, kw = cs.bwd_inputs(case, bf16, dev, 1)
        out[key] = cs.cuda_ms(lambda: f_ops.mha_backward(*fargs, **kw), args.iters)
        print(f"flash backward {case} bf16: {out[key]:.4f} ms", flush=True)
    margs = cs.mlstm_bwd_inputs(MLSTM_MAIN, bf16, dev, 1)
    out["mlstm"] = cs.cuda_ms(lambda: m_ops.mlstm_bwd(*margs), args.iters)
    print(f"mlstm backward {MLSTM_MAIN} bf16: {out['mlstm']:.4f} ms", flush=True)
    print(json.dumps({"tree": str(tree), "device": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
