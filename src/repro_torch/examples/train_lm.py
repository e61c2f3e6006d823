"""End-to-end training driver through the port: a ~100M-parameter
llama-style config with checkpoint / restart, the counterpart of the
reference's `examples/train_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

As in the reference, the count printed is the ~100M config's, but the
launcher's `--reduced` is always on (ROADMAP.md §C, C10), so what trains is
its reduced form: d_model 128, one layer, vocab 512.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs import registry
from repro_torch.launch import train as trainer
from repro_torch.models.schema import param_count
from repro_torch.models.stack import build_schema


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_100m"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ~100M-param llama3-family config (d=768, 12 layers)
    cfg100m = dataclasses.replace(
        registry.get("llama3.2-3b"),
        name="llama3-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab=32000,
        tie_embeddings=True,
    )
    registry.register(cfg100m)
    print(f"params: {param_count(build_schema(cfg100m))/1e6:.1f}M")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    device = [] if args.device is None else ["--device", args.device]
    losses = trainer.main(
        [
            "--arch", "llama3-100m",
            "--steps", str(args.steps),
            "--batch", "16",
            "--seq", "256",
            "--lr", "6e-4",
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "100",
            *device,
        ]
    )
    if not losses[-1] < losses[0]:
        raise AssertionError("loss must decrease")
    print("OK: loss decreased; checkpoints committed with one-round protocol.")
    return losses


if __name__ == "__main__":
    main()
