"""Training launcher: real end-to-end training (port of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 200 --batch 16 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

The reference's options, output lines and returned loss list, plus
`--device` (default: the card). It integrates the port's substrate: the
local mesh (`launch.mesh.make_local_mesh`, printed on the first line as
the reference prints it), the reference's initial weights for seed 0
(`init_params_threefry`), AdamW, the deterministic data pipeline and GeoTP
one-round-commit checkpointing with restart recovery. It trains on
`--device` itself: the mesh's data axis has one device on the chip host
(`--device cpu` gives ``devices=1``). As the reference's launcher does, it
calls no gradient compression (`dist.compression`; ROADMAP.md §C, C12).

Two of the reference's semantics are kept as they are (ROADMAP.md §C):
`--reduced` is `store_true` with default True, so the launcher always
trains the config's reduced form (C10); and `--resume` restores the
parameters only, so AdamW's moments and step restart and the schedule
warms up again (C11).
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.device import resolve_device
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as mdl, stack
    from repro_torch.models.schema import init_params_threefry
    from repro_torch.optim import adamw

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    cfg = registry.reduced(args.arch) if args.reduced else registry.get(args.arch)
    mesh = make_local_mesh(device=dev)
    print(f"[train] arch={cfg.name} devices={len(mesh.devices)} mesh={mesh.shape}")

    params = init_params_threefry(stack.build_schema(cfg), 0, dev)
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1))
    opt_state = adamw.init_state(params)
    step_fn = mdl.make_train_step(cfg, opt, accum=args.accum)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    start = 0
    ckpt = CheckpointManager(args.ckpt_dir, n_hosts=1) if args.ckpt_dir else None
    if ckpt and args.resume:
        latest = ckpt.recover()
        if latest is not None:
            params = ckpt.restore(latest, 0, params)  # parameters only (C11)
            start = latest
            print(f"[train] resumed from committed step {latest}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = global_batch(dcfg, step, dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) / max(time.time() - t0, 1e-9)
            print(
                f"step {step:5d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} tok/s {tok_s:,.0f}",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.write_shard(step + 1, 0, params)  # decentralized prepare
            if not ckpt.commit(step + 1):  # one-round commit
                raise RuntimeError(f"checkpoint of step {step + 1} was not prepared")
            print(f"[ckpt] committed step {step+1}")
    print(f"[train] loss {losses[0]:.3f} -> {losses[-1]:.3f} in {time.time()-t0:.0f}s")
    return losses


if __name__ == "__main__":
    main()
