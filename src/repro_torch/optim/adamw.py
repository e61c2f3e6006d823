"""AdamW + schedules (port of `repro.optim.adamw`).

State layout mirrors the parameter dict ({'m': {name: tensor}, 'v': ...,
'step': int32 scalar}), m and v in float32, so a checkpoint or a later
sharding treats optimizer state exactly like parameters. Plain tensor ops:
the reference has no kernel here, and an update reads and writes each leaf
a few times (memory-bound on the card).

`apply_updates` updates the parameters, m and v IN PLACE (the reference
returns new arrays; at llama3.2-3b's full width a second copy of 3.2B
float32 masters and their moments would not fit beside them) and returns
the same dicts. The arithmetic is the reference's, op for op, in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32, on step's device)."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(s < cfg.warmup_steps, 1.0, cos)


def init_state(params: dict) -> dict:
    """Zero moments (float32, each parameter's shape and device) and step 0."""
    dev = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_state(abstract_params: dict) -> dict:
    """The state's shapes and dtypes as tensors on the `meta` device."""
    z = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
         for n, p in abstract_params.items()}
    return {"m": z, "v": {n: torch.empty_like(t) for n, t in z.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt(sum of squares) over the leaves in sorted-name order (the
    reference's tree order), each leaf's sum in float32."""
    total = 0
    for n in sorted(tree):
        total = total + torch.sum(tree[n].float() ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step (with global-norm clipping). Returns (params, state,
    stats): the parameters, m and v updated in place, a new int32 step,
    stats {"grad_norm", "lr"} (float32 scalars)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m.mul_(b1).add_((1 - b1) * g)  # b1 * m + (1 - b1) * g
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = m / bc1
        delta.div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm,
                                                                     "lr": lr}
