"""Step functions (train / prefill / decode) and abstract input specs per
(architecture x shape) cell (port of `repro.models.model`).

PyTorch runs eagerly, so these return plain closures where the reference
returns functions for `jax.jit`. Products of bf16 activations run in bf16
on the card's tensor cores; a float32 product (the kernels' plain versions)
runs in full float32, since `torch.backends.cuda.matmul.allow_tf32` is False
by default and the entry points (`chip_smoke.py`, `launch/serve.py`,
`launch/train.py`) set it so explicitly.

The train step takes the reference's float32 parameters {name: tensor},
the AdamW state and a batch, and returns them updated (the parameters and
moments in place, `optim.adamw.apply_updates`) with the metrics. Gradients
come from `torch.autograd.grad` through `stack.forward_train`, whose
attention runs the flash kernel and its hand-written backward on the card.
"""

from __future__ import annotations

import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.layers import gather_logits
from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy (float32 reduction) + small z-loss."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = gather_logits(lf, labels)
    ce = torch.mean(lse - gold)
    zloss = 1e-4 * torch.mean(lse**2)
    return ce + zloss


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, remat=False) -> torch.Tensor:
    logits = stack.forward_train(cfg, params, batch, remat=remat)
    labels = batch["dec_labels"] if cfg.is_encdec else batch["labels"]
    if cfg.frontend == "vision":
        # loss only on the text tokens that follow the patch prefix
        logits = logits[:, -labels.shape[1] :]
    return cross_entropy(logits, labels)


def _grads(cfg, params: dict, batch: dict, remat):
    """(loss, {name: grad}) of one (micro)batch; a parameter the loss does
    not reach gets zeros, as `jax.grad` gives."""
    with torch.enable_grad():
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        loss = loss_fn(cfg, leaves, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def accumulated_grads(cfg: ModelConfig, params: dict, batch: dict, accum: int = 1,
                      remat=False):
    """(loss, {name: grad}) of the global batch: with accum > 1 the batch
    splits into microbatches along its rows, their float32 gradients are
    summed in a loop, as the reference's `lax.scan` sums them, then divided
    by accum; the loss is the microbatches' mean."""
    if accum == 1:
        return _grads(cfg, params, batch, remat)
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch of {B} rows does not split into {accum} microbatches")
    mb = B // accum
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    loss = 0.0
    for i in range(accum):
        micro = {k: x[i * mb : (i + 1) * mb] for k, x in batch.items()}
        l, g = _grads(cfg, params, micro, remat)
        for n in grads:
            grads[n] += g[n]
        loss = loss + l
        del g
    for n in grads:
        grads[n] /= accum
    return loss / accum, grads


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig, accum: int = 1, remat=False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    accum > 1 splits the global batch into microbatches (gradient
    accumulation, `accumulated_grads`): it bounds live activation memory on
    the large cells. remat: see `stack.forward_train` (False, True / "full",
    "dots"). metrics: {"loss", "grad_norm", "lr"} (float32 scalars)."""

    def train_step(params, opt_state, batch):
        loss, grads = accumulated_grads(cfg, params, batch, accum, remat)
        params, opt_state, stats = adamw.apply_updates(opt, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """prefill_step(params, batch) -> (last_logits, cache). batch: {"tokens"};
    a vision model's {"patches" [B,P,frontend_dim], "tokens"}; an
    encoder-decoder's {"frames" [B,M,frontend_dim], "dec_tokens"}."""

    def prefill_step(params, batch):
        return stack.forward_prefill(cfg, params, batch, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, token, pos, cache):
        return stack.forward_decode(cfg, params, token, pos, cache)

    return serve_step


# ---------------------------------------------------------------------------
# abstract input specs per shape cell (tensors on the `meta` device)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_tree(spec: dict) -> dict:
    return {k: _meta_tree(v) if isinstance(v, dict) else _meta(*v) for k, v in spec.items()}


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract inputs of a cell's step, keys as the step's arguments, the
    reference's shapes and dtypes as `meta` tensors (no allocation)."""
    B, S = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def tok(b, s):
        return _meta((b, s), i32)

    if cell.kind in ("train", "prefill"):
        train = cell.kind == "train"
        if cfg.is_encdec:
            s_dec = max(S // 4, 128)
            batch = {"frames": _meta((B, S, cfg.frontend_dim), bf16), "dec_tokens": tok(B, s_dec)}
            if train:
                batch["dec_labels"] = tok(B, s_dec)
        elif cfg.frontend == "vision":
            P = min(1024, S // 4)
            batch = {"patches": _meta((B, P, cfg.frontend_dim), bf16), "tokens": tok(B, S - P)}
            if train:
                batch["labels"] = tok(B, S - P)  # the loss reads the text positions only
        else:
            batch = {"tokens": tok(B, S)}
            if train:
                batch["labels"] = tok(B, S)
        return {"batch": batch}

    # decode: one new token against a cache of size seq_len
    cache = stack.decode_cache_specs(cfg, B, S, enc_len=S if cfg.is_encdec else 0)
    return {"token": _meta((B,), i32), "pos": _meta((B,), i32), "cache": _meta_tree(cache)}


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) as `meta` tensors, for a dry run's sizes."""
    from repro_torch.models.schema import abstract_params

    ap = abstract_params(stack.build_schema(cfg))
    return ap, adamw.abstract_state(ap)
