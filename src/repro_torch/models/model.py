"""Step functions of the serving path: prefill and decode (port of
`repro.models.model`).

PyTorch runs eagerly, so these return plain closures where the reference
returns functions for `jax.jit`. Products of bf16 activations run in bf16
on the card's tensor cores; a float32 product (the kernels' plain versions)
runs in full float32, since `torch.backends.cuda.matmul.allow_tf32` is False
by default and the entry points (`chip_smoke.py`, `launch/serve.py`) set it
so explicitly. The train step, the loss and `input_specs` are training and
multi-device work (ROADMAP.md §A item A7).
"""

from __future__ import annotations

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig


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
