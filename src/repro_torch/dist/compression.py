"""Int8 gradient compression with error feedback for the cross-pod axis
(port of `repro.dist.compression`).

Cross-pod all-reduces are the WAN of the training stack, the same
bandwidth-bound hop the paper's middleware optimizes. Gradients are
quantized to int8 with one float32 scale a tensor; the quantization
residual is carried forward and added to the next step's gradient (error
feedback), so the compressed trajectory stays unbiased in the long run.

    error = init_error(grads)
    c, error = compress(grads, error)     # ship c.q (int8) and c.scale
    grads = decompress(c)                 # after the all-reduce

Trees are dicts of tensors, nested or flat. The arithmetic is the
reference's op for op (`tests/test_torch_mesh_tools.py` holds q, scale and
the new error bit for bit). The training launcher does not call it, as the
reference's does not (ROADMAP.md §C, C12).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compressed(NamedTuple):
    q: dict  # tree of int8 tensors
    scale: dict  # tree of float32 scalars (absmax / 127)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def init_error(grads) -> dict:
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _q_one(g, err):
    g = g.to(torch.float32) + err
    scale = torch.clamp_min(g.abs().amax() / 127.0, 1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_err = g - q.to(torch.float32) * scale
    return q, scale, new_err


def compress(grads, error) -> tuple:
    """(grads, error) -> (Compressed, new error), tree for tree."""
    qs = _tree_map(_q_one, grads, error)
    q = _tree_map(lambda t: t[0], qs)
    scale = _tree_map(lambda t: t[1], qs)
    err = _tree_map(lambda t: t[2], qs)
    return Compressed(q=q, scale=scale), err


def decompress(c: Compressed):
    return _tree_map(lambda q, s: q.to(torch.float32) * s, c.q, c.scale)


def compression_ratio(grads) -> float:
    """Bytes saved: float32 -> int8 + one scale a tensor."""
    orig = sum(g.numel() * 4 for g in _leaves(grads))
    comp = sum(g.numel() + 4 for g in _leaves(grads))
    return orig / max(comp, 1)
