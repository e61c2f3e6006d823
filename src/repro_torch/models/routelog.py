"""Reading an MoE stack's routing, to hold two runs of one layer against
each other (the port against the reference on the CPU, or the card against
the CPU).

A routing decision is a discontinuous function of the bf16 activations:
where two experts' gates nearly tie, an ulp of difference in a product
picks the other expert, and a flipped assignment shifts the capacity
positions of the later assignments to the experts it moved between. So
two runs may differ on a few tokens, and only in those two ways:

- an expert flip: the reference's gates of the two experts are within
  TIE_GAP;
- a kept / dropped difference on a token whose experts agree: an expert
  flip earlier in the same batch row (token-major, then k) moved an
  assignment to or from that expert.

Anything else is a fault. The tokens that differ are counted (at most
MAX_FLIPS of the decisions) and left out of the comparison of outputs.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers

TIE_GAP = 0.02  # float32 gate probabilities
MAX_FLIPS = 0.02  # of the (token, layer) routing decisions


class RouteLog:
    """Records `layers.moe_route`'s results while installed (`with`), in
    call order."""

    def __enter__(self):
        self.calls, self._real = [], layers.moe_route

        def logged(*args):
            out = self._real(*args)
            self.calls.append(out)
            return out

        layers.moe_route = logged
        return self

    def __exit__(self, *exc):
        layers.moe_route = self._real

    def dropped(self) -> int:
        """Assignments past the capacity over every routing recorded."""
        return sum(int((~r.kept).sum()) for r in self.calls)


def compare(ref, other, label: str):
    """Holds `other`'s routing (topi, kept [B,S,K]) against `ref`'s (topi,
    kept [B,S,K], gates [B,S,E]) by the rules above; CPU tensors. Returns
    (agree [B,S]: the tokens whose experts and kept assignments are equal,
    tokens with an expert flip, tokens with only a kept / dropped
    difference). Raises on a difference the rules do not explain."""
    (ti_r, kp_r, g_r), (ti_o, kp_o) = ref, other
    B, S, K = ti_r.shape
    flip = ti_r != ti_o
    for b, s in flip.any(-1).nonzero().tolist():
        g = g_r[b, s].float()
        gap = (g[ti_r[b, s]] - g[ti_o[b, s]]).abs().max().item()
        if gap > TIE_GAP:
            raise AssertionError(f"{label}: the experts of token ({b}, {s}) differ off a tie "
                                 f"(gap {gap:.4g} > {TIE_GAP}): {ti_r[b, s].tolist()} vs "
                                 f"{ti_o[b, s].tolist()}, gates {g.tolist()}")
    kept_only = (kp_r != kp_o) & ~flip
    for b, s, k in kept_only.nonzero().tolist():
        e, n = ti_r[b, s, k], s * K + k
        moved = flip[b].reshape(-1)[:n] & ((ti_r[b].reshape(-1)[:n] == e)
                                           | (ti_o[b].reshape(-1)[:n] == e))
        if not bool(moved.any()):
            raise AssertionError(f"{label}: assignment ({b}, {s}, {k}) to expert {int(e)} is kept "
                                 f"on one side only, and no earlier flip in its row moved an "
                                 f"assignment to or from that expert")
    agree = ~(flip | (kp_r != kp_o)).any(-1)
    return agree, int(flip.any(-1).sum()), int((kept_only.any(-1) & ~flip.any(-1)).sum())
