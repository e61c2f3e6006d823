"""Network model for geo-distributed deployments (port of `repro.core.netmodel`).

The DM connects to D data sources with heterogeneous round-trip times
(default Beijing/Shanghai/Singapore/London = 0/27/73/251 ms) plus a DS<->DS
mesh for the geo-agents' early abort. All times are int32 microseconds.

uint32 arithmetic: PyTorch refuses `>>` and `%` on uint32 tensors, so every
uint32 value here is carried in an int64 tensor holding [0, 2**32) and
masked with `& U32` after each step that could leave that range. Multiplies
by a 32-bit constant are split into 16-bit halves (`_mul_u32`) so no int64
product ever exceeds 2**63.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# Sentinel for "no pending event": far beyond any simulation horizon.
INF_US = 2**30

MS = 1000  # microseconds per millisecond

PAPER_RTT_MS = (0.0, 27.0, 73.0, 251.0)

U32 = 0xFFFFFFFF


class NetParams(NamedTuple):
    tau_dm: torch.Tensor  # [D] int32 µs
    tau_ds: torch.Tensor  # [D,D] int32 µs
    jitter_milli: torch.Tensor  # int32 scalar


def make_net_params(rtt_ms=PAPER_RTT_MS, jitter_frac: float = 0.0, tau_ds_ms=None) -> NetParams:
    """NetParams from RTTs in milliseconds (CPU tensors)."""
    tau = torch.tensor([int(t * MS) for t in rtt_ms], dtype=torch.int32)
    if tau_ds_ms is None:
        tds = derive_tau_ds_us(tau)
    else:
        tds = torch.tensor([[int(t * MS) for t in row] for row in tau_ds_ms], dtype=torch.int32)
    return NetParams(tau, tds, torch.tensor(int(jitter_frac * 1000), dtype=torch.int32))


def derive_tau_ds_us(tau_us) -> torch.Tensor:
    """DS<->DS mesh from the DM RTT vector: |tau_i - tau_j| with a 1 ms
    off-diagonal floor."""
    tau_us = torch.as_tensor(tau_us, dtype=torch.int32)
    d = tau_us.shape[0]
    tds = (tau_us[:, None] - tau_us[None, :]).abs()
    eye = torch.eye(d, dtype=torch.bool, device=tau_us.device)
    floor = torch.where(~eye, 1 * MS, 0).to(torch.int32)
    return torch.maximum(tds, floor)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), via 16-bit halves of c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply hash, uint32 -> uint32 (as int64 in [0, 2**32))."""
    x = x.to(torch.int64) & U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def one_way_delay(net: NetParams, tau_rtt: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """RTT/2 with deterministic per-message jitter of ±jitter_milli/1000."""
    half = tau_rtt // 2
    u = (_hash_u32(salt) % 2001).to(torch.int32) - 1000
    jit = (half * net.jitter_milli // 1000) * u // 1000
    return (half + jit).to(torch.int32)


def f32(x: float) -> float:
    """A Python float holding exactly the float32 value of `x`: multiplying a
    float32 tensor by it multiplies by that float32 constant."""
    return float(np.float32(x))


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded ONCE, as a fused multiply-add.

    XLA:CPU contracts the reference's `x * c + ...` (the EWMA's `e * b + ...`,
    Eq.(4)'s `w_old * a + ...`) into an FMA; eager PyTorch rounds the
    product first. `b` is a Python float (a float32 value) or a float32
    tensor. The float32 product is exact in float64 (24 + 24 bits); the float64 sum is made round-to-odd with its
    exact error (TwoSum), and round-to-odd at 53 bits followed by
    round-to-nearest at 24 bits is the correctly rounded float32 result."""
    b64 = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(b)
    p = a.to(torch.float64) * b64
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    # truncate toward zero, then force the last bit to 1 when inexact
    toward_zero = (err != 0) & ((err > 0) != (s > 0))
    odd = torch.where(err != 0, (bits - toward_zero.to(torch.int64)) | 1, bits)
    return odd.view(torch.float64).to(torch.float32)


def ewma_update(est: torch.Tensor, sample: torch.Tensor, beta_milli: int) -> torch.Tensor:
    """est' = beta*est + (1-beta)*sample, beta in 1/1000, float32 op by op as
    the reference (`b = f32(beta)/1000`, then `fma(e, b, s*(1-b))` — the
    multiply-add XLA forms), truncated."""
    b = np.float32(beta_milli) / np.float32(1000.0)
    omb = np.float32(1.0) - b
    e = est.to(torch.float32)
    sm = sample.to(torch.float32)
    return fma_f32(e, float(b), sm * float(omb)).to(torch.int32)


def ewma_update_where(est, sample, beta_milli: int, mask) -> torch.Tensor:
    return torch.where(mask, ewma_update(est, sample, beta_milli), est)


@dataclasses.dataclass(frozen=True)
class GeoSites:
    """Named multi-region layouts used by benchmarks (Fig 10/11/15)."""

    name: str
    rtt_ms: tuple

    @staticmethod
    def paper_default() -> "GeoSites":
        return GeoSites("beijing-dm", PAPER_RTT_MS)

    @staticmethod
    def mirrored() -> "GeoSites":
        return GeoSites("london-dm", (251.0, 226.0, 175.0, 0.0))

    @staticmethod
    def mean_std(mean_ms: float, std_ms: float, d: int = 4) -> "GeoSites":
        if d <= 1:
            return GeoSites(f"mean{mean_ms}", (0.0,))
        lats = [0.0] + [
            max(0.0, mean_ms + std_ms * (2.0 * i / max(d - 2, 1) - 1.0)) for i in range(d - 1)
        ]
        return GeoSites(f"mean{mean_ms}-std{std_ms}", tuple(lats))
