"""Deterministic synthetic LM data pipeline (port of `repro.data.pipeline`).

Counter-based PRNG (threefry fold-in of the step into the seed's key) => any
host can materialize exactly its shard of any global batch without
coordination — restart/elastic-safe by construction. A light Markov
structure makes the stream learnable (loss decreases), unlike iid-uniform
tokens.

The batch is made on the host (numpy threefry, `data/threefry.py`, then
float32 torch ops on the CPU) and copied to the device, so every device
trains on the same tokens. The uniforms and the repeat mask are the
reference's bit for bit; a token is the reference's unless its float32
exp(u · log V) lies within an ulp or two of an integer, where torch's exp
and XLA's may round to either side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import threefry
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def batch_uniforms(cfg: DataConfig, step: int):
    """(u [B,S+1] float32, rep [B,S+1] bool): the uniforms behind the tokens
    and the repeat mask of `step`'s global batch."""
    key = threefry.fold_in(threefry.PRNGKey(cfg.seed), step)
    k1, k2 = threefry.split(key)
    shape = (cfg.global_batch, cfg.seq_len + 1)
    return threefry.uniform(k1, shape), threefry.bernoulli(k2, 0.5, shape)


def global_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """The full global batch for `step` (hosts slice their rows): {"tokens",
    "labels"} int32 [B,S] on `device` (default: the card).

    Tokens are log-uniform (heavily skewed) with a local-repeat structure:
    a model learns the skewed marginal within tens of steps and the repeat
    bigram shortly after — loss decreases fast and keeps decreasing."""
    dev = resolve_device(device)
    u, rep = batch_uniforms(cfg, step)
    V, S = cfg.vocab, cfg.seq_len
    logv = torch.from_numpy(np.log(np.array([V], np.float32)))
    toks = torch.exp(torch.from_numpy(u) * logv).to(torch.int32) - 1  # log-uniform
    toks = torch.clamp(toks, 0, V - 1)
    # 50% of positions repeat the previous token (learnable bigram signal)
    toks = torch.where(torch.from_numpy(rep), torch.roll(toks, 1, dims=1), toks)
    return {"tokens": toks[:, :S].to(dev), "labels": toks[:, 1 : S + 1].to(dev)}


def host_batch(cfg: DataConfig, step: int, host: int, n_hosts: int, device=None) -> dict:
    b = global_batch(cfg, step, device)
    rows = cfg.global_batch // n_hosts
    return {k: x[host * rows : (host + 1) * rows] for k, x in b.items()}
