"""Benchmark workload generators: YCSB (transactional variant) and TPC-C.

Mirrors the paper's setup (§VII-A-2):

* YCSB — 1M records per data node, txns of 5 ops by default, each op 50% read /
  50% write, zipfian key skew with theta in {0.3, 0.9, 1.5} for low/medium/high
  contention, a configurable distributed-transaction ratio (keys spread over 2
  nodes), configurable transaction length (Fig 14a) and interactive rounds
  (Fig 14b).

* TPC-C — NewOrder/Payment/OrderStatus/Delivery/StockLevel mix (45/43/4/4/4),
  16 warehouses per node, distributed ratio controlled through remote
  warehouseIDs (Payment) and remote stock (NewOrder), per the paper §VII-C.
  Lock-irrelevant details (read-only ITEM table, order-line inserts) are
  abstracted away: the engine models record-level S/X lock acquisition, which
  is the granularity the paper's analysis operates at.

Banks are pre-generated with numpy (deterministic PCG64 stream, the same
generation as the reference `repro.core.workloads`) and handed to the engine
as CPU tensors: key/write/ds/round per op, per terminal, per transaction
slot. `bank_to` moves one to the run's device. Terminals cycle through their
bank slot-by-slot.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Bank(NamedTuple):
    """Pre-generated transaction bank. T terminals x N txns x K op slots."""

    key: torch.Tensor  # [T,N,K] int32 global record id
    write: torch.Tensor  # [T,N,K] bool
    ds: torch.Tensor  # [T,N,K] int8 data source of the op
    round_id: torch.Tensor  # [T,N,K] int8 interactive round of the op
    valid: torch.Tensor  # [T,N,K] bool real op?
    is_dist: torch.Tensor  # [T,N] bool distributed txn?
    num_records: int  # global key-space size (static)
    num_ds: int


@dataclasses.dataclass(frozen=True)
class YCSBConfig:
    num_ds: int = 4
    records_per_node: int = 1_000_000
    ops_per_txn: int = 5
    read_frac: float = 0.5
    dist_ratio: float = 0.2
    theta: float = 0.9  # zipfian skew (0.3 low / 0.9 medium / 1.5 high)
    rounds: int = 1
    dist_nodes: int = 2  # nodes touched by a distributed txn
    seed: int = 0


def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = 1.0 / np.power(ranks, theta)
    cdf = np.cumsum(p)
    return (cdf / cdf[-1]).astype(np.float64)


def _sample_zipf(rng: np.random.Generator, cdf: np.ndarray, shape) -> np.ndarray:
    u = rng.random(shape)
    return np.searchsorted(cdf, u, side="left").astype(np.int64)


def _dedup_linear(keys: np.ndarray, modulo: int) -> np.ndarray:
    """Ensure keys are unique within the last axis (linear probing)."""
    k = keys.copy()
    K = k.shape[-1]
    for i in range(1, K):
        for _ in range(K):
            dup = (k[..., i : i + 1] == k[..., :i]).any(axis=-1)
            if not dup.any():
                break
            k[..., i] = np.where(dup, (k[..., i] + 1) % modulo, k[..., i])
    return k


def make_ycsb_bank(cfg: YCSBConfig, terminals: int, txns_per_terminal: int) -> Bank:
    rng = np.random.default_rng(np.random.PCG64(cfg.seed))
    T, N, K = terminals, txns_per_terminal, cfg.ops_per_txn
    D, R = cfg.num_ds, cfg.records_per_node

    cdf = _zipf_cdf(R, cfg.theta)
    local = _sample_zipf(rng, cdf, (T, N, K))
    local = _dedup_linear(local, R)

    is_dist = rng.random((T, N)) < cfg.dist_ratio
    home = rng.integers(0, D, size=(T, N))
    # distributed txns touch `dist_nodes` distinct nodes; op i -> node cycle
    offsets = rng.integers(1, D, size=(T, N)) if D > 1 else np.zeros((T, N), dtype=np.int64)
    second = (home + offsets) % D
    op_slot = np.arange(K)[None, None, :]
    # split ops between home and second node for distributed txns
    use_second = is_dist[..., None] & (op_slot % max(cfg.dist_nodes, 2) == 1)
    ds = np.where(use_second, second[..., None], home[..., None]).astype(np.int8)

    key = (ds.astype(np.int64) * R + local).astype(np.int32)
    write = rng.random((T, N, K)) < (1.0 - cfg.read_frac)
    rounds = np.minimum(cfg.rounds, K)
    round_id = (op_slot * rounds // K).astype(np.int8) * np.ones((T, N, 1), dtype=np.int8)
    valid = np.ones((T, N, K), dtype=bool)

    return Bank(
        key=torch.from_numpy(key),
        write=torch.from_numpy(write),
        ds=torch.from_numpy(ds),
        round_id=torch.from_numpy(round_id),
        valid=torch.from_numpy(valid),
        is_dist=torch.from_numpy(is_dist),
        num_records=D * R,
        num_ds=D,
    )


BANK_ARRAYS = ("key", "write", "ds", "round_id", "valid", "is_dist")


def bank_to(bank: Bank, device) -> Bank:
    """The bank with every array leaf on `device`."""
    return bank._replace(**{f: getattr(bank, f).to(device) for f in BANK_ARRAYS})


def stack_banks(banks) -> Bank:
    """Per-cell banks of one shape -> one Bank with a leading [B] axis on
    every array leaf (the scalar `num_records`/`num_ds` must agree)."""
    b0 = banks[0]
    for i, b in enumerate(banks):
        if (b.num_records, b.num_ds) != (b0.num_records, b0.num_ds):
            raise ValueError(f"bank {i}: num_records/num_ds differ from bank 0")
    return b0._replace(
        **{f: torch.stack([getattr(b, f) for b in banks]) for f in BANK_ARRAYS}
    )


def quro_reorder(bank: Bank) -> Bank:
    """QURO baseline (§VII-A-1): reorder ops so exclusive-lock (write) ops are
    acquired as late as possible — reads first, writes last, stable order."""
    write = bank.write.cpu().numpy()
    order = np.argsort(write.astype(np.int8), axis=-1, kind="stable")

    def take(x):
        return torch.from_numpy(np.take_along_axis(x.cpu().numpy(), order, axis=-1))

    return bank._replace(
        key=take(bank.key),
        write=take(bank.write),
        ds=take(bank.ds),
        round_id=bank.round_id,  # round structure follows slot order
        valid=take(bank.valid),
    )


# ---------------------------------------------------------------------------
# TPC-C
# ---------------------------------------------------------------------------

N_DIST = 10
N_CUST_PER_DIST = 3000
N_STOCK = 100_000

# transaction type ids (used by benchmarks to slice metrics)
TPCC_NEWORDER, TPCC_PAYMENT, TPCC_ORDERSTATUS, TPCC_DELIVERY, TPCC_STOCKLEVEL = range(5)


@dataclasses.dataclass(frozen=True)
class TPCCConfig:
    num_ds: int = 4
    warehouses_per_node: int = 16
    dist_ratio: float = 0.2
    mix: tuple = (0.45, 0.43, 0.04, 0.04, 0.04)
    only_type: int = -1  # >=0: generate only this txn type (Fig 9 per-type runs)
    seed: int = 0

    @property
    def node_span(self) -> int:
        w = self.warehouses_per_node
        return w * (1 + N_DIST + N_DIST * N_CUST_PER_DIST + N_STOCK)

    def wh_key(self, node, w):
        return node * self.node_span + w

    def dist_key(self, node, w, d):
        base = self.warehouses_per_node
        return node * self.node_span + base + w * N_DIST + d

    def cust_key(self, node, w, d, c):
        base = self.warehouses_per_node * (1 + N_DIST)
        return node * self.node_span + base + (w * N_DIST + d) * N_CUST_PER_DIST + c

    def stock_key(self, node, w, i):
        base = self.warehouses_per_node * (1 + N_DIST + N_DIST * N_CUST_PER_DIST)
        return node * self.node_span + base + w * N_STOCK + i


TPCC_MAX_OPS = 21  # StockLevel: 1 district + 20 stock reads


def make_tpcc_bank(
    cfg: TPCCConfig, terminals: int, txns_per_terminal: int
) -> tuple[Bank, np.ndarray]:
    """Returns (bank, ttype[T,N]) — ttype kept host-side for per-type metrics."""
    rng = np.random.default_rng(np.random.PCG64(cfg.seed + 1))
    T, N, K = terminals, txns_per_terminal, TPCC_MAX_OPS
    D, W = cfg.num_ds, cfg.warehouses_per_node

    key = np.zeros((T, N, K), dtype=np.int64)
    write = np.zeros((T, N, K), dtype=bool)
    ds = np.zeros((T, N, K), dtype=np.int8)
    valid = np.zeros((T, N, K), dtype=bool)
    is_dist = np.zeros((T, N), dtype=bool)
    ttype = np.zeros((T, N), dtype=np.int8)

    if cfg.only_type >= 0:
        ty = np.full((T, N), cfg.only_type, dtype=np.int64)
    else:
        ty = rng.choice(5, size=(T, N), p=np.asarray(cfg.mix))
    ttype[:] = ty

    node = rng.integers(0, D, size=(T, N))
    w = rng.integers(0, W, size=(T, N))
    d = rng.integers(0, N_DIST, size=(T, N))
    c = _nurand(rng, 1023, N_CUST_PER_DIST, (T, N))
    remote = rng.random((T, N)) < cfg.dist_ratio
    rnode = (node + rng.integers(1, D, size=(T, N))) % D if D > 1 else node

    def put(mask, slot, k, wr, nd):
        key[mask, slot] = k[mask]
        write[mask, slot] = wr
        ds[mask, slot] = nd[mask]
        valid[mask, slot] = True

    # --- NewOrder: S(warehouse), X(district), S(customer), X(stock) x 10 ------
    m = ty == TPCC_NEWORDER
    put(m, 0, cfg.wh_key(node, w), False, node)
    put(m, 1, cfg.dist_key(node, w, d), True, node)
    put(m, 2, cfg.cust_key(node, w, d, c), False, node)
    items = _nurand(rng, 8191, N_STOCK, (T, N, 10))
    items = _dedup_linear(items, N_STOCK)
    # distributed NewOrder: items 8-9 come from a remote node's stock
    for j in range(10):
        rem_j = m & remote & (j >= 8)
        nd = np.where(rem_j, rnode, node)
        sk = cfg.stock_key(nd, w, items[..., j])
        put(m, 3 + j, sk, True, nd)
    is_dist |= m & remote

    # --- Payment: X(warehouse) [hot], X(district), X(customer) ----------------
    m = ty == TPCC_PAYMENT
    put(m, 0, cfg.wh_key(node, w), True, node)
    put(m, 1, cfg.dist_key(node, w, d), True, node)
    # remote customer (distributed payment): customer on another node
    cnode = np.where(remote, rnode, node)
    cw = rng.integers(0, W, size=(T, N))
    put(m, 2, cfg.cust_key(cnode, cw, d, c), True, cnode)
    is_dist |= m & remote

    # --- OrderStatus: S(customer) ---------------------------------------------
    m = ty == TPCC_ORDERSTATUS
    put(m, 0, cfg.cust_key(node, w, d, c), False, node)

    # --- Delivery: X(customer) x 10 (one per district) -------------------------
    m = ty == TPCC_DELIVERY
    cs = rng.integers(0, N_CUST_PER_DIST, size=(T, N, N_DIST))
    for j in range(N_DIST):
        put(m, j, cfg.cust_key(node, w, np.full_like(d, j), cs[..., j]), True, node)

    # --- StockLevel: S(district), S(stock) x 20 --------------------------------
    m = ty == TPCC_STOCKLEVEL
    put(m, 0, cfg.dist_key(node, w, d), False, node)
    sl_items = rng.integers(0, N_STOCK, size=(T, N, 20))
    sl_items = _dedup_linear(sl_items, N_STOCK)
    for j in range(20):
        put(m, 1 + j, cfg.stock_key(node, w, sl_items[..., j]), False, node)

    round_id = np.zeros((T, N, K), dtype=np.int8)
    bank = Bank(
        key=torch.from_numpy(key.astype(np.int32)),
        write=torch.from_numpy(write),
        ds=torch.from_numpy(ds),
        round_id=torch.from_numpy(round_id),
        valid=torch.from_numpy(valid),
        is_dist=torch.from_numpy(is_dist),
        num_records=D * cfg.node_span,
        num_ds=D,
    )
    return bank, ttype


def _nurand(rng: np.random.Generator, A: int, n: int, shape) -> np.ndarray:
    """TPC-C NURand non-uniform distribution."""
    C = 123 % (A + 1)
    x = rng.integers(0, A + 1, size=shape)
    y = rng.integers(0, n, size=shape)
    return (((x | y) + C) % n).astype(np.int64)
