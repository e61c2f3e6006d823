"""Elastic resizing: carry a training job across host-set changes (port of
`repro.dist.elastic`; pure integer code, the reference's own).

A committed one-round checkpoint (`dist.checkpoint`) is the handoff
point: on resize we re-plan the data-parallel split for the new host count
and tell each new host which old shards to read. Shards are replicated
param trees (every host holds the full tree in the reduced local setup), so
resize = re-assign data ranges; the plan generalizes to sharded layouts by
mapping shard ranges instead.

This is the training-infrastructure face of the same crash/recovery story
the engine simulates: the ``faults`` Grid axis
(`core.engine.Grid`, `SimConfig.max_faults`) injects deterministic
data-source outages into the transaction simulation, while `plan_resize` +
`CheckpointManager.recover` handle the real host-set change on this side.
Property tests over old x new host sweeps: tests/test_torch_mesh_tools.py.
"""

from __future__ import annotations

from typing import NamedTuple


class ResizePlan(NamedTuple):
    old_hosts: int
    new_hosts: int
    # per new host: list of old-host shard ids to read (usually length 1)
    sources: tuple
    # per new host: (start, stop) fraction of the global batch it now owns
    batch_ranges: tuple


def plan_resize(old_hosts: int, new_hosts: int) -> ResizePlan:
    """Map every new host onto the old shard set + its new batch range."""
    if old_hosts < 1 or new_hosts < 1:
        raise ValueError(f"plan_resize: host counts must be >= 1, got {old_hosts} -> {new_hosts}")
    sources = tuple((h % old_hosts,) for h in range(new_hosts))
    ranges = tuple(
        (h / new_hosts, (h + 1) / new_hosts) for h in range(new_hosts)
    )
    return ResizePlan(old_hosts, new_hosts, sources, ranges)


def local_batch(global_batch: int, plan: ResizePlan, host: int) -> tuple:
    """Integer [start, stop) rows of the global batch owned by `host`."""
    lo, hi = plan.batch_ranges[host]
    return int(round(lo * global_batch)), int(round(hi * global_batch))


def validate(plan: ResizePlan, global_batch: int) -> bool:
    """Ranges must tile the batch exactly — no dropped or duplicated rows."""
    edges = [local_batch(global_batch, plan, h) for h in range(plan.new_hosts)]
    ok = edges[0][0] == 0 and edges[-1][1] == global_batch
    for (a, b), (c, d) in zip(edges, edges[1:]):
        ok = ok and b == c
    return ok
