"""GeoTP one-round-commit checkpointing (port of `repro.dist.checkpoint`).

Protocol (the paper's decentralized-prepare idea applied to checkpoint I/O):

  1. `write_shard(step, host, tree)` — each host streams its shard to
     `step_<N>/shard_<h>.npz` and drops `shard_<h>.ok` beside it. The
     durable shard write IS the prepare vote: no separate vote round.
  2. `commit(step)` — once every host's `.ok` marker exists, an atomic
     rename publishes `step_<N>/COMMIT`. One round total.
  3. `recover()` — scans for the newest directory with a COMMIT marker and
     garbage-collects uncommitted leftovers (crash mid-prepare leaves no
     torn state: without COMMIT the step never happened).

The layout is the reference's, so a checkpoint written by either package
restores in the other: `step_%08d/shard_%04d.npz`, nested dict keys (and
list / tuple indices) joined with '/' into the npz keys. Leaves are tensors
or arrays; a tensor is written from the host as a numpy array (bfloat16 as
float32, exactly: numpy has no bfloat16) and `restore` casts each array to
its `like` leaf's dtype and device.
"""

from __future__ import annotations

import os
import pathlib
import shutil

import numpy as np
import torch

_STEP_PREFIX = "step_"
_COMMIT = "COMMIT"


def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted, then
    list / tuple positions."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def _rebuild(like, flat: dict, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, prefix + (str(i),)) for i, v in enumerate(like))
    if like is None:
        return None
    arr = flat["/".join(prefix)]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(dtype=like.dtype,
                                                              device=like.device)
    return arr.astype(like.dtype) if hasattr(like, "dtype") else arr


class CheckpointManager:
    def __init__(self, root, n_hosts: int = 1):
        self.root = pathlib.Path(root)
        self.n_hosts = n_hosts
        self.root.mkdir(parents=True, exist_ok=True)

    # ---- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.root / f"{_STEP_PREFIX}{step:08d}"

    def _shard(self, step: int, host: int) -> pathlib.Path:
        return self._step_dir(step) / f"shard_{host:04d}.npz"

    # ---- one-round commit -------------------------------------------------
    def write_shard(self, step: int, host: int, tree) -> None:
        """Durable shard write + prepare marker (the vote)."""
        d = self._step_dir(step)
        d.mkdir(parents=True, exist_ok=True)
        shard = self._shard(step, host)
        tmp = shard.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **_flatten(tree))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, shard)  # atomic: a shard is either whole or absent
        (d / f"shard_{host:04d}.ok").touch()

    def prepared(self, step: int) -> bool:
        d = self._step_dir(step)
        return all((d / f"shard_{h:04d}.ok").exists() for h in range(self.n_hosts))

    def commit(self, step: int) -> bool:
        """Publish the step iff every host voted. Atomic, idempotent."""
        if not self.prepared(step):
            return False
        d = self._step_dir(step)
        tmp = d / (_COMMIT + ".tmp")
        tmp.touch()
        os.replace(tmp, d / _COMMIT)
        return True

    # ---- recovery ---------------------------------------------------------
    def _steps(self, committed_only: bool) -> list:
        steps = []
        for d in self.root.glob(_STEP_PREFIX + "*"):
            if not d.is_dir():
                continue
            if committed_only and not (d / _COMMIT).exists():
                continue
            try:
                steps.append(int(d.name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
        return sorted(steps)

    def latest_step(self):
        steps = self._steps(committed_only=True)
        return steps[-1] if steps else None

    def recover(self):
        """Latest committed step (or None); removes uncommitted leftovers."""
        latest = self.latest_step()
        for step in self._steps(committed_only=False):
            if not (self._step_dir(step) / _COMMIT).exists():
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        return latest

    def restore(self, step: int, host: int, like):
        """Load host's shard into the structure of `like` (path-keyed), each
        leaf in its `like` leaf's dtype (and device, for a tensor)."""
        with np.load(self._shard(step, host)) as z:
            flat = {k: z[k] for k in z.files}
        return _rebuild(like, flat)
