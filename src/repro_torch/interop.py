"""Carry the reference's data structures across, as numpy arrays.

The reference's `Bank`, stacked `WorldSpec` and `SimState` come in as
mappings (or NamedTuples) of numpy arrays under the reference's field names
— nested `dyn` / `hs` included — and leave as the port's tensors, and back.
With these a test can take a reference state from the middle of a run, step
it once in each package and name the first leaf that differs.

The model's parameters (a flat dict of numpy arrays under the reference's
names) and its decode caches (nested dicts: an encoder-decoder's
{"self", "xk", "xv"} layers, int8 K/V with float32 scales) cross the same
way, so the two packages run the same weights and the same caches. So do
the training state's parameters and AdamW state ({"m", "v": {name: array},
"step": int32 scalar}): a reference `(params, opt_state)` trains on in the
port and comes back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hotspot import HashHotspot
from repro_torch.core.workloads import BANK_ARRAYS, Bank
from repro_torch.core.engine.state import DynProto, SimState, WorldSpec


def _fields(obj) -> dict:
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    return dict(obj)


def _tensor(x, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _build(cls, obj, nested: dict, device=None):
    src = _fields(obj)
    out = {}
    for f in cls._fields:
        if f in nested:
            out[f] = _build(nested[f], src[f], {}, device)
        else:
            out[f] = _tensor(src[f], device)
    return cls(**out)


def bank_from_numpy(bank) -> Bank:
    """A reference Bank (numpy leaves) -> the port's Bank on the CPU."""
    src = _fields(bank)
    arrays = {f: _tensor(src[f]) for f in BANK_ARRAYS}
    return Bank(**arrays, num_records=int(np.max(src["num_records"])),
                num_ds=int(np.max(src["num_ds"])))


def worlds_from_numpy(worlds) -> WorldSpec:
    """A reference [B]-stacked WorldSpec (numpy leaves) -> the port's, its
    fault schedules ([B, F, 6]) and replica leaves included."""
    return _build(WorldSpec, worlds, {"dyn": DynProto})


def state_from_numpy(state, device=None) -> SimState:
    """A reference SimState (numpy leaves, any batch shape) -> the port's."""
    return _build(SimState, state, {"hs": HashHotspot, "dyn": DynProto}, device)


def state_to_numpy(state: SimState) -> dict:
    """The port's SimState -> nested dict of numpy arrays (reference names)."""
    out = {}
    for f, v in zip(state._fields, state):
        if hasattr(v, "_fields"):
            out[f] = {g: x.detach().cpu().numpy() for g, x in zip(v._fields, v)}
        else:
            out[f] = v.detach().cpu().numpy()
    return out


def _from_numpy(x, device=None) -> torch.Tensor:
    """A numpy array -> tensor; bfloat16 (ml_dtypes) arrays keep their bits."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return _tensor(x, device)


def params_from_numpy(params, device=None) -> dict:
    """The reference's parameters {name: array} -> the port's {name: tensor}."""
    return {name: _from_numpy(x, device) for name, x in params.items()}


def cache_from_numpy(cache, device=None) -> dict:
    """A reference decode cache (nested dicts of arrays) -> the port's."""
    return {
        k: cache_from_numpy(v, device) if isinstance(v, dict) else _from_numpy(v, device)
        for k, v in cache.items()
    }


def cache_to_numpy(cache) -> dict:
    """The port's decode cache -> nested dicts of numpy arrays. bfloat16
    leaves come back as float32 (exact), since numpy has no bfloat16."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = cache_to_numpy(v)
        else:
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _to_numpy(x) -> np.ndarray:
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def params_to_numpy(params: dict) -> dict:
    """The port's parameters {name: tensor} -> {name: numpy array} (the
    reference's names). bfloat16 tensors come back as float32 (exact)."""
    return {name: _to_numpy(x) for name, x in params.items()}


def opt_state_from_numpy(state, device=None) -> dict:
    """The reference's AdamW state {"m", "v": {name: array}, "step"} -> the
    port's: float32 moments, an int32 0-d step."""
    return {"m": params_from_numpy(state["m"], device), "v": params_from_numpy(state["v"], device),
            "step": _tensor(np.asarray(state["step"], np.int32), device)}


def opt_state_to_numpy(state: dict) -> dict:
    """The port's AdamW state -> {"m", "v": {name: array}, "step": int32 array}."""
    return {"m": params_to_numpy(state["m"]), "v": params_to_numpy(state["v"]),
            "step": _to_numpy(state["step"])}
