"""Carry simulator operands and state between the JAX package and the port.

The JAX package's NamedTuples (`FlowOperands`, `TopoOperands`, `SimState`)
come in as host numpy leaves (the caller does `jax.device_get`) and go out
as the port's NamedTuples on a device, keeping int32 / bool / float32.
`assert_state_equal` compares two states leaf by leaf, bit for bit, and
names the first leaf that differs. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .sim.engine import FlowOperands, SimState, to_numpy
from .sim.topology import TopoOperands

_KEEP = (np.bool_, np.int32, np.float32)


def _tensor(leaf, device) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.type not in _KEEP:
        raise TypeError(f"unexpected leaf dtype {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)   # copy keeps 0-d leaves


def _convert(cls, tup, device):
    return cls(**{name: _tensor(getattr(tup, name), device)
                  for name in cls._fields})


def flow_operands_from_numpy(ops, device="cpu") -> FlowOperands:
    return _convert(FlowOperands, ops, device)


def topo_operands_from_numpy(topo_ops, device="cpu") -> TopoOperands:
    return _convert(TopoOperands, topo_ops, device)


def state_from_numpy(st, device="cpu") -> SimState:
    return _convert(SimState, st, device)


def state_to_numpy(st: SimState) -> SimState:
    return to_numpy(st)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def first_difference(name: str, a, b):
    """None if `a` and `b` are bit-identical, else a message naming the
    leaf, the first differing index and both values."""
    a, b = _host(a), _host(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return (f"{name}: shape/dtype {a.shape}/{a.dtype} != "
                f"{b.shape}/{b.dtype}")
    if a.dtype.kind == "f":
        ka, kb = a.view(np.uint32), b.view(np.uint32)
    else:
        ka, kb = a, b
    diff = np.argwhere(ka != kb)
    if diff.size == 0:
        return None
    at = tuple(int(i) for i in diff[0])
    return (f"{name}: first difference at {at}: {a[at]!r} != {b[at]!r} "
            f"({len(diff)} differing entries)")


def assert_state_equal(a, b, what: str = "") -> None:
    """Raise AssertionError naming the first `SimState` leaf where `a` and
    `b` differ (bit for bit, float leaves included)."""
    for name in SimState._fields:
        msg = first_difference(name, getattr(a, name), getattr(b, name))
        if msg is not None:
            raise AssertionError(f"{what}{': ' if what else ''}{msg}")
