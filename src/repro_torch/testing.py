"""Carry operands, state, parameters and caches between the JAX package
and the port.

Simulator: the JAX package's NamedTuples (`FlowOperands`, `TopoOperands`,
`SimState`) come in as host numpy leaves (the caller does
`jax.device_get`) and go out as the port's NamedTuples on a device,
keeping int32 / bool / float32. `assert_state_equal` compares two states
leaf by leaf, bit for bit, and names the first leaf that differs.
`random_derive_inputs` makes seeded operands of the fused switch step
(`kernels.bfc_step.ops.derive`) at any (P, Q), for holding its kernel
against its plain version, and `stack_derive_lanes` lays several lanes'
operands side by side as a sweep batch holds them.

LM: `params_from_jax` loads a numpy parameter tree into the port's
parameter modules, `cache_from_jax` maps a numpy cache (stacked or per-unit
list layout) onto the port's per-unit list, and `cache_to_numpy` brings a
port cache back, so that both packages compute on the same numbers. This
module imports no JAX.
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


DERIVE_ARGS = ("qhead", "qtail", "qbuf", "qptr", "qsrf", "bloom_rx",
               "ing_occ", "pfc_paused", "rem_src", "fpos", "arrival", "size",
               "port_switch", "port_is_nic", "feeds", "buffer_limit", "t")


def random_derive_inputs(seed: int, p: int, q: int, device, *,
                         buffer_limit=None, n_switches: int = 16,
                         cap: int = 16, n_flows: int = 257):
    """Seeded positional operands of `kernels.bfc_step.ops.derive` (in
    `DERIVE_ARGS` order) on `device`: 4 Bloom stages of 64 bits, queues
    with about half empty and a band of empty rows, head entries of every
    flow or empty (-1), dense Bloom bits (about half the heads paused),
    SRF keys below and above `BIG`, switch owners and fed switches with
    NIC ports and servers (-1), a third of the ports PFC-paused, arrivals
    at the chosen tick 37 for some flows. `buffer_limit` defaults to 500
    above the median switch occupancy, so PFC thresholds spread over the
    ingress counts."""
    rng = np.random.default_rng(seed)
    n_stages, bits, tick = 4, 64, 37
    i32 = np.int32
    qhead = rng.integers(0, 5000, (p, q)).astype(i32)
    occ = rng.integers(0, 8, (p, q)) * (rng.random((p, q)) < 0.5)
    occ[p // 3:p // 3 + max(1, p // 16)] = 0
    port_switch = rng.integers(-1, n_switches, p).astype(i32)
    port_is_nic = (port_switch < 0) & (rng.random(p) < 0.8)
    if buffer_limit is None:
        sw_occ = np.bincount(np.maximum(port_switch, 0),
                             occ.sum(1) * ~port_is_nic, n_switches)
        buffer_limit = int(np.median(sw_occ)) + 500
    a = {
        "qhead": qhead, "qtail": (qhead + occ).astype(i32),
        "qbuf": rng.integers(-1, 2 * n_flows, (p, q, cap)).astype(i32),
        "qptr": rng.integers(0, q, p).astype(i32),
        "qsrf": rng.integers(0, 2 << 20, (p, q)).astype(i32),
        "bloom_rx": rng.random((p, n_stages, bits)) < 0.85,
        "ing_occ": rng.integers(0, 120, p).astype(i32),
        "pfc_paused": rng.random(p) < 0.3,
        "rem_src": rng.integers(0, 50, n_flows).astype(i32),
        "fpos": rng.integers(0, bits, (n_flows, n_stages)).astype(i32),
        "arrival": rng.integers(0, 80, n_flows).astype(i32),
        "size": rng.integers(1, 100, n_flows).astype(i32),
        "port_switch": port_switch,
        "port_is_nic": port_is_nic,
        "feeds": rng.integers(-1, n_switches, p).astype(i32),
        "buffer_limit": np.asarray(buffer_limit, i32),
        "t": np.asarray(tick, i32),
    }
    return [torch.from_numpy(np.array(a[k])).to(device) for k in DERIVE_ARGS]


def stack_derive_lanes(lanes, n_switches: int):
    """The operands of ONE call of `kernels.bfc_step.ops.derive` over K
    lanes (call it with ``lanes=K, n_switches=K * n_switches``) from K
    single-lane operand lists in `DERIVE_ARGS` order, laid side by side as
    `sim.sweep` stacks a batch: lane k's rows and flows follow lane k-1's,
    its flow ids in qbuf move by k*F and its switch ids (port_switch,
    feeds) by k * `n_switches`, -1 entries stay; the buffer limits become
    one 0-d value when every lane has the same, else a (K,) table. Every
    lane must be at the same tick `t`."""
    ix = {name: i for i, name in enumerate(DERIVE_ARGS)}
    n_flows = lanes[0][ix["fpos"]].shape[0]
    t = lanes[0][ix["t"]]
    if any(not torch.equal(lane[ix["t"]], t) for lane in lanes):
        raise ValueError("the lanes of one call share one tick")

    def moved(x, by):
        return torch.where(x >= 0, x + by, x)

    out = []
    for name, vals in zip(DERIVE_ARGS, zip(*lanes)):
        if name == "t":
            out.append(t)
        elif name == "buffer_limit":
            same = all(torch.equal(v, vals[0]) for v in vals)
            out.append(vals[0] if same else torch.stack(vals))
        elif name == "qbuf":
            out.append(torch.cat([moved(v, 2 * k * n_flows)
                                  for k, v in enumerate(vals)]))
        elif name in ("port_switch", "feeds"):
            out.append(torch.cat([moved(v, k * n_switches)
                                  for k, v in enumerate(vals)]))
        else:
            out.append(torch.cat(vals))
    return out


# ---- LM parameters and caches ---------------------------------------------------
def params_from_jax(tree, cfg, device="cpu"):
    """The port's parameter tree holding the values of `tree`, the JAX
    package's parameters as nested dicts of numpy arrays (unit leaves
    stacked on a leading layer axis). Every leaf on either side must have
    its counterpart."""
    from .models import model
    params = model.init_model(cfg, device=device)
    used = set()
    with torch.no_grad():
        for name, p in params.named_parameters():
            parts = name.split(".")
            layer = None
            if parts[0] == "units":
                layer, parts = int(parts[1]), ["units"] + parts[2:]
            leaf = tree
            for key in parts:
                leaf = leaf[key]
            a = np.asarray(leaf if layer is None else leaf[layer])
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {a.shape} != port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, np.float32)))
            used.add("/".join(parts))
    want = {"/".join(path) for path in _leaf_paths(tree)}
    if want != used:
        raise ValueError(f"JAX leaves without a port parameter: "
                         f"{sorted(want - used)}; port parameters without a "
                         f"JAX leaf: {sorted(used - want)}")
    return params


def _leaf_paths(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def cache_from_jax(tree, device="cpu", dtype=torch.float32):
    """The port's per-unit list cache from a JAX cache of numpy leaves, in
    either of its layouts: "units" as a list of per-unit trees, or as one
    tree whose leaves are stacked on a leading layer axis."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(
            device=device, dtype=dtype)

    units = tree["units"]
    if not isinstance(units, list):
        n = len(next(_leaves(units)))
        units = [_index(units, i) for i in range(n)]
    out = {k: conv(v) for k, v in tree.items() if k != "units"}
    out["units"] = [conv(u) for u in units]
    return out


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def cache_to_numpy(cache):
    """A port cache as nested dicts/lists of float32 numpy arrays."""
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [cache_to_numpy(v) for v in cache]
    return cache.detach().float().cpu().numpy()
