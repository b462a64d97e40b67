"""Shared step context: env, per-tick derived state, scatter helpers.

Torch port of `repro.sim.phases.ctx`. `PhaseEnv` carries everything that
shapes the state (protocol / timing config + `TopoDims`) plus the device
and the index ranges every tick reuses; `StepCtx` carries the values phases
hand to each other within one tick. Fields a phase has not produced yet are
None, so misordered phase composition fails loudly.

JAX semantics the helpers below carry over, because the phases rely on
them:

* an out-of-range scatter index is dropped (the phases use F / P / NSW /
  NSRV as a "drop" index). `scatter_add` / `scatter_max` / `scatter_min`
  instead mask the *value* to the operation's identity at an in-range
  index; `scatter_set` pads the target by one dump slice that absorbs the
  dropped lanes;
* JAX arrays are immutable: every helper returns a new tensor and never
  writes into its input;
* no helper reads a value back to the host, so a tick never synchronises
  with the device.

The float32 helpers (`ftz`, `fma`, `recip`) reproduce what XLA's CPU
backend does to the reference's float arithmetic, which the JAX lax path
and the golden fixtures carry: it flushes denormals to zero, contracts a
multiply that feeds an add into one fused multiply-add, and replaces a
division by a constant with a multiplication by the constant's float32
reciprocal. Eager torch does none of these on either device, so the
phases ask for them explicitly where the reference's expressions get
them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core import bloom
from ...kernels.bfc_step import ops as kernel_ops
from ..config import SimConfig
from ..topology import MAX_HOPS, TopoDims

I32 = torch.int32
F32 = torch.float32
BIG = 1 << 20  # large-but-packable sentinel for priority keys
INT32_MAX = 2**31 - 1
INT32_MIN = -2**31
FLT_MIN = float(np.finfo(np.float32).tiny)   # smallest normal float32


class Ranges(NamedTuple):
    """Index ranges reused every tick (int32 on the env's device)."""
    p: torch.Tensor      # (P,)
    q: torch.Tensor      # (Q,)
    s: torch.Tensor      # (S,)
    f: torch.Tensor      # (F,)
    srv: torch.Tensor    # (NSRV,)
    before: torch.Tensor  # (P, P) bool: column index < row index


class PhaseEnv(NamedTuple):
    """Constants shared by every phase of one simulation."""
    cfg: SimConfig           # .clos is unused — topology arrives as operands
    dims: TopoDims
    F: int                   # (padded) flow count
    RING: int                # feedback ring length (worst-case delay + 2)
    RRING: int               # retransmit ring length (rto + 1)
    bparams: bloom.BloomParams
    device: torch.device
    ar: Ranges

    @property
    def P(self) -> int:
        return self.dims.n_ports

    @property
    def NSRV(self) -> int:
        return self.dims.n_servers

    @property
    def NSW(self) -> int:
        return self.dims.n_switches

    @property
    def PROP_MAX(self) -> int:
        return self.dims.prop_max

    @property
    def Q(self) -> int:
        return self.cfg.proto.n_queues

    @property
    def CAP(self) -> int:
        return self.cfg.proto.queue_cap

    @property
    def PLCAP(self) -> int:
        return self.cfg.proto.pauselist_cap

    @property
    def H(self) -> int:
        return MAX_HOPS

    @property
    def S(self) -> int:
        return self.cfg.bloom_stages

    @property
    def TAU(self) -> int:
        return self.cfg.timing.tau_ticks


def make_env(dims: TopoDims, cfg: SimConfig, n_flows: int,
             device) -> PhaseEnv:
    # feedback ring sized for the worst-case one-way delay (a ring is a pure
    # delay line, so oversizing it never changes when feedback lands)
    device = torch.device(device)
    P = dims.n_ports

    def rng(n):
        return torch.arange(n, dtype=I32, device=device)

    p = rng(P)
    ar = Ranges(p=p, q=rng(cfg.proto.n_queues), s=rng(cfg.bloom_stages),
                f=rng(n_flows), srv=rng(dims.n_servers),
                before=p[None, :] < p[:, None])
    return PhaseEnv(cfg=cfg, dims=dims, F=int(n_flows),
                    RING=MAX_HOPS * dims.prop_max + 2,
                    RRING=cfg.timing.rto_ticks + 1,
                    bparams=bloom.BloomParams(cfg.bloom_stages,
                                              cfg.bloom_stage_bits),
                    device=device, ar=ar)


class StepCtx(NamedTuple):
    """Per-tick values threaded through the phase pipeline, grouped by
    producing phase."""
    # -- phase 0 (derive) ----------------------------------------------------
    t: Optional[torch.Tensor] = None
    occ: Optional[torch.Tensor] = None          # (P, Q) pre-tx occupancy
    port_occ: Optional[torch.Tensor] = None     # (P,)
    sw_occ: Optional[torch.Tensor] = None       # (NSW,)
    qpaused: Optional[torch.Tensor] = None      # (P, Q) head-of-queue pause
    th: Optional[torch.Tensor] = None           # (P,) dynamic pause threshold
    pfc_paused: Optional[torch.Tensor] = None   # (P,)
    rem_src: Optional[torch.Tensor] = None      # (F,) incl. this tick's work
    # the fused switch step's decision (see `derive`):
    ksel_q: Optional[torch.Tensor] = None       # (P,) DRR/SRF pick, -1 = none
    kcan_tx: Optional[torch.Tensor] = None      # (P,) pick exists
    kocc_after: Optional[torch.Tensor] = None   # (P, Q) post-tx occupancy
    # -- phase 1 (control) ---------------------------------------------------
    bloom_counts: Optional[torch.Tensor] = None
    bloom_mid: Optional[torch.Tensor] = None
    bloom_rx: Optional[torch.Tensor] = None
    pl: Optional[torch.Tensor] = None
    pl_head: Optional[torch.Tensor] = None
    f_paused: Optional[torch.Tensor] = None
    sfc_ring: Optional[torch.Tensor] = None     # (RING, F) + this tick's
    #                                             signals (SFC source pause)
    n_sfc: Optional[torch.Tensor] = None        # () i32 signals sent now
    # -- phase 2 (switch_tx) -------------------------------------------------
    can_tx: Optional[torch.Tensor] = None       # (P,)
    sel_q: Optional[torch.Tensor] = None        # (P,) picked queue (0 where
    #                                             ~can_tx)
    tx_entry: Optional[torch.Tensor] = None     # (P,)
    tx_hop: Optional[torch.Tensor] = None       # (P,)
    qhead: Optional[torch.Tensor] = None
    qptr: Optional[torch.Tensor] = None
    qsrf: Optional[torch.Tensor] = None
    f_cnt: Optional[torch.Tensor] = None
    f_q: Optional[torch.Tensor] = None
    d_cnt: Optional[torch.Tensor] = None
    d_q: Optional[torch.Tensor] = None
    ing_occ: Optional[torch.Tensor] = None
    bucket_cnt: Optional[torch.Tensor] = None
    occ_after: Optional[torch.Tensor] = None    # (P, Q) post-tx occupancy
    tx_ewma: Optional[torch.Tensor] = None
    # -- phase 3 (nic_tx) ----------------------------------------------------
    sent: Optional[torch.Tensor] = None
    tokens: Optional[torch.Tensor] = None
    nic_ptr: Optional[torch.Tensor] = None
    nic_tx: Optional[torch.Tensor] = None       # (NSRV,) bool
    nic_sel: Optional[torch.Tensor] = None      # (NSRV,)
    # -- phase 4 (arrivals) --------------------------------------------------
    wire_f: Optional[torch.Tensor] = None
    wire_hop: Optional[torch.Tensor] = None
    delivered: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None
    ack_ring: Optional[torch.Tensor] = None
    mark_ring: Optional[torch.Tensor] = None
    u_ring: Optional[torch.Tensor] = None
    retx_ring: Optional[torch.Tensor] = None
    qbuf: Optional[torch.Tensor] = None
    qtail: Optional[torch.Tensor] = None
    occ_new: Optional[torch.Tensor] = None      # (P, Q) post-arrival occupancy
    pl_tail: Optional[torch.Tensor] = None
    dropped: Optional[torch.Tensor] = None      # (P,) bool
    collide: Optional[torch.Tensor] = None      # (P,) bool
    needs_alloc: Optional[torch.Tensor] = None  # (P,) bool
    overflow_ev: Optional[torch.Tensor] = None  # () i32
    n_pauses: Optional[torch.Tensor] = None     # () i32
    # -- phase 5 (feedback) --------------------------------------------------
    acked: Optional[torch.Tensor] = None
    cwnd: Optional[torch.Tensor] = None
    cwnd_ref: Optional[torch.Tensor] = None
    rate: Optional[torch.Tensor] = None
    rate_target: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    ack_seen: Optional[torch.Tensor] = None
    mark_seen: Optional[torch.Tensor] = None
    cc_timer: Optional[torch.Tensor] = None
    since_dec: Optional[torch.Tensor] = None
    sfc_until: Optional[torch.Tensor] = None    # (F,) post-landing deadline


# ---- float32 arithmetic as the reference's compiled code does it --------------

def ftz(x):
    """Flush float32 denormals to (signed) zero."""
    return x * (x.abs() >= FLT_MIN)


def _as_f64(x):
    """A float32 operand widened to float64; a Python scalar is first
    rounded to float32, as a weakly typed scalar is in the reference."""
    return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding, denormals flushed.

    The float32 product is exact in float64. The float64 sum is made
    round-to-odd: TwoSum recovers its rounding error, and a non-zero error
    moves an even sum to its odd neighbour on the error's side. float64
    holds more than 2 * 24 + 2 bits, so rounding that to float32 gives the
    correctly rounded ``a * b + c`` (no double-rounding ties)."""
    p = a.double() * _as_f64(b)
    c = _as_f64(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return ftz(s.to(F32))


def recip(c) -> float:
    """The float32 reciprocal that a division by the constant `c` becomes
    (exact as a Python float, so ``x * recip(c)`` is one float32 multiply
    on either device)."""
    return float(np.float32(1) / np.float32(c))


# ---- scatter / gather helpers (JAX `.at[]` semantics) ------------------------

def _flat_index(shape, idx) -> torch.Tensor:
    """Row-major linear index of a full index tuple (broadcast). Every
    state tensor holds fewer than 2**31 entries, so int32 indices stay
    int32 (index_add takes them as they are)."""
    lin, stride = None, 1
    for d in range(len(shape) - 1, -1, -1):
        term = idx[d] if stride == 1 else idx[d] * stride
        lin = term if lin is None else lin + term
        stride *= shape[d]
    return lin


def _values(vals, x, lin):
    vals = vals.to(x.dtype)
    if vals.shape != lin.shape:
        vals = torch.broadcast_to(vals, lin.shape)
    return vals.reshape(-1)


def scatter_add(x, idx, vals):
    """``x.at[idx].add(vals)`` with every index in range (lanes that JAX
    would drop carry a zero value instead)."""
    lin = _flat_index(x.shape, idx)
    return x.reshape(-1).index_add(0, lin.reshape(-1),
                                   _values(vals, x, lin)).view(x.shape)


def _scatter_reduce(x, idx, vals, op):
    lin = _flat_index(x.shape, idx)
    return x.reshape(-1).scatter_reduce(
        0, lin.reshape(-1).long(), _values(vals, x, lin), op,
        include_self=True).view(x.shape)


def scatter_max(x, idx, vals, keep):
    """``x.at[where(keep, idx, OOB)].max(vals)``."""
    low = -float("inf") if x.is_floating_point() else INT32_MIN
    return _scatter_reduce(x, idx, torch.where(keep, vals.to(x.dtype), low),
                           "amax")


def scatter_min(x, idx, vals, keep):
    """``x.at[where(keep, idx, OOB)].min(vals)``."""
    return _scatter_reduce(x, idx,
                           torch.where(keep, vals.to(x.dtype), INT32_MAX),
                           "amin")


def scatter_set(x, idx, val, axis: int = 0):
    """``x.at[idx].set(val)`` where idx[axis] may equal ``x.shape[axis]``
    (JAX drops such lanes; here they land in a dump slice cut off after).
    Live indices must be unique or carry equal values."""
    pad = list(x.shape)
    pad[axis] = 1
    y = torch.cat([x, x.new_zeros(pad)], dim=axis)
    if not isinstance(val, torch.Tensor):
        # a Python value made on the device: indexing with it would copy a
        # host tensor, which a CUDA graph cannot capture
        val = torch.full((), val, dtype=x.dtype, device=x.device)
    y[tuple(idx)] = val
    out = y.narrow(axis, 0, x.shape[axis])
    return out if axis == 0 else out.contiguous()


def take_row(x, i):
    """``x[i]`` for a 0-d index tensor, without a host read of ``i``."""
    return x.index_select(0, i.view(1).long())[0]


def take_col(x, i):
    """``x[:, i]`` for a 0-d index tensor."""
    return x.index_select(1, i.view(1).long())[:, 0]


def segment_sum(vals, seg, num):
    """``jax.ops.segment_sum`` with every segment id in range."""
    return torch.zeros(num, dtype=vals.dtype, device=vals.device).index_add(
        0, seg.long(), vals)


def segment_min(vals, seg, num):
    """``jax.ops.segment_min`` (int32): empty segments hold int32 max."""
    return torch.full((num,), INT32_MAX, dtype=vals.dtype,
                      device=vals.device).scatter_reduce(
        0, seg.long(), vals, "amin", include_self=True)


# ---- ranks -------------------------------------------------------------------

def pairwise_rank(keys, valid, before):
    """rank[i] = #{j < i : valid[j] and keys[j] == keys[i]} for valid lanes
    (serialization), via the closed O(N^2) pairwise count (no sort).
    `before` is the (N, N) mask ``j < i`` (`PhaseEnv.ar.before`)."""
    rank = ((keys[None, :] == keys[:, None]) & before
            & valid[None, :]).sum(dim=1, dtype=I32)
    return rank * valid


class ArrivalLayout(NamedTuple):
    """ONE stable argsort over a composite serialization key; every
    same-tick rank/offset of the arrival phase derives from it (see
    `subset_rank`). `key` is INT32_MAX where `valid` is False."""
    key: torch.Tensor          # (N,) composite key, INT32_MAX where ~valid
    order: torch.Tensor        # (N,) the permutation (stable argsort of key)
    unsort: torch.Tensor       # (N,) inverse permutation
    group_start: torch.Tensor  # (N,) sorted-order index of each group head
    valid: torch.Tensor        # (N,) bool


def build_layout(keys, valid) -> ArrivalLayout:
    """Sort once; rank many. Stability keeps lanes of one key group in index
    order, so `subset_rank` equals a pairwise rank over the subset."""
    n = keys.shape[0]
    k = torch.where(valid, keys, INT32_MAX)
    order = torch.argsort(k, stable=True)
    ks = k[order]
    pos = torch.arange(n, dtype=I32, device=keys.device)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=keys.device), ks[1:] != ks[:-1]])
    group_start = torch.cummax(torch.where(new_group, pos, 0), 0).values
    unsort = torch.zeros(n, dtype=I32, device=keys.device).scatter(
        0, order, pos)
    return ArrivalLayout(key=k, order=order, unsort=unsort,
                         group_start=group_start, valid=valid)


def subset_rank(layout: ArrivalLayout, mask):
    """rank[i] = #{j < i : mask[j] and key[j] == key[i]} for mask[i] lanes
    (mask must be a subset of the layout's valid lanes)."""
    ms = mask[layout.order].to(I32)
    excl = torch.cumsum(ms, 0, dtype=I32) - ms      # subset lanes before s
    rank_sorted = excl - excl[layout.group_start]   # ... within s's group
    return rank_sorted[layout.unsort] * mask


def counts_per_key(keys, valid, num):
    return segment_sum(valid.to(I32), keys * valid, num)


def hop_of_port(routes, f, p):
    """Which hop of flow f's route is port p (f, p broadcastable); the first
    match, 0 when none."""
    hit = (routes[f] == p[..., None]).to(torch.uint8)
    return torch.argmax(hit, dim=-1).to(I32)


# ---- phase 0 -----------------------------------------------------------------

def derive_operands(env: PhaseEnv, st, ops, topo):
    """(args, kwargs) of the fused switch step (`kernel_ops.derive`) for
    state `st`: what `derive` hands it, for holding the kernel against
    its plain version on real states."""
    pc = env.cfg.proto
    args = (st.qhead, st.qtail, st.qbuf, st.qptr, st.qsrf, st.bloom_rx,
            st.ing_occ, st.pfc_paused, st.rem_src, ops.fpos, ops.arrival,
            ops.size, topo.port_switch, topo.port_is_nic, topo.feeds,
            topo.buffer_limit, st.t)
    kwargs = dict(n_switches=env.NSW, backpressure=pc.backpressure,
                  pfc=pc.pfc, scheduler=pc.scheduler, pfc_frac=pc.pfc_frac,
                  pause_window=env.cfg.timing.pause_window)
    return args, kwargs


def derive(env: PhaseEnv, st, ops, topo) -> StepCtx:
    """Phase 0: per-tick derived state.

    Queue occupancy, per-switch buffer fill, the head-of-queue pause bits
    from the received Bloom snapshot, PFC hysteresis, this tick's flow
    arrivals at the sources -- and the switch decision (pause threshold,
    DRR/SRF pick, post-tx occupancy of every port): ONE call of the fused
    switch step (`kernel_ops.derive`). On a CUDA tensor that is one launch
    of the hand-written kernel, on a CPU tensor its plain version
    (`kernels.bfc_step.ref.derive_ref`). The decision inputs (occ,
    qpaused, qptr/qsrf, pfc_paused, port_is_nic) are all fixed when
    `derive` ends, so `control` and `switch_tx` consume the stashed
    result."""
    args, kwargs = derive_operands(env, st, ops, topo)
    return StepCtx(t=st.t, **kernel_ops.derive(*args, **kwargs)._asdict())
