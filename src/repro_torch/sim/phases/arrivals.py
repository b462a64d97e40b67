"""Phase 4: wire propagation + arrival processing (paper §3.2-3.3).

Torch port of `repro.sim.phases.arrivals`. Writes this tick's
transmissions onto the wires, reads the packets whose propagation delay
expires now, then processes every arrival in parallel: deliveries schedule
delayed feedback (ACK / ECN echo / HPCC INT / FairQ bottleneck flow
counts); switch arrivals pass the shared-buffer admission check, get a
queue (existing assignment, else dynamic first-free / stochastic hash), are
ECN-marked, enqueued, and may trigger a BFC pause when their queue crosses
the dynamic threshold. Drops schedule retransmit credits after an RTO.

Same-tick arrivals serialize through ONE stable argsort per tick (the
`(port * Q + queue)` `ArrivalLayout`); the two ranks that must precede the
queue assignment use the closed O(N^2) `pairwise_rank`.
"""
from __future__ import annotations

import torch

from ...core import bloom
from ...core.hashing import as_u32, hash_u32
from .ctx import (BIG, F32, I32, PhaseEnv, StepCtx, build_layout,
                  counts_per_key, fma, lane_scalar, lane_sum, pairwise_rank,
                  recip, scatter_add, scatter_max, scatter_min, scatter_set,
                  segment_sum, subset_rank, take_col)

# argsorts in one arrival step (the ONE `build_layout` call below)
SORTS_PER_TICK = 1


def _last_writer(key, live, n_keys):
    """live lanes that are the highest-index live lane of their key: the
    lane whose value a sequential `.at[].set` leaves behind, resolved
    deterministically (a CUDA set-scatter with repeated indices is not)."""
    lane = torch.arange(key.shape[0], dtype=I32, device=key.device)
    cand = torch.where(live, lane, -1)
    top = torch.full((n_keys,), -1, dtype=I32, device=key.device)
    top = top.scatter_reduce(0, torch.where(live, key, 0).long(), cand,
                             "amax", include_self=True)
    return live & (top[torch.where(live, key, 0)] == lane)


def _wires(env: PhaseEnv, st, topo, new_entry, new_hop):
    """(arriving entries, arriving hops, wire_f, wire_hop): read this tick's
    slot of every wire and write the new transmissions there. Wires are
    (P, PROP_MAX) rings wrapping at the fabric's link delay, so a packet
    written now resurfaces exactly `prop_ticks` ticks later. One slot when
    every lane has the same delay (`prop_ticks` 0-d); else a slot per lane."""
    K = env.lanes
    if topo.prop_ticks.dim() == 0:
        slot = (st.t % topo.prop_ticks).view(1).long()
        return (take_col(st.wire_f, slot[0]), take_col(st.wire_hop, slot[0]),
                st.wire_f.index_copy(1, slot, new_entry[:, None]),
                st.wire_hop.index_copy(1, slot, new_hop[:, None]))
    slot = (st.t % topo.prop_ticks).long().view(K, 1, 1).expand(
        K, env.dims.n_ports, 1)
    wf = st.wire_f.view(K, -1, env.PROP_MAX)
    wh = st.wire_hop.view(K, -1, env.PROP_MAX)
    return (wf.gather(2, slot).view(-1), wh.gather(2, slot).view(-1),
            wf.scatter(2, slot, new_entry.view(slot.shape)).view(
                st.wire_f.shape),
            wh.scatter(2, slot, new_hop.view(slot.shape)).view(
                st.wire_hop.shape))


def arrivals(env: PhaseEnv, st, ops, topo, ctx: StepCtx) -> StepCtx:
    pc, tm = env.cfg.proto, env.cfg.timing
    P, Q, F, H, CAP = env.P, env.Q, env.F, env.H, env.CAP
    NDST, PLCAP = env.NDST, env.PLCAP
    ar = env.ar
    p_ar = ar.p
    t = ctx.t

    # ---- write wires / read arrivals ----------------------------------------
    new_entry = torch.where(ctx.can_tx, ctx.tx_entry, -1)
    new_hop = torch.where(ctx.can_tx, ctx.tx_hop, 0)
    # each lane's servers transmit from its first NSRV ports
    by_lane = new_entry.view(env.lanes, -1)
    nsrv = env.dims.n_servers
    nic_tx = ctx.nic_tx.view(env.lanes, nsrv)
    new_entry = torch.cat([torch.where(nic_tx, (ctx.nic_sel * 2).view(
        nic_tx.shape), by_lane[:, :nsrv]), by_lane[:, nsrv:]],
        dim=1).view(-1)
    arr_entry, arr_hop, wire_f, wire_hop = _wires(env, st, topo, new_entry,
                                                  new_hop)

    a_valid = arr_entry >= 0                          # (P,) indexed by u
    a_f = (arr_entry >> 1).clamp(min=0)
    a_mark = arr_entry & 1
    a_next_hop = (arr_hop + 1).clamp(max=H - 1)
    next_port_raw = ops.routes[a_f, a_next_hop]
    last_hop = (arr_hop + 1 >= H) | (next_port_raw < 0)
    is_delivery = a_valid & last_hop
    is_sw_arr = a_valid & ~last_hop
    p_arr = next_port_raw.clamp(min=0)                # target egress port

    # deliveries --------------------------------------------------------------
    delivered = scatter_add(st.delivered, (a_f,), is_delivery.to(I32))
    just_done = is_delivery & (delivered[a_f] >= ops.size[a_f]) \
        & (st.done[a_f] < 0)
    done = scatter_set(st.done, (torch.where(just_done, a_f, F),), t)
    # feedback scatter (ACK + ECN echo + HPCC INT); the one-way feedback
    # delay derives from the link delay of the arrival's lane
    fb_delay = (ops.hops[a_f].view(env.lanes, -1)
                * lane_scalar(topo.prop_ticks) + 1).view(-1)
    fb_slot = (t + fb_delay) % env.RING
    ack_ring = scatter_add(st.ack_ring, (fb_slot, a_f), is_delivery.to(I32))
    mark_ring = scatter_add(st.mark_ring, (fb_slot, a_f),
                            (is_delivery & (a_mark > 0)).to(I32))
    u_ring = st.u_ring
    if pc.cc == "hpcc":
        # sample path utilization (max over hops): qlen/BDP + tx rate
        rp = ops.routes[a_f]                                 # (P, H)
        rpc = rp.clamp(min=0)
        hop_util = fma(ctx.port_occ[rpc].to(F32), recip(tm.bdp_pkts),
                       ctx.tx_ewma[rpc])
        hop_util = torch.where(rp >= 0, hop_util, 0.0)
        u_path = hop_util.amax(dim=1)
        u_ring = scatter_max(u_ring, (fb_slot, a_f), u_path, is_delivery)
    elif pc.cc == "fairq":
        # FairQ: the delivery echoes the max active-flow count over the
        # path's links (NIC uplink included)
        active_f = (ops.arrival <= t) & (st.done < 0)            # (F,)
        per_port = segment_sum(
            (active_f[:, None] & (ops.routes >= 0)).to(I32).reshape(-1),
            ops.routes.clamp(min=0).reshape(-1), P)
        rp = ops.routes[a_f]                                     # (P, H)
        hop_n = torch.where(rp >= 0, per_port[rp.clamp(min=0)].to(F32), 0.0)
        u_ring = scatter_max(u_ring, (fb_slot, a_f), hop_n.amax(dim=1),
                             is_delivery)

    # switch arrivals ---------------------------------------------------------
    sw_arr = topo.port_switch[p_arr].clamp(min=0)     # target switch
    # buffer-limit check (serialize same-switch arrivals)
    rank_sw = pairwise_rank(sw_arr, is_sw_arr, ar.before)
    room = ((ctx.sw_occ[sw_arr] + rank_sw).view(env.lanes, -1)
            < lane_scalar(topo.buffer_limit)).view(-1)
    # queue assignment
    f_cnt, f_q = ctx.f_cnt, ctx.f_q
    d_cnt, d_q = ctx.d_cnt, ctx.d_q
    occ_after = ctx.occ_after
    dst_a = ops.dst[a_f]
    if pc.queue_key == "dest":
        have = is_sw_arr & (d_cnt[p_arr, dst_a] > 0)
        q_exist = d_q[p_arr, dst_a].clamp(min=0)
    else:
        have = is_sw_arr & (f_cnt[a_f, a_next_hop] > 0)
        q_exist = f_q[a_f, a_next_hop].clamp(min=0)
    needs_alloc = is_sw_arr & ~have
    fid_a = ops.fid[a_f]
    if pc.dynamic_queues:
        free = occ_after == 0                         # (P, Q) post-tx
        free_keyed = torch.where(free, ar.q[None, :], Q + ar.q[None, :])
        free_order = torch.argsort(free_keyed[p_arr], dim=1, stable=True)
        n_free = free[p_arr].sum(dim=1, dtype=I32)
        r_alloc = pairwise_rank(p_arr, needs_alloc, ar.before)
        got_free = needs_alloc & (r_alloc < n_free)
        q_fresh = torch.gather(free_order, 1,
                               r_alloc.clamp(max=Q - 1).long()[:, None]
                               )[:, 0].to(I32)
        # collision fallback: random queue (paper's choice); the uint32 add
        # wraps at 2**32
        q_rand = (hash_u32((as_u32(fid_a) + as_u32(t)) & 0xFFFFFFFF, 3)
                  % Q).to(I32)
        q_new = torch.where(got_free, q_fresh, q_rand)
        collide = needs_alloc & ~got_free
    else:
        key_hash = fid_a if pc.queue_key == "flow" else dst_a
        q_new = (hash_u32(key_hash, 2) % Q).to(I32)
        # stochastic assignment: collision = lands in a busy queue
        collide = needs_alloc & (occ_after[p_arr, q_new] > 0)
    a_q = torch.where(have, q_exist, q_new)
    # THE one sort: every post-assignment rank/offset and both
    # counts_per_key folds below derive from this composite-key layout
    layout = build_layout(p_arr * Q + a_q, is_sw_arr)
    # ring-capacity check
    off_ring = subset_rank(layout, is_sw_arr)
    ring_room = (occ_after[p_arr, a_q] + off_ring) < CAP
    accept = is_sw_arr & room & ring_room
    dropped = is_sw_arr & ~accept
    # ECN mark decision (on the *total* egress-port occupancy)
    if pc.ecn:
        pocc = ctx.port_occ[p_arr]
        if pc.cc == "dctcp":
            mark_new = pocc >= pc.ecn_kmin
        else:
            frac = ((pocc - pc.ecn_kmin).to(F32)
                    * recip(max(pc.ecn_kmax - pc.ecn_kmin, 1))).clamp(0.0, 1.0)
            rnd = (hash_u32(as_u32(fid_a) ^ as_u32(t), 1).to(F32)
                   / float(2**32))
            mark_new = rnd < frac
        a_mark = torch.maximum(a_mark, mark_new.to(I32))
    # enqueue scatter (accepted lanes have unique ring slots)
    off = subset_rank(layout, accept)
    pos_in_ring = (st.qtail[p_arr, a_q] + off) % CAP
    entry_val = a_f * 2 + a_mark
    qbuf = scatter_set(st.qbuf, (torch.where(accept, p_arr, P), a_q,
                                 pos_in_ring), entry_val)
    add_per_pq = counts_per_key(layout.key, accept, P * Q).reshape(P, Q)
    qtail = st.qtail + add_per_pq
    occ_new = occ_after + add_per_pq
    # SRF key: min remaining size of flows in queue
    qsrf = ctx.qsrf
    if pc.scheduler == "srf":
        remaining = (ops.size[a_f] - delivered[a_f]).clamp(min=1)
        qsrf = scatter_min(qsrf, (p_arr, a_q), remaining.clamp(max=BIG),
                           accept)
    # per-flow per-hop bookkeeping ((flow, hop) is unique per tick: a flow
    # reaches hop h only from its one upstream port)
    acc_f = torch.where(accept, a_f, F)
    was_zero = f_cnt[a_f, a_next_hop] == 0
    f_cnt = scatter_add(f_cnt, (a_f, a_next_hop), accept.to(I32))
    f_q = scatter_set(f_q, (acc_f, a_next_hop), a_q)
    if pc.queue_key == "dest":
        d_cnt = scatter_add(d_cnt, (p_arr, dst_a), accept.to(I32))
        # two arrivals for one (port, dst) can pick different queues in
        # one tick: the last lane wins, as in a sequential scatter
        win = _last_writer(p_arr * NDST + dst_a, accept, P * NDST)
        d_q = scatter_set(d_q, (torch.where(win, p_arr, P), dst_a), a_q)
    # hash-table activation + overflow stat
    act = accept & was_zero
    fb_a = ops.fbucket[a_f]
    prev_bucket = ctx.bucket_cnt[sw_arr, fb_a]
    overflow_ev = lane_sum(env, act & (prev_bucket
                                       >= env.cfg.ft_bucket_size))
    bucket_cnt = scatter_add(ctx.bucket_cnt, (sw_arr, fb_a), act.to(I32))
    # PFC ingress accounting: the arrival index IS the upstream port
    ing_occ = ctx.ing_occ + accept.to(I32)

    # BFC pause decision: queue exceeded threshold after this arrival
    f_paused, bloom_counts = ctx.f_paused, ctx.bloom_counts
    pl, pl_tail = ctx.pl, st.pl_tail
    if pc.backpressure:
        qlen_now = occ_new[p_arr, a_q]
        over = accept & (qlen_now > ctx.th[p_arr]) \
            & ~f_paused[a_f, a_next_hop]
        # never overflow the to-be-resumed ring: skip the pause instead
        # (costs a little buffering, cannot strand a flow); 32 = headroom
        # for same-tick pushes to one queue (max = ingress degree)
        over &= (pl_tail[p_arr, a_q] - ctx.pl_head[p_arr, a_q]) < PLCAP - 32
        f_paused = scatter_set(f_paused, (torch.where(over, a_f, F),
                                          a_next_hop), True)
        bloom_counts = bloom.add_batch(bloom_counts, p_ar, ops.fpos[a_f],
                                       over.to(I32))
        # push onto the to-be-resumed ring of (p_arr, a_q)
        push_off = subset_rank(layout, over)
        pl_pos = (pl_tail[p_arr, a_q] + push_off) % PLCAP
        pl = scatter_set(pl, (torch.where(over, p_arr, P), a_q, pl_pos), a_f)
        pl_tail = pl_tail + counts_per_key(
            layout.key, over, P * Q).reshape(P, Q)
        n_pauses = lane_sum(env, over)
    else:
        n_pauses = torch.zeros(env.lead, dtype=I32, device=env.device)

    # drops: schedule a retransmit credit after RTO
    retx_slot = (t + tm.rto_ticks) % env.RRING
    retx_ring = scatter_add(st.retx_ring, (retx_slot, a_f), dropped.to(I32))

    return ctx._replace(
        wire_f=wire_f, wire_hop=wire_hop, delivered=delivered, done=done,
        ack_ring=ack_ring, mark_ring=mark_ring, u_ring=u_ring,
        retx_ring=retx_ring, qbuf=qbuf, qtail=qtail, occ_new=occ_new,
        qsrf=qsrf, f_cnt=f_cnt, f_q=f_q, d_cnt=d_cnt, d_q=d_q,
        bucket_cnt=bucket_cnt, ing_occ=ing_occ, f_paused=f_paused,
        bloom_counts=bloom_counts, pl=pl, pl_tail=pl_tail, dropped=dropped,
        collide=collide, needs_alloc=needs_alloc, overflow_ev=overflow_ev,
        n_pauses=n_pauses)
