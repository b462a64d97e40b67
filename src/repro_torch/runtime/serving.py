"""Continuous-batching serving engine with BFC admission control: a
line-for-line port of `repro.runtime.serving`'s control plane onto
`repro_torch.core.backpressure`.

Requests are flows, decode slots are the physical queues, the decode
step is the egress link, clients are upstream switches: dynamic slot
assignment from a free list (§3.3.1), the pause threshold
Th = (HRTT + tau) * mu / N_active on the pending queue (§3.3.2), and at
most `resumes_per_interval` resumes per control interval. Prompts are
prefilled one token per engine tick through the decode step.

Behaviour carried over from the reference as it is: `_assign_slots`
resets only a slot's `kv_len`. The recurrent state of a 'rec' block
(`h`, `conv`) or an 'rwkv' block (`S`, `shift`, `shift_cm`) is not
cleared when a slot is reassigned, and idle slots are stepped on token 0
each tick, so a request that lands on a used slot starts from another
request's state. Attention-only models are unaffected
(they mask by kv_len). The tests hold the port to the reference's tokens,
this included.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..core.backpressure import BackpressureParams, pause_threshold
from ..models import model
from ..models.config import ModelConfig
from . import steps as steps_mod


@dataclass
class Request:
    rid: int
    client: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0          # tokens of prompt consumed


@dataclass
class ServeStats:
    admitted: int = 0
    completed: int = 0
    pauses_sent: int = 0
    resumes_sent: int = 0
    peak_pending: int = 0
    slot_occupancy_sum: int = 0
    ticks: int = 0


class BFCServer:
    """Serves on the device the parameters live on."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_len: int = 256, hrtt_ticks: int = 2, eos: int = -1):
        self.cfg = cfg
        self.params = params
        self.device = params["embedding"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos
        self.bp = BackpressureParams(hrtt=hrtt_ticks, tau=hrtt_ticks / 2)
        self._decode = steps_mod.make_decode_step(cfg)
        self.cache = model.init_cache(cfg, n_slots, max_len,
                                      device=self.device)
        self.kv_len = np.zeros(n_slots, np.int64)   # per-slot lengths (host)
        self.free: List[int] = list(range(n_slots))
        self.active: Dict[int, Request] = {}        # slot -> request
        self.pending: collections.deque = collections.deque()
        self.paused_clients: set = set()
        self.resume_rr: collections.deque = collections.deque()
        self.stats = ServeStats()
        self._tick = 0
        self._mu_ema = 1.0   # tokens/tick drained

    # ---- BFC control plane ---------------------------------------------------
    def _threshold(self) -> int:
        n_active = max(len(self.active), 1)
        p = BackpressureParams(hrtt=self.bp.hrtt, tau=self.bp.tau,
                               mu=max(self._mu_ema, 1e-3))
        return int(pause_threshold(p, n_active))

    def submit(self, req: Request) -> bool:
        """Returns False if the client is currently paused (caller should
        hold the request and retry after resume)."""
        if req.client in self.paused_clients:
            return False
        self.pending.append(req)
        self.stats.admitted += 1
        self.stats.peak_pending = max(self.stats.peak_pending,
                                      len(self.pending))
        # pause decision on arrival, exactly like the switch (§3.3.2)
        if len(self.pending) > self._threshold():
            if req.client not in self.paused_clients:
                self.paused_clients.add(req.client)
                self.resume_rr.append(req.client)
                self.stats.pauses_sent += 1
        return True

    def _control_interval(self):
        """Every tau ticks: resume at most `resumes_per_interval` clients."""
        if len(self.pending) < self._threshold():
            for _ in range(self.bp.resumes_per_interval):
                if not self.resume_rr:
                    break
                c = self.resume_rr.popleft()
                self.paused_clients.discard(c)
                self.stats.resumes_sent += 1

    # ---- data plane ------------------------------------------------------------
    def _assign_slots(self):
        while self.free and self.pending:
            req = self.pending.popleft()
            slot = self.free.pop(0)            # free-list assignment (§3.3.1)
            req.slot = slot
            self.active[slot] = req
            self.kv_len[slot] = 0              # as the reference: state stays

    def tick(self) -> List[Request]:
        """One engine step: feed each active slot its next token (prompt
        prefill or generated), run the decode step, collect completions."""
        self._tick += 1
        self.stats.ticks += 1
        if self._tick % max(int(self.bp.tau), 1) == 0:
            self._control_interval()
        self._assign_slots()
        if not self.active:
            return []

        feed = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in self.active.items():
            if req.pos < len(req.prompt):
                feed[slot, 0] = req.prompt[req.pos]
            else:
                feed[slot, 0] = req.out[-1] if req.out else req.prompt[-1]
        # per-slot lengths: attention masks, rope positions and cache writes
        # all honor each slot's own kv_len (heterogeneous batch)
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.from_numpy(feed).long().to(self.device),
            torch.from_numpy(self.kv_len).to(self.device))
        next_ids = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()

        finished = []
        drained = 0
        for slot in list(self.active):
            req = self.active[slot]
            self.kv_len[slot] += 1
            produced = False
            if req.pos < len(req.prompt):
                req.pos += 1          # prompt token consumed (prefill)
                # the step that consumed the LAST prompt token already
                # produced the first generated token
                produced = req.pos == len(req.prompt)
            else:
                produced = True
            if produced:
                tok = int(next_ids[slot])
                req.out.append(tok)
                drained += 1
                if len(req.out) >= req.max_new or tok == self.eos \
                        or self.kv_len[slot] >= self.max_len - 1:
                    finished.append(req)
                    del self.active[slot]
                    self.free.append(slot)    # queue reclaimed (§3.3.1)
                    self.stats.completed += 1
        self.stats.slot_occupancy_sum += len(self.active)
        self._mu_ema = 0.9 * self._mu_ema + 0.1 * drained
        return finished

    def drain(self, max_ticks: int = 10_000) -> List[Request]:
        done = []
        t = 0
        while (self.active or self.pending) and t < max_ticks:
            done.extend(self.tick())
            t += 1
        return done
