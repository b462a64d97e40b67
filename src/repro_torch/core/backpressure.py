"""The BFC control law (§3.3.2): torch counterpart of
`repro.core.backpressure`.

    Th = (hrtt + tau) * mu / max(n_active, 1)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BackpressureParams:
    hrtt: float                 # one-hop RTT in control units
    tau: float                  # signalling period; paper uses 0.5 * hrtt
    mu: float = 1.0             # egress rate in packets per control unit
    resumes_per_interval: int = 1  # one resume per tau = two per HRTT (§3.3.2)

    @property
    def pause_window(self) -> float:
        return self.hrtt + self.tau


def pause_threshold(params: BackpressureParams, n_active) -> torch.Tensor:
    """Th = (HRTT + tau) * (mu / N_active), in packets. ceil'd, >= 1."""
    n = torch.clamp(torch.as_tensor(n_active), min=1).to(torch.float32)
    num = torch.full_like(n, params.pause_window * params.mu)
    th = torch.ceil(num / n)
    return torch.clamp(th, min=1.0).to(torch.int32)


def should_pause(queue_len, th) -> torch.Tensor:
    """Pause the flow whose arrival pushed its queue past the threshold."""
    return torch.as_tensor(queue_len) > torch.as_tensor(th)


def should_resume(queue_len, th) -> torch.Tensor:
    """Re-enable once the queue drains below the same threshold."""
    return torch.as_tensor(queue_len) < torch.as_tensor(th)


def worst_case_buffer(params: BackpressureParams, n_active) -> torch.Tensor:
    """Upper bound on per-queue buffering: Th + (HRTT+tau)*mu (§3.3.2)."""
    return pause_threshold(params, n_active) + int(
        torch.ceil(torch.tensor(params.pause_window * params.mu,
                                dtype=torch.float32)))
