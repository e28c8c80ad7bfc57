"""Retry-After arithmetic for shed programs (a copy of
``kubetorch_tpu/serving/replay.py::retry_after_estimate``; the result
retention ring around it belongs to the pod-server path)."""

from __future__ import annotations

from typing import Optional

from kubetorch_tpu_torch.config import env_float


def retry_after_estimate(queue_depth: int, max_depth: int,
                         ema_exec_s: float,
                         cap_s: Optional[float] = None) -> float:
    """Seconds an overloaded engine tells a shed caller to stay away: the
    excess queue length times the recent per-item EMA, i.e. roughly when a
    slot will be free, floored at 50 ms (a zero tells the client to
    hammer) and capped at ``KT_MAX_QUEUE_DELAY_S``."""
    if cap_s is None:
        cap_s = env_float("KT_MAX_QUEUE_DELAY_S")
    excess = max(1, queue_depth - max_depth + 1)
    return round(min(max(0.05, excess * max(0.01, ema_exec_s)), cap_s), 3)
