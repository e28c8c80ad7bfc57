"""Device utilization accounting for CUDA cards (port of
``kubetorch_tpu/observability/devstats.py``).

The engine reports two ratios over a window of work:

* **MFU**: FLOPs dispatched / (measured dispatch wall × the card's peak
  FLOP/s);
* **MBU**: device-memory bytes the dispatches move / (wall × peak
  bandwidth).

The JAX package takes its numerators from XLA's ``cost_analysis()`` of
each compiled executable. Eager PyTorch compiles nothing, so the port's
``RollingGenerator`` counts an analytic cost per dispatch into
:class:`AnalyticCosts` (the accumulator the JAX package gives its
simulated engine), with the same snapshot surface. Peaks come from a
table keyed by the card's name; an unknown card (or the CPU) has none, and
the engine then publishes no MFU/MBU at all (absent, not zero). Device
memory occupancy reads ``torch.cuda.memory_stats`` without ever
initializing CUDA.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

# (peak dense bf16 FLOP/s, peak device-memory bytes/s) keyed by a
# substring of the lower-cased ``torch.cuda.get_device_name``: the H100
# SXM's published 989 TFLOP/s dense bf16 and 3.35 TB/s HBM3.
_PEAKS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("h100 80gb hbm3", (989e12, 3.35e12)),
    ("h100 sxm", (989e12, 3.35e12)),
)


def peaks_for_kind(device_name: str) -> Optional[Tuple[float, float]]:
    """(peak_flops, peak_bytes_per_s) for a CUDA device name, or None when
    the card is not in the table."""
    name = (device_name or "").lower()
    for needle, peaks in _PEAKS:
        if needle in name:
            return peaks
    return None


def device_peaks(device: Optional[torch.device] = None
                 ) -> Optional[Tuple[float, float]]:
    """Peaks of ``device`` (default: the current CUDA device), or None on
    the CPU, on an unknown card, or before CUDA is initialized (a metrics
    read must not acquire a device)."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_initialized():
            return None
        return peaks_for_kind(torch.cuda.get_device_name(device))
    # ktlint: disable=KT004 -- metrics introspection must never raise into the serving path
    except Exception:  # noqa: BLE001
        return None


def hbm_stats(device: Optional[torch.device] = None
              ) -> Optional[Dict[str, float]]:
    """``hbm_used_bytes`` (bytes allocated by the caching allocator) and
    ``hbm_limit_bytes`` (the card's memory) of one CUDA device (default:
    the current one), or None on the CPU or before CUDA is initialized.
    (The JAX package sums its local devices; a torch process would make a
    context on every card it asked.)"""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats(device)
        return {"hbm_used_bytes": float(
                    stats.get("allocated_bytes.all.current", 0)),
                "hbm_limit_bytes": float(torch.cuda.get_device_properties(
                    device or torch.cuda.current_device()).total_memory)}
    # ktlint: disable=KT004 -- metrics introspection must never raise into the serving path
    except Exception:  # noqa: BLE001
        return None


class AnalyticCosts:
    """Running totals of per-dispatch FLOPs and bytes, with the snapshot
    surface the engine reads (``captured_executables`` stays 0: nothing
    here is compiler-measured)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flops = 0.0
        self._bytes = 0.0
        self._dispatches = 0

    def count(self, flops: float, bytes_: float) -> None:
        with self._lock:
            self._flops += float(flops)
            self._bytes += float(bytes_)
            self._dispatches += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "flops_total": self._flops,
                "bytes_total": self._bytes,
                "dispatches_total": float(self._dispatches),
                "captured_executables": 0.0,
            }


def utilization(flops: float, bytes_: float, wall_s: float,
                peaks: Optional[Tuple[float, float]],
                ) -> Optional[Tuple[float, float]]:
    """(mfu, mbu) for a window of work, clamped to [0, 1]; None when
    peaks are unknown or the window carries no measured wall."""
    if peaks is None or wall_s <= 0.0:
        return None
    peak_flops, peak_bw = peaks
    mfu = min(1.0, max(0.0, flops / (wall_s * peak_flops))) \
        if peak_flops > 0 else 0.0
    mbu = min(1.0, max(0.0, bytes_ / (wall_s * peak_bw))) \
        if peak_bw > 0 else 0.0
    return mfu, mbu
