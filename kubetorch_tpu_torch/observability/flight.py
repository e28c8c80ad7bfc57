"""Engine flight recorder (a copy of
``kubetorch_tpu/observability/flight.py`` without its fleet merge and
Perfetto export, which belong to the pod-server path): a fixed-size ring
of per-driver-tick records, the black box an operator reads after a
stall or a crash.

Every ``DecodeEngine`` driver tick appends one record: sequence, wall and
monotonic stamps, the host/device split of the tick, what the scheduler
did (admits, prefill chunks, decode tokens, evictions, parks, sheds), how
loaded it was (queue depth, active rows, KV blocks free), the MFU/MBU of
the devstats window, and the trace ids of the programs live in the batch.
Appends are one tuple write into a preallocated slot; dicts are made only
at snapshot time. Each process owns one recorder (sized by
``KT_FLIGHT_RING``, off with ``KT_FLIGHT_DISABLE``). Shipping the ring to
the pod server and dumping it on preemption come with the pod-server
path.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from kubetorch_tpu_torch.config import env_bool, env_int

# One flat schema, positional in the ring (dicts materialize at
# snapshot time). ``seq`` is assigned by the recorder; everything else
# is the appender's. ``trace_ids`` is a tuple of the trace ids live in
# the batch at tick time (bounded), the join key against the spans.
FIELDS: Tuple[str, ...] = (
    "seq", "t_wall", "t_mono", "tick_s", "device_s", "host_s",
    "admits", "prefill_chunks", "prefill_tokens", "decode_tokens",
    "spec_rounds", "spec_accepted", "evictions", "parks", "handoffs",
    "sheds", "queue_depth", "active_rows", "kv_blocks_free",
    "mfu", "mbu", "trace_ids",
)
_N_VALUES = len(FIELDS) - 1   # appender supplies everything but seq

class FlightRecorder:
    """Preallocated ring of per-tick records.

    ``append`` takes the :data:`FIELDS` values *after* ``seq`` as
    positional arguments and writes one tuple into the ring slot —
    deliberately no kwargs, no dict: the driver tick calls this at
    device-step rate and the whole point of the recorder is to cost
    (asserted) <1% of a tick.
    """

    def __init__(self, capacity: int = 2048) -> None:
        self.capacity = max(16, int(capacity))
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._seq = 0
        self._lock = threading.Lock()

    @property
    def seq(self) -> int:
        """Total records ever appended (next record's seq)."""
        return self._seq

    def append(self, *values) -> None:
        if len(values) != _N_VALUES:
            raise ValueError(
                f"flight record takes {_N_VALUES} values, got {len(values)}")
        with self._lock:
            self._buf[self._seq % self.capacity] = (self._seq, *values)
            self._seq += 1

    def snapshot(self, since_seq: int = -1,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Records with ``seq > since_seq`` (oldest first) as dicts,
        optionally capped to the NEWEST ``limit`` records."""
        with self._lock:
            seq = self._seq
            start = max(0, seq - self.capacity, since_seq + 1)
            if limit is not None:
                start = max(start, seq - int(limit))
            rows = [self._buf[i % self.capacity] for i in range(start, seq)]
        return [dict(zip(FIELDS, row)) for row in rows if row is not None]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._seq = 0


# ------------------------------------------------------------------
# Per-process registry: one recorder per process.
_REG_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None


def enabled() -> bool:
    return not env_bool("KT_FLIGHT_DISABLE")


def get_recorder() -> Optional[FlightRecorder]:
    """This process's recorder (created on first use), or None when
    ``KT_FLIGHT_DISABLE`` is set."""
    global _RECORDER
    if not enabled():
        return None
    if _RECORDER is None:
        with _REG_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder(env_int("KT_FLIGHT_RING"))
    return _RECORDER
