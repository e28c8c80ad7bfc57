"""Span recording (a copy of the span API of
``kubetorch_tpu/observability/tracing.py`` that the store, the KV pool and
the engine call).

Spans carry trace_id/span_id/parent_id, a contextvar holds the ambient
span, durations are ``time.perf_counter`` deltas and start stamps
``time.time``; finished spans land in a fixed-size per-process ring
(``KT_TRACE_RING``), and ``KT_TRACE_DISABLE=1`` turns recording off. The
export paths (Perfetto, controller assembly, slow-call pushes) belong to
the pod-server path, which is not ported yet.
"""

from __future__ import annotations

import collections
import contextvars
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from kubetorch_tpu_torch.config import env_bool, env_int, env_str

# (trace_id, span_id) of the ambient span
_ctx_var: contextvars.ContextVar = contextvars.ContextVar(
    "kt_torch_trace_ctx", default=None)

_PID = os.getpid()
_tls = threading.local()


def enabled() -> bool:
    return not env_bool("KT_TRACE_DISABLE")


def _identity() -> Dict[str, str]:
    return {"service": env_str("KT_SERVICE_NAME"),
            "pod": env_str("KT_POD_NAME") or "",
            "proc": env_str("KT_TRACE_PROC")}


def _rand() -> random.Random:
    # one urandom-seeded stream per thread (getrandbits is not atomic
    # across threads; ids only need to be collision-resistant)
    rng = getattr(_tls, "rng", None)
    if rng is None:
        rng = _tls.rng = random.Random(
            int.from_bytes(os.urandom(16), "little")
            ^ _PID ^ threading.get_ident())
    return rng


def _new_trace_id() -> str:
    return f"{_rand().getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand().getrandbits(64):016x}"


class SpanRecorder:
    """Fixed-size, thread-safe ring of finished spans (plain dicts)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = env_int("KT_TRACE_RING")
        self.capacity = max(16, capacity)
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque()
        self.seq = 0
        self.dropped = 0

    def record(self, span: Dict[str, Any]) -> None:
        with self._lock:
            while len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            span["seq"] = self.seq
            self.seq += 1
            self._ring.append(span)

    def snapshot(self, trace_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        return spans


recorder = SpanRecorder()


def _new_span(name: str, start: float, dur: float,
              attrs: Optional[dict]) -> Dict[str, Any]:
    ctx = _ctx_var.get()
    trace_id, parent_id = ctx if ctx else (_new_trace_id(), None)
    return {"trace_id": trace_id, "span_id": _new_span_id(),
            "parent_id": parent_id, "name": name, "start": start,
            "dur": max(0.0, float(dur)), **_identity(), "pid": _PID,
            "tid": threading.current_thread().name,
            "attrs": dict(attrs) if attrs else {}}


class _NullSpan:
    """The KT_TRACE_DISABLE fast path."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


class _Span:
    """One open span; entering makes it the ambient parent."""

    def __init__(self, name: str, attrs: Optional[dict]):
        self.span = _new_span(name, time.time(), 0.0, attrs)
        self._t0 = time.perf_counter()
        self._token = None

    def __enter__(self):
        self._token = _ctx_var.set((self.span["trace_id"],
                                    self.span["span_id"]))
        return self

    def __exit__(self, exc_type, exc, tb):
        _ctx_var.reset(self._token)
        self.span["dur"] = time.perf_counter() - self._t0
        if exc_type is not None:
            self.span["error"] = f"{exc_type.__name__}: {exc}"[:500]
        recorder.record(self.span)


def span(name: str, attrs: Optional[dict] = None):
    """Context manager: a span around the block, parented to the ambient
    span."""
    if not enabled():
        return _NullSpan()
    return _Span(name, attrs)


def record_span(name: str, dur_s: float, attrs: Optional[dict] = None,
                start: Optional[float] = None) -> None:
    """Record an already-measured interval of ``dur_s`` seconds starting
    at wall-clock ``start`` (default: backdated ``dur_s`` from now)."""
    if not enabled():
        return
    recorder.record(_new_span(
        name, (time.time() - dur_s) if start is None else start, dur_s,
        attrs))


def current_trace_id() -> Optional[str]:
    ctx = _ctx_var.get()
    return ctx[0] if ctx else None
