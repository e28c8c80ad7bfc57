"""Server-resident continuous-batching decode engine (port of
``kubetorch_tpu/serving/engine.py``: ``GenerationProgram``, ``program``,
``DecodeEngine`` and ``SimRollingEngine``).

A client submits one **generation program** (prompt(s), stopping
criteria, sampling settings, an optional deadline) and gets back a
generator of token frames. :class:`DecodeEngine`'s driver thread runs
rolling-engine steps back to back and routes each chunk's tokens into the
programs' streams, with a per-row admission scheduler on top:

- new requests are admitted into free rows of the live batch
  (``RollingGenerator.admit``), long prompts prefill chunk by chunk
  between decode chunks (``prefill_step``);
- rows are evicted on stop/EOS (the rolling engine's own finish path), on
  the program's deadline (``deadline_s``, row-granular) and when the
  client abandons the stream;
- when no row is expected to free within ``KT_MAX_QUEUE_DELAY_S``, or the
  KV-block budget cannot hold a program, it is shed with a typed
  :class:`~kubetorch_tpu_torch.exceptions.ServerOverloaded` carrying a
  computed ``retry_after``.

Under the scheduler sits the paged-KV manager (``serving/kvpool.py``):
prompts split by ``KT_KV_PREFIX_SPLIT`` share content-hashed, refcounted
prefix blocks (a hit reuses the registered device block and prefills only
the suffix); admission is priced in KV blocks (``KT_KV_BLOCK_TOKENS``)
against one budget (``KT_KV_HBM_BUDGET``); ``session_id`` programs can
park (explicit :meth:`DecodeEngine.park`, or a deadline) through the store
and a later program of the same session resumes mid-generation without a
new prefill.

Not ported here: the disaggregated prefill/decode phases and their row
handoff (a new ``ROADMAP.md`` Queue 1 item), named adapters and the
adapter pool (item 3), speculative engines (item 4), and the Prometheus
export of the engine's counters, which comes with the pod-server path
(item 2); :meth:`DecodeEngine.stats` carries them meanwhile. The rolling
engine is built by the caller and passed in; :class:`SimRollingEngine` is
its host-only twin for the scheduler's tests.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from kubetorch_tpu_torch.config import env_float, env_int, env_str
from kubetorch_tpu_torch.exceptions import (DeadlineExceeded,
                                            KVGeometryMismatch,
                                            ServerOverloaded)
from kubetorch_tpu_torch.observability import devstats, flight, tracing
from kubetorch_tpu_torch.serving import kvpool
from kubetorch_tpu_torch.serving.replay import retry_after_estimate

# engine phases of the JAX package (the disaggregated tiers); only "mixed",
# the monolithic engine, is ported
_PHASES = ("prefill", "decode", "mixed")
_PHASES_ITEM = "ROADMAP.md Queue 1 item 8 (disaggregated phases)"
_ADAPTERS_ITEM = "ROADMAP.md Queue 1 item 3 (LoRA)"
_SPEC_ITEM = "ROADMAP.md Queue 1 item 4 (speculation)"


class GenerationProgram:
    """Validated form of the JSON generation program a client submits.

    Wire shape (all JSON-able)::

        {"prompt": [1, 2, 3],          # or "prompts": [[...], [...]]
         "max_new_tokens": 128,
         "temperature": 0.0,
         "stop": [[13, 10]],           # optional stop token sequences
         "repetition_penalty": 1.0,
         "adapter_id": -1,
         "prefix_id": None,
         "session_id": "user-42",      # optional: parkable session
         "deadline_s": 30.0,           # optional whole-program budget
         "tag": "req-abc"}             # optional idempotency/debug tag

    ``deadline_s`` is relative (seconds from receipt): the engine stamps
    the absolute deadline on its own clock. The JAX package's ``adapter``
    (a pool-managed name) and ``handoff``/``handoff_id`` (the
    disaggregated phases) fields parse here too; the engine refuses them.
    """

    def __init__(self, prompts: List[List[int]], max_new_tokens: int,
                 temperature: float, stop, repetition_penalty: float,
                 adapter_id: int, prefix_id: Optional[int],
                 deadline_s: Optional[float], tag: Optional[str],
                 session_id: Optional[str] = None,
                 adapter: Optional[str] = None,
                 handoff: Optional[Dict[str, Any]] = None,
                 handoff_id: Optional[str] = None):
        self.prompts = prompts
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.stop = stop
        self.repetition_penalty = repetition_penalty
        self.adapter_id = adapter_id
        self.adapter = adapter
        self.prefix_id = prefix_id
        self.deadline_s = deadline_s
        self.tag = tag
        self.session_id = session_id
        self.handoff = handoff
        self.handoff_id = handoff_id

    @classmethod
    def from_wire(cls, obj: Any) -> "GenerationProgram":
        if not isinstance(obj, dict):
            raise ValueError(
                f"generation program must be a dict, got {type(obj).__name__}")
        if "prompts" in obj:
            prompts = obj["prompts"]
        elif "prompt" in obj:
            prompts = [obj["prompt"]]
        else:
            raise ValueError("generation program needs 'prompt' or 'prompts'")
        if (not isinstance(prompts, list) or not prompts
                or not all(isinstance(p, list) and p for p in prompts)):
            raise ValueError("prompts must be a non-empty list of "
                             "non-empty token lists")
        prompts = [[int(t) for t in p] for p in prompts]
        deadline_s = obj.get("deadline_s")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        session_id = obj.get("session_id")
        if session_id is not None:
            kvpool.check_session_id(session_id)
            if len(prompts) != 1:
                # a session parks/restores ONE row's KV
                raise ValueError("session_id programs must carry exactly "
                                 "one prompt")
        adapter = obj.get("adapter")
        if adapter is not None:
            if not isinstance(adapter, str) or not adapter:
                raise ValueError(
                    f"adapter must be a non-empty string name, "
                    f"got {adapter!r}")
            if int(obj.get("adapter_id", -1)) != -1:
                raise ValueError(
                    "pass adapter= (pool-managed name) or adapter_id= "
                    "(raw slot), not both")
        handoff = obj.get("handoff")
        handoff_id = obj.get("handoff_id")
        if handoff is not None and handoff_id is not None:
            raise ValueError(
                "pass handoff= (prefill side: export the row) or "
                "handoff_id= (decode side: import it), not both")
        if handoff is not None or handoff_id is not None:
            if session_id is not None:
                raise ValueError(
                    "handoff programs cannot also carry session_id")
            if len(prompts) != 1:
                raise ValueError(
                    "handoff programs must carry exactly one prompt "
                    "(one exported row per handoff id)")
        if handoff is not None and (not isinstance(handoff, dict)
                                    or "id" not in handoff):
            raise ValueError(
                "handoff must be a dict with at least {'id': ...}")
        return cls(
            prompts=prompts,
            max_new_tokens=int(obj.get("max_new_tokens", 128)),
            temperature=float(obj.get("temperature", 0.0)),
            stop=obj.get("stop"),
            repetition_penalty=float(obj.get("repetition_penalty", 1.0)),
            adapter_id=int(obj.get("adapter_id", -1)),
            prefix_id=obj.get("prefix_id"),
            deadline_s=deadline_s,
            tag=obj.get("tag"),
            session_id=session_id,
            adapter=adapter,
            handoff=handoff,
            handoff_id=handoff_id)

    def submit_kwargs(self) -> Dict[str, Any]:
        return {"max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature, "stop": self.stop,
                "repetition_penalty": self.repetition_penalty,
                "adapter_id": self.adapter_id, "prefix_id": self.prefix_id}


def program(prompt: Optional[List[int]] = None, *,
            prompts: Optional[List[List[int]]] = None,
            max_new_tokens: int = 128, temperature: float = 0.0,
            stop: Optional[List[List[int]]] = None,
            repetition_penalty: float = 1.0, adapter_id: int = -1,
            prefix_id: Optional[int] = None,
            session_id: Optional[str] = None,
            deadline_s: Optional[float] = None,
            tag: Optional[str] = None) -> Dict[str, Any]:
    """Client-side constructor of the ``generate`` wire dict::

        engine.generate(program(toks, session_id="user-42",
                                max_new_tokens=256))

    Validates eagerly (the same :class:`GenerationProgram` parse the
    engine runs), so a bad program fails at the call site."""
    obj: Dict[str, Any] = {"max_new_tokens": int(max_new_tokens),
                           "temperature": float(temperature),
                           "repetition_penalty": float(repetition_penalty),
                           "adapter_id": int(adapter_id)}
    if (prompt is None) == (prompts is None):
        raise ValueError("pass exactly one of prompt= or prompts=")
    if prompt is not None:
        obj["prompt"] = [int(t) for t in prompt]
    else:
        obj["prompts"] = [[int(t) for t in p] for p in prompts]
    if stop is not None:
        obj["stop"] = [[int(t) for t in s] for s in stop]
    if prefix_id is not None:
        obj["prefix_id"] = int(prefix_id)
    if session_id is not None:
        obj["session_id"] = session_id
    if deadline_s is not None:
        obj["deadline_s"] = float(deadline_s)
    if tag is not None:
        obj["tag"] = str(tag)
    GenerationProgram.from_wire(obj)
    return obj


class DecodeEngine:
    """Hosts a rolling engine and runs the generation loop server-side::

        eng = DecodeEngine(RollingGenerator(params, cfg, max_slots=64))
        for frame in eng.generate({"prompt": toks, "max_new_tokens": 256}):
            ...  # {"i": 0, "rid": r, "seq": k, "tokens": [...], "done": False}
        eng.close()

    The wrapped ``engine`` needs the :class:`RollingGenerator` driving
    surface: ``submit/admit/prefill_step/decode_step/evict`` plus the
    ``queued/free_rows/active_rows/prefilling_rows/pending`` counts.
    Prefix sharing also uses ``register_prefix/drop_prefix`` and the
    ``prefill_tokens`` counter; session park/restore uses
    ``export_row/import_row`` (an engine without them serves unshared and
    unparked).

    The driver thread runs until :meth:`close`, which fails any live
    stream and joins it.

    ``phase`` other than ``"mixed"`` (the JAX package's disaggregated
    tiers), ``adapter_pool`` and a speculative engine raise
    ``NotImplementedError`` naming the ``ROADMAP.md`` item that brings
    them.
    """

    def __init__(self, engine, poll_s: Optional[float] = None,
                 admit_rows: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 stall_s: Optional[float] = None,
                 kv_block_tokens: Optional[int] = None,
                 kv_budget_blocks: Optional[int] = None,
                 prefix_split: Optional[str] = None,
                 adapter_pool=None,
                 phase: Optional[str] = None):
        phase = (phase if phase is not None
                 else (env_str("KT_DISAGG_PHASE") or "mixed"))
        if phase not in _PHASES:
            raise ValueError(
                f"phase must be one of {sorted(_PHASES)}, "
                f"got {phase!r} (KT_DISAGG_PHASE)")
        if phase != "mixed":
            raise NotImplementedError(
                f"DecodeEngine(phase={phase!r}): the disaggregated "
                f"prefill/decode phases are not ported yet ({_PHASES_ITEM})")
        if adapter_pool is not None:
            raise NotImplementedError(
                f"DecodeEngine(adapter_pool=...): adapters are not ported "
                f"yet ({_ADAPTERS_ITEM})")
        if getattr(engine, "spec", False):
            raise NotImplementedError(
                f"a speculative rolling engine is not ported yet "
                f"({_SPEC_ITEM})")
        self.engine = engine
        self._phase = phase
        self._poll_s = (poll_s if poll_s is not None
                        else env_float("KT_ENGINE_POLL_S"))
        self._admit_rows = (admit_rows if admit_rows is not None
                            else env_int("KT_ENGINE_ADMIT_ROWS"))
        self._max_waiting = (max_waiting if max_waiting is not None
                             else env_int("KT_ENGINE_MAX_WAITING"))
        self._stall_s = (stall_s if stall_s is not None
                         else env_float("KT_ENGINE_STALL_S"))
        # Paged-KV manager: block ledger + prefix cache + session
        # offload. Budget default: 2x the decode grid in blocks (the grid
        # plus as much again for shared prefix blocks).
        bt = (kv_block_tokens if kv_block_tokens is not None
              else env_int("KT_KV_BLOCK_TOKENS"))
        budget = (kv_budget_blocks if kv_budget_blocks is not None
                  else env_int("KT_KV_HBM_BUDGET"))
        # a row's plane is bounded by the grid depth: admission prices
        # min(context + budget, max_len) blocks
        self._row_cap_tokens = int(getattr(engine, "max_len", 2048))
        if not budget:
            budget = 2 * (int(getattr(engine, "max_slots", 8))
                          * kvpool.blocks_for(self._row_cap_tokens, bt))
        self._kv = kvpool.PagedKVPool(budget, bt, prefix_split)
        # rid -> {"blocks", "session"}: the release side of the ledger
        # reservations made at submit
        self._rid_meta: Dict[int, Dict[str, Any]] = {}
        # single flight: a session owns at most one live row
        self._live_sessions: set = set()
        # per-session activity sequence, bumped whenever a program claims
        # the session; background offloads capture it at export and refuse
        # to publish a blob a newer program has superseded. Values come
        # from one global counter, so a recreated entry never lands on a
        # value an in-flight offload captured.
        self._session_seq: Dict[str, int] = {}
        self._seq_counter = 0
        # sessions that may have a blob in the store (LRU-bounded; absence
        # must mean "no blob", so evicting an entry drops its blob)
        self._parked_sessions: Dict[str, bool] = {}
        # serializes park publishes (explicit + background); always taken
        # outside _wake
        self._offload_lock = threading.Lock()
        # seconds per KV block freed, EMA: the block-admission clock
        self._ema_block_s = 0.01
        # prefix-sharing savings, both sides counted here
        self._prefill_naive = 0       # sum(len(full prompt)) submitted
        self._prefill_executed = 0    # suffixes + once-per-prefix fills
        self._wake = threading.Condition()
        # threads waiting to take _wake (see _locked and _drive)
        self._callers = 0
        self._callers_lock = threading.Lock()
        self._sinks: Dict[int, "_queue.SimpleQueue"] = {}
        self._deadlines: Dict[int, float] = {}
        self._submit_t: Dict[int, float] = {}   # rid -> submit stamp,
        #                                         popped at first token
        # rid -> trace id for the row's residency (flight records)
        self._row_trace: Dict[int, Optional[str]] = {}
        self._exec_counts: Dict[str, int] = {}
        # seconds per row freed, EMA: the admission estimate's clock
        self._ema_row_s = 0.05
        self._ema_ttft_s = 0.0
        self._last_free_t: Optional[float] = None
        self._steps = 0
        self._tokens = 0
        self._device_s = 0.0
        self._prefill_s = 0.0
        self._prefill_chunks = 0
        self._admitted = 0
        self._parks = 0
        self._restores = 0
        self._evictions = 0
        self._sheds = 0
        # MFU/MBU window state: (flops_total, bytes_total, dispatch wall)
        # at the last update; None until the engine has devstats and peaks
        self._util_prev = (0.0, 0.0, 0.0)
        self._mfu: Optional[float] = None
        self._mbu: Optional[float] = None
        # per-tick black box (None when KT_FLIGHT_DISABLE is set)
        self._flight = flight.get_recorder()
        self._stop = False
        # copy_context: driver-thread spans keep the ids of the context
        # that built the engine
        self._driver = threading.Thread(
            target=contextvars.copy_context().run, args=(self._drive,),
            name="kt-engine-driver", daemon=True)
        self._driver.start()

    # ------------------------------------------------------------ public
    def generate(self, program):
        """Run one generation program; a generator of token frames
        ``{"i": prompt-index, "rid": engine-rid, "seq": n, "tokens":
        [...], "done": bool}``. The stream ends when every prompt is done;
        a parked program (:meth:`park`) ends with one ``{"parked": True,
        "done": False}`` frame instead.

        Prefix sharing: with ``KT_KV_PREFIX_SPLIT`` active each prompt is
        split into (prefix, suffix); a cached prefix is reused and only the
        suffix prefills, a new one is registered once for every later
        program. Sessions: a program whose ``session_id`` has a parked
        state in the store restores it into a free row and resumes
        mid-generation; its ``prompt`` is then ignored."""
        prog = GenerationProgram.from_wire(program)
        if prog.handoff is not None or prog.handoff_id is not None:
            raise NotImplementedError(
                f"handoff programs belong to the disaggregated phases, not "
                f"ported yet ({_PHASES_ITEM})")
        if prog.adapter is not None:
            raise NotImplementedError(
                f"program names adapter {prog.adapter!r}: named adapters "
                f"are not ported yet ({_ADAPTERS_ITEM})")
        sink: "_queue.SimpleQueue" = _queue.SimpleQueue()
        trace_id = tracing.current_trace_id()
        restored = None
        if prog.session_id is not None:
            with self._locked():
                self._check_session_free_locked(prog.session_id)
            # store fetch outside the scheduler lock: a slow restore must
            # not stall the decode loop (re-checked under the lock before
            # the import). The session seq is bumped only when this
            # program takes a row.
            if hasattr(self.engine, "import_row"):
                restored = kvpool.restore_session(prog.session_id)
        with self._locked():
            deadline = (time.time() + prog.deadline_s
                        if prog.deadline_s is not None else None)
            rids: List[int] = []
            now = time.perf_counter()
            if restored is not None:
                rid = self._restore_locked(prog, restored)
                rids.append(rid)
                self._sinks[rid] = sink
                self._submit_t[rid] = now
                self._row_trace[rid] = trace_id
                if deadline is not None:
                    self._deadlines[rid] = deadline
                self._restores += 1
                # the blob is still in the store: completion must drop it
                self._note_parked_locked(prog.session_id)
            else:
                if prog.session_id is not None:
                    # re-check under this lock hold: a racing retry may
                    # have registered the session since the first check
                    self._check_session_free_locked(prog.session_id)
                plan = self._plan_locked(prog)
                self._shed_check_locked(prog, plan)
                # protect the whole plan's prefixes from make-room
                # eviction for the span of this submit loop
                protect = {item["entry"].pid for item in plan
                           if item["entry"] is not None}
                try:
                    for item in plan:
                        pid = prog.prefix_id
                        if item["prefix"]:
                            pid, registered = self._ensure_prefix_locked(
                                item["prefix"], prog.adapter_id,
                                item["key"], frozenset(protect))
                            if registered:
                                # this program's miss ran the prefix fill
                                self._prefill_executed += len(
                                    item["prefix"])
                        if pid is not None:
                            protect.add(pid)
                        suffix = (item["suffix"] if pid is not None
                                  or not item["prefix"]
                                  else item["prefix"] + item["suffix"])
                        kwargs = dict(prog.submit_kwargs())
                        kwargs["prefix_id"] = pid
                        row_tokens = min(
                            len(suffix) + prog.max_new_tokens,
                            self._row_cap_tokens)
                        # an unshared fallback (pid None on a planned
                        # prefix) costs more than the shed check priced:
                        # enforce the budget here
                        if not self._make_room_locked(
                                self._kv.row_cost(row_tokens),
                                protect=frozenset(protect)):
                            max_delay = env_float("KT_MAX_QUEUE_DELAY_S")
                            raise ServerOverloaded(
                                f"KV budget exhausted mid-admission "
                                f"({self._kv.row_cost(row_tokens)} "
                                f"blocks needed, "
                                f"{self._kv.free_blocks} free)",
                                retry_after=retry_after_estimate(
                                    self._kv.row_cost(row_tokens), 1,
                                    self._ema_block_s, cap_s=max_delay))
                        rid = self.engine.submit(suffix, **kwargs)
                        rids.append(rid)
                        self._sinks[rid] = sink
                        self._submit_t[rid] = now
                        self._row_trace[rid] = trace_id
                        if deadline is not None:
                            self._deadlines[rid] = deadline
                        blocks = self._kv.reserve_row(
                            rid, row_tokens, prefix_pid=pid)
                        self._rid_meta[rid] = {"blocks": blocks,
                                               "session": prog.session_id}
                        if prog.session_id is not None:
                            self._live_sessions.add(prog.session_id)
                            self._bump_session_seq_locked(
                                prog.session_id)
                        self._prefill_naive += (len(item["prefix"])
                                                + len(item["suffix"]))
                        self._prefill_executed += len(suffix)
                except BaseException:
                    # a later prompt failed validation: release the
                    # earlier prompts' rows now
                    for rid in rids:
                        self.engine.evict(rid)
                        self._release_locked(rid)
                    raise
            if prog.tag:
                # bounded: one entry per tag would leak on a long-lived
                # engine tagging every request
                if (prog.tag not in self._exec_counts
                        and len(self._exec_counts) >= 4096):
                    self._exec_counts.pop(next(iter(self._exec_counts)))
                self._exec_counts[prog.tag] = (
                    self._exec_counts.get(prog.tag, 0) + 1)
            index_of = {rid: i for i, rid in enumerate(rids)}
            self._wake.notify_all()
        live = set(rids)
        seq = 0
        try:
            while live:
                try:
                    item = sink.get(timeout=self._stall_s)
                except _queue.Empty:
                    raise TimeoutError(
                        f"engine produced no frame in {self._stall_s}s "
                        f"(KT_ENGINE_STALL_S) — driver stalled?") from None
                rid, payload = item
                if isinstance(payload, BaseException):
                    live.discard(rid)
                    raise payload
                if payload is None:
                    # the row was parked: its state is durable in the
                    # store and a later same-session program resumes it
                    live.discard(rid)
                    frame = {"i": index_of[rid], "rid": rid, "seq": seq,
                             "tokens": [], "done": False, "parked": True,
                             "session_id": prog.session_id}
                    seq += 1
                    yield frame
                    continue
                toks, done = payload
                if done:
                    live.discard(rid)
                frame = {"i": index_of[rid], "rid": rid, "seq": seq,
                         "tokens": toks, "done": bool(done)}
                seq += 1
                yield frame
        finally:
            # any early exit (stall, deadline raise, the caller closing the
            # generator) must release the rows, or an abandoned program
            # keeps decoding to its token budget
            if live:
                with self._locked():
                    for rid in live:
                        self.engine.evict(rid)
                        self._release_locked(rid)
                        self._evictions += 1

    def register_prefix(self, tokens, adapter_id: int = -1) -> int:
        """Explicit prefix registration, accounted against the KV budget
        (cold prefixes make way for it, and it is LRU-evictable like an
        automatic one). Re-registering the same tokens returns the cached
        id."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("prefix needs >= 1 token")
        if not hasattr(self.engine, "register_prefix"):
            raise ValueError(
                f"{type(self.engine).__name__} does not support "
                f"prefix registration")
        with self._locked():
            key = kvpool.prefix_key(tokens, int(adapter_id))
            need = self._kv.row_cost(len(tokens))
            if self._kv.ledger.budget and need > self._kv.ledger.budget:
                raise ValueError(
                    f"a {len(tokens)}-token prefix needs {need} KV "
                    f"blocks — more than the whole "
                    f"{self._kv.ledger.budget}-block budget "
                    f"(KT_KV_HBM_BUDGET); not retryable")
            pid, _registered = self._ensure_prefix_locked(
                tokens, int(adapter_id), key)
            if pid is None:
                max_delay = env_float("KT_MAX_QUEUE_DELAY_S")
                raise ServerOverloaded(
                    f"no KV-block headroom to register a "
                    f"{len(tokens)}-token prefix "
                    f"(KT_KV_HBM_BUDGET={self._kv.ledger.budget})",
                    retry_after=retry_after_estimate(
                        need, 1, self._ema_block_s, cap_s=max_delay))
            return pid

    def drop_prefix(self, prefix_id: int) -> bool:
        """Release a registered prefix (ledger and device)."""
        with self._locked():
            self._kv.prefixes.remove(int(prefix_id))
            return bool(getattr(self.engine, "drop_prefix",
                                lambda _pid: False)(int(prefix_id)))

    def pending(self) -> int:
        """Engine-wide pending count (host bookkeeping, no device sync)."""
        return int(self.engine.pending)

    def stats(self) -> Dict[str, Any]:
        """Scheduler snapshot (host-only): the engine's counters."""
        eng = self.engine
        executed = self._prefill_executed
        out = {
            "queued": int(eng.queued),
            "free_rows": int(eng.free_rows),
            "active_rows": int(eng.active_rows),
            "prefilling_rows": int(eng.prefilling_rows),
            "pending": int(eng.pending),
            "steps": self._steps,
            "tokens": self._tokens,
            "device_s": round(self._device_s, 6),
            "prefill_chunks": self._prefill_chunks,
            "admitted_rows": self._admitted,
            "evictions": self._evictions,
            "sheds": self._sheds,
            "ema_row_free_s": round(self._ema_row_s, 4),
            "ema_ttft_s": round(self._ema_ttft_s, 4),
            "ema_block_free_s": round(self._ema_block_s, 5),
            "prefill_tokens_executed": executed,
            "prefill_tokens_naive": self._prefill_naive,
            "prefill_tokens_saved_ratio": round(
                1.0 - executed / self._prefill_naive, 4)
            if self._prefill_naive else 0.0,
            "parks": self._parks,
            "restores": self._restores,
            "phase": self._phase,
            "row_eta_s": round(self._row_eta_locked(), 4),
            **self._kv.stats(),
            "kv_offloads": self._parks,
            "kv_restores": self._restores,
        }
        if self._mfu is not None:
            out["mfu"] = round(self._mfu, 4)
            out["mbu"] = round(self._mbu, 4)
        if self._flight is not None:
            out["flight_seq"] = self._flight.seq
        snap_fn = getattr(eng, "devstats_snapshot", None)
        if snap_fn is not None:
            snap = snap_fn()
            out["devstats_flops_total"] = snap["flops_total"]
            out["devstats_bytes_total"] = snap["bytes_total"]
            out["devstats_dispatches"] = int(snap["dispatches_total"])
        hbm = devstats.hbm_stats(getattr(eng, "device", None))
        if hbm is not None:
            out.update(hbm)
        return out

    def exec_count(self, tag: str) -> int:
        """How many times a tagged program was executed."""
        return self._exec_counts.get(tag, 0)

    def warmup(self, *args, **kwargs) -> bool:
        warm = getattr(self.engine, "warmup", None)
        if warm is None:
            return False
        with self._locked():
            warm(*args, **kwargs)
        return True

    def close(self) -> None:
        """Stop the driver: fail every live stream now (a dangling sink
        would block its generate() for KT_ENGINE_STALL_S) and join the
        thread."""
        with self._locked():
            self._stop = True
            for rid, sink in list(self._sinks.items()):
                sink.put((rid, RuntimeError(
                    "engine closed with the generation live")))
                self._release_locked(rid)
            self._wake.notify_all()
        self._driver.join(timeout=30.0)

    def park(self, session_id: str) -> int:
        """Park a live session now: export its row's KV and sampler state,
        publish it to the store synchronously (when this returns the state
        is durable), evict the row, and end the program's stream with a
        ``parked`` frame. A later ``generate`` with the same
        ``session_id`` resumes mid-generation without a new prefill.
        Returns rows parked (0 when the session has no exportable row:
        unknown id, or still queued or mid-prefill)."""
        kvpool.check_session_id(session_id)
        if not hasattr(self.engine, "export_row"):
            return 0
        quantized = bool(getattr(self.engine, "kv_quantized", False))
        exported: List[tuple] = []              # (rid, sink, state)
        with self._locked():
            seq0 = self._session_seq.get(session_id, 0)
            rids = [rid for rid, meta in list(self._rid_meta.items())
                    if meta.get("session") == session_id]
            for rid in rids:
                try:
                    state = self.engine.export_row(
                        rid, block_tokens=self._kv.block_tokens)
                except (KeyError, ValueError):
                    continue          # queued / mid-prefill
                self.engine.evict(rid)
                sink = self._sinks.get(rid)
                self._release_locked(rid)
                exported.append((rid, sink, state))
        parked = 0
        for rid, sink, state in exported:       # store I/O off the lock
            # check+publish atomic w.r.t. any other session publish
            with self._offload_lock:
                with self._locked():
                    superseded = self._session_seq.get(
                        session_id, seq0) != seq0
                if superseded:
                    # a newer program claimed the session between the
                    # export and this publish: landing our blob now would
                    # shadow it
                    if sink is not None:
                        sink.put((rid, RuntimeError(
                            f"park of session {session_id} superseded "
                            f"by a newer program before its state was "
                            f"published")))
                    continue
                try:
                    kvpool.offload_session(session_id, state, quantized)
                except BaseException as exc:
                    # the row is gone but the state never landed: the
                    # client must not be told it can resume
                    if sink is not None:
                        sink.put((rid, RuntimeError(
                            f"park of session {session_id} failed to "
                            f"publish: {exc}")))
                    raise
                with self._locked():
                    landed_superseded = self._session_seq.get(
                        session_id, seq0) != seq0
                    if not landed_superseded:
                        self._parks += 1
                        self._note_parked_locked(session_id)
                if landed_superseded:
                    kvpool.drop_session(session_id)
                    if sink is not None:
                        sink.put((rid, RuntimeError(
                            f"park of session {session_id} superseded "
                            f"by a newer program while publishing")))
                    continue
            parked += 1
            if sink is not None:
                # the sentinel only after the blob is durable
                sink.put((rid, None))
        return parked

    # ------------------------------------------------------------ driver
    @contextlib.contextmanager
    def _locked(self):
        """Take the scheduler lock as a caller: counted while waiting, so
        the driver lets it in between ticks."""
        with self._callers_lock:
            self._callers += 1
        try:
            self._wake.acquire()
        finally:
            with self._callers_lock:
                self._callers -= 1
        try:
            yield
        finally:
            self._wake.release()

    def _forget_locked(self, rid: int) -> None:
        self._sinks.pop(rid, None)
        self._deadlines.pop(rid, None)
        self._submit_t.pop(rid, None)
        self._row_trace.pop(rid, None)

    def _check_session_free_locked(self, session_id: str) -> None:
        if session_id in self._live_sessions:
            raise ValueError(
                f"session {session_id} already has a live generation on "
                f"this engine — one row per session (a racing retry must "
                f"not decode the same session twice)")

    def _note_parked_locked(self, session_id: str) -> None:
        """Track a session as having a store blob (bounded LRU; an entry
        evicted to keep the bound takes its blob with it)."""
        self._parked_sessions.pop(session_id, None)
        if len(self._parked_sessions) >= 8192:
            victim = next(iter(self._parked_sessions))
            del self._parked_sessions[victim]
            self._drop_session_async(victim)
        self._parked_sessions[session_id] = True

    def _bump_session_seq_locked(self, session_id: str) -> None:
        """Advance the session's activity sequence (supersedes any
        in-flight background offload); bounded LRU."""
        self._session_seq.pop(session_id, None)
        if len(self._session_seq) >= 4096:
            self._session_seq.pop(next(iter(self._session_seq)))
        self._seq_counter += 1
        self._session_seq[session_id] = self._seq_counter

    def _release_locked(self, rid: int) -> None:
        """Forget a rid and release its KV-pool holdings (ledger blocks,
        prefix refcount, session slot): every path that frees a row comes
        through here."""
        self._forget_locked(rid)
        meta = self._rid_meta.pop(rid, None)
        if meta and meta.get("session"):
            self._live_sessions.discard(meta["session"])
        self._kv.release_row(rid)

    def _plan_locked(self, prog: GenerationProgram) -> List[Dict[str, Any]]:
        """Split each prompt by the pool's prefix rule and annotate it with
        the cache state; the shed check prices the program from this."""
        rule = self._kv.split
        auto = (rule is not None and prog.prefix_id is None
                and hasattr(self.engine, "register_prefix"))
        plan: List[Dict[str, Any]] = []
        for p in prog.prompts:
            prefix, suffix = (kvpool.split_prompt(p, rule) if auto
                              else ([], list(p)))
            key = (kvpool.prefix_key(prefix, prog.adapter_id)
                   if prefix else None)
            # peek: planning must not count a hit or touch the LRU order
            entry = self._kv.prefixes.peek(key) if key else None
            plan.append({"prefix": prefix, "suffix": suffix,
                         "key": key, "entry": entry})
        return plan

    def _make_room_locked(self, blocks: int,
                          protect: frozenset = frozenset()) -> bool:
        """LRU-evict cold (refcount-0) prefixes until ``blocks`` fit the
        budget, freeing their device K/V (never the pids in
        ``protect``). → whether the room exists now. Blocks beyond the
        whole budget evict nothing."""
        if (self._kv.ledger.budget
                and blocks > self._kv.ledger.budget):
            return False
        for victim in self._kv.prefixes.evict_for(blocks, protect):
            try:
                self.engine.drop_prefix(victim.pid)
            # ktlint: disable=KT004 -- ledger already dropped it; a failed device free must not block admission
            except Exception:  # noqa: BLE001
                pass
        return (not self._kv.ledger.budget
                or self._kv.free_blocks >= blocks)

    def _ensure_prefix_locked(self, prefix: List[int], adapter_id: int,
                              key: str,
                              protect: frozenset = frozenset()) -> tuple:
        """Hit → ``(pid, False)``. Miss → make room, prefill the prefix
        once (``engine.prefix_fill`` span), register it → ``(pid,
        True)``. ``(None, False)`` when the budget cannot fit it: the
        caller serves the prompt unshared."""
        entry = self._kv.prefixes.lookup(key)
        if entry is not None:
            return entry.pid, False
        need = kvpool.blocks_for(len(prefix), self._kv.block_tokens)
        if not self._make_room_locked(need, protect):
            return None, False
        t0 = time.perf_counter()
        pid = self.engine.register_prefix(prefix, adapter_id=adapter_id)
        tracing.record_span(
            "engine.prefix_fill", time.perf_counter() - t0,
            attrs={"tokens": len(prefix), "adapter_id": adapter_id})
        self._kv.prefixes.insert(key, pid, len(prefix), adapter_id)
        return pid, True

    def _restore_locked(self, prog: GenerationProgram,
                        state: Dict[str, Any]) -> int:
        """Splice a parked session's fetched state into a free row. No free
        row or no block headroom → ``ServerOverloaded`` (the blob stays;
        the client retries): a restore never evicts a live row."""
        what = f"session {prog.session_id}"
        ctx, emitted, max_new = kvpool.state_summary(state)
        need = self._kv.row_cost(min(ctx + (max_new - emitted),
                                     self._row_cap_tokens))
        if self._kv.ledger.budget and need > self._kv.ledger.budget:
            raise ValueError(
                f"restored {what} needs {need} KV "
                f"blocks — more than the whole {self._kv.ledger.budget}-"
                f"block budget (KT_KV_HBM_BUDGET)")
        max_delay = env_float("KT_MAX_QUEUE_DELAY_S")
        if (self.engine.free_rows < 1
                or not self._make_room_locked(need)):
            retry_after = retry_after_estimate(
                max(1, need), 1,
                max(self._ema_block_s, self._ema_row_s),
                cap_s=max_delay)
            self._sheds += 1
            raise ServerOverloaded(
                f"no free row/blocks to restore "
                f"{what} into ({need} blocks needed)",
                retry_after=retry_after)
        self._check_session_free_locked(prog.session_id)
        # block_tokens travels so the engine's geometry guard refuses a
        # block-size mismatch
        rid = self.engine.import_row(
            state, block_tokens=self._kv.block_tokens)
        blocks = self._kv.reserve_row(
            rid, min(ctx + (max_new - emitted), self._row_cap_tokens))
        self._rid_meta[rid] = {"blocks": blocks,
                               "session": prog.session_id}
        self._live_sessions.add(prog.session_id)
        self._bump_session_seq_locked(prog.session_id)
        return rid

    def _shed_check_locked(self, prog: GenerationProgram,
                           plan: List[Dict[str, Any]]) -> None:
        """Admission control in KV blocks, with the row-free estimate and
        the queue-length backstop: every program is priced at its
        worst-case block footprint (suffix + token budget, plus its prefix
        when not cached) against the free blocks (cold prefixes count as
        reclaimable). Over budget → typed shed with a Retry-After from the
        block-free EMA. A prefix-hit program costs only its suffix."""
        eng = self.engine
        waiting = int(eng.queued)
        n_new = len(plan)
        max_delay = env_float("KT_MAX_QUEUE_DELAY_S")
        hard_cap = self._max_waiting and (
            waiting + n_new > self._max_waiting)
        # the row-free estimate: binding when rows, not memory, are scarce
        est_delay = 0.0
        if eng.free_rows < n_new:
            est_delay = (waiting + n_new) * max(0.01, self._ema_row_s)
        need = 0
        new_pfx: Dict[str, int] = {}
        for item in plan:
            need += self._kv.row_cost(min(
                len(item["suffix"]) + prog.max_new_tokens,
                self._row_cap_tokens))
            if item["prefix"] and item["entry"] is None:
                new_pfx[item["key"]] = kvpool.blocks_for(
                    len(item["prefix"]), self._kv.block_tokens)
        need += sum(new_pfx.values())
        short = 0
        if self._kv.ledger.budget:
            if need > self._kv.ledger.budget:
                # structural: the program can never fit
                raise ValueError(
                    f"program needs {need} KV blocks — more than the "
                    f"whole {self._kv.ledger.budget}-block budget "
                    f"(KT_KV_HBM_BUDGET); shrink the prompt/token "
                    f"budget or raise the budget")
            # refcount-0 prefixes are reclaimable, except the ones this
            # very program is about to decode under
            hit_pids = {item["entry"].pid for item in plan
                        if item["entry"] is not None}
            cold = sum(e.blocks
                       for e in self._kv.prefixes._entries.values()
                       if e.refs == 0 and e.pid not in hit_pids)
            short = max(0, need - (self._kv.free_blocks + cold))
        if hard_cap or est_delay > max_delay or short:
            ema = self._ema_block_s if short else self._ema_row_s
            retry_after = retry_after_estimate(
                max(short, waiting + n_new), 1, ema, cap_s=max_delay)
            self._sheds += 1
            tracing.record_span(
                "server.shed", 0.0,
                attrs={"transport": "engine", "queue_depth": waiting,
                       "kv_blocks_short": short,
                       "retry_after_s": retry_after})
            if short:
                raise ServerOverloaded(
                    f"KV budget exhausted: program needs {need} blocks, "
                    f"{short} short of the {self._kv.ledger.budget}-block "
                    f"budget (KT_KV_HBM_BUDGET)",
                    retry_after=retry_after)
            raise ServerOverloaded(
                f"engine queue {waiting} deep, no row expected free "
                f"within {max_delay}s (est. {est_delay:.2f}s)",
                retry_after=retry_after)

    def _drive(self) -> None:
        while True:
            # hand the lock to callers waiting for it (park, generate)
            # between ticks: a lock the driver re-takes at once starves
            # them for as long as rows are live (bounded: 50 ms)
            for _ in range(100):
                if not self._callers:
                    break
                time.sleep(0.0005)
            with self._wake:
                while not self._stop and not self.engine.pending:
                    self._wake.wait(timeout=self._poll_s)
                if self._stop:
                    return
                try:
                    self._tick_locked()
                # ktlint: disable=KT004 -- reported per sink; the loop must survive one bad tick
                except Exception as exc:  # noqa: BLE001
                    # a broken device step poisons every live program:
                    # fail their streams before any engine cleanup (evict
                    # touches the same, possibly broken, device state)
                    for rid, sink in list(self._sinks.items()):
                        sink.put((rid, exc))
                    for rid in list(self._sinks):
                        try:
                            self.engine.evict(rid)
                        # ktlint: disable=KT004 -- device already faulted; the stream was failed above
                        except Exception:  # noqa: BLE001
                            pass
                        self._release_locked(rid)

    def _tick_locked(self) -> None:
        eng = self.engine
        tick_t0 = time.perf_counter()
        # flight-record baseline: per-tick deltas of the counters
        fl_prev = (self._admitted, self._prefill_chunks, self._evictions,
                   self._parks, self._sheds,
                   getattr(eng, "prefill_tokens", 0))
        now = time.time()
        # ---- deadline eviction (row-granular) ------------------------
        for rid, dl in list(self._deadlines.items()):
            if now > dl:
                meta = self._rid_meta.get(rid) or {}
                session = meta.get("session")
                state = None
                if session is not None and hasattr(eng, "export_row"):
                    # a deadlined session row parks instead of burning:
                    # export now, offload in the background, and still
                    # fail the stream typed
                    try:
                        state = eng.export_row(
                            rid, block_tokens=self._kv.block_tokens)
                    except (KeyError, ValueError):
                        state = None
                eng.evict(rid)
                sink = self._sinks.get(rid)
                self._release_locked(rid)
                self._evictions += 1
                if state is not None:
                    self._offload_async(session, state)
                if sink is not None:
                    # "parking", not "parked": the offload runs in the
                    # background (park() is the durable path)
                    sink.put((rid, DeadlineExceeded(
                        f"generation {rid} passed its deadline "
                        f"mid-stream"
                        + (f" (session {session} parking in background)"
                           if state is not None else ""),
                        deadline=dl)))
        # ---- per-row admission into the live batch -------------------
        t0 = time.perf_counter()
        admitted = eng.admit(self._admit_rows or None)
        if admitted:
            self._admitted += admitted
            tracing.record_span("engine.admit", time.perf_counter() - t0,
                                attrs={"rows": admitted})
        # ---- one chunked-prefill dispatch, interleaved ---------------
        t0 = time.perf_counter()
        prefill_dt = 0.0
        if eng.prefilling_rows:
            eng.prefill_step()
            prefill_dt = time.perf_counter() - t0
            self._prefill_s += prefill_dt
            self._prefill_chunks += 1
            tracing.record_span("engine.prefill", prefill_dt,
                                attrs={"rows": eng.prefilling_rows})
        # ---- one decode chunk ----------------------------------------
        t0 = time.perf_counter()
        events = eng.decode_step()
        dt = time.perf_counter() - t0
        if events:
            self._steps += 1
            self._device_s += dt
            tracing.record_span(
                "engine.step", dt,
                attrs={"rows": len(events),
                       "tokens": sum(len(t) for _, t, _ in events)})
        # ---- route frames + row-free accounting ----------------------
        freed = 0
        blocks_freed = 0
        tnow = time.perf_counter()
        for rid, toks, done in events:
            self._tokens += len(toks)
            if toks:
                t_sub = self._submit_t.pop(rid, None)
                if t_sub is not None:  # this rid's first tokens
                    self._ema_ttft_s = (0.8 * self._ema_ttft_s
                                        + 0.2 * (tnow - t_sub))
            sink = self._sinks.get(rid)
            if sink is not None:
                sink.put((rid, ([int(t) for t in toks], bool(done))))
            if done:
                freed += 1
                meta = self._rid_meta.get(rid) or {}
                blocks_freed += meta.get("blocks", 0)
                if (meta.get("session")
                        and meta["session"] in self._parked_sessions):
                    # the session ran to completion: its parked blob is
                    # stale and would shadow the session's next program
                    self._parked_sessions.pop(meta["session"], None)
                    self._drop_session_async(meta["session"])
                self._release_locked(rid)
        if freed:
            t_free = time.time()
            if self._last_free_t is not None:
                gap = max(1e-4, (t_free - self._last_free_t) / freed)
                self._ema_row_s = 0.8 * self._ema_row_s + 0.2 * gap
                if blocks_freed:
                    bgap = max(1e-5, (t_free - self._last_free_t)
                               / blocks_freed)
                    self._ema_block_s = (0.8 * self._ema_block_s
                                         + 0.2 * bgap)
            self._last_free_t = t_free
        if not eng.pending:
            # going idle: the next free event's gap would include the
            # whole idle stretch and poison the row-free EMA
            self._last_free_t = None
        self._update_utilization()
        self._flight_append_locked(
            tick_t0, fl_prev, prefill_dt + (dt if events else 0.0),
            sum(len(t) for _, t, _ in events))

    def _flight_append_locked(self, tick_t0: float, prev: tuple,
                              device_dt: float,
                              decode_tokens: int) -> None:
        """One flight record for the tick that just ran."""
        fl = self._flight
        if fl is None:
            return
        try:
            eng = self.engine
            a0, p0, e0, k0, s0, pt0 = prev
            tick_s = time.perf_counter() - tick_t0
            trace_ids = tuple(sorted(
                {t for t in self._row_trace.values() if t}))[:8]
            fl.append(
                time.time(), time.monotonic(), tick_s, device_dt,
                max(0.0, tick_s - device_dt),
                self._admitted - a0, self._prefill_chunks - p0,
                getattr(eng, "prefill_tokens", 0) - pt0, decode_tokens,
                0, 0,                      # no speculation in the port
                self._evictions - e0, self._parks - k0,
                0,                         # no handoffs in the port
                self._sheds - s0, int(eng.queued), int(eng.active_rows),
                (float(self._kv.free_blocks) if self._kv.ledger.budget
                 else None),
                self._mfu, self._mbu, trace_ids)
        # ktlint: disable=KT004 -- the black box must never fail the tick it records
        except Exception:  # noqa: BLE001
            pass

    def _offload_async(self, session_id: str,
                       state: Dict[str, Any]) -> None:
        """Background session offload (deadline parks): the driver tick
        must not block on store I/O. Guarded by the session sequence: a
        blob a newer program has superseded is refused, or dropped right
        after it lands."""
        quantized = bool(getattr(self.engine, "kv_quantized", False))
        seq0 = self._session_seq.get(session_id, 0)

        def _superseded() -> bool:
            # absent is not superseded: the bounded dict may have evicted
            # an idle session's entry, and refusing then would lose the
            # only copy of the state
            with self._locked():
                return self._session_seq.get(session_id, seq0) != seq0

        def _push():
            try:
                with self._offload_lock:
                    if _superseded():
                        tracing.record_span(
                            "kv.park_superseded", 0.0,
                            attrs={"session": session_id})
                        return
                    kvpool.offload_session(session_id, state, quantized)
                    if _superseded():
                        kvpool.drop_session(session_id)
                        tracing.record_span(
                            "kv.park_superseded", 0.0,
                            attrs={"session": session_id,
                                   "at": "landed"})
                        return
                    with self._locked():
                        self._parks += 1
                        self._note_parked_locked(session_id)
            # ktlint: disable=KT004 -- a failed park only costs the session its resume
            except Exception:  # noqa: BLE001
                tracing.record_span("kv.park_failed", 0.0,
                                    attrs={"session": session_id})

        threading.Thread(
            target=contextvars.copy_context().run, args=(_push,),
            name="kt-kv-offload", daemon=True).start()

    def _drop_session_async(self, session_id: str) -> None:
        """Invalidate a completed session's parked blob (store I/O off the
        driver tick; best effort)."""

        def _drop():
            try:
                kvpool.drop_session(session_id)
            # ktlint: disable=KT004 -- best-effort invalidation
            except Exception:  # noqa: BLE001
                pass

        threading.Thread(
            target=contextvars.copy_context().run, args=(_drop,),
            name="kt-kv-drop", daemon=True).start()

    def _row_eta_locked(self) -> float:
        """Earliest expected row-free time: 0 with a free row, else queue
        depth against the row-free EMA."""
        eng = self.engine
        if eng.free_rows > 0:
            return 0.0
        return (int(eng.queued) + 1) * max(0.01, self._ema_row_s)

    def _update_utilization(self) -> None:
        """Window MFU/MBU off the engine's devstats surface; stays None
        without one or without known peaks."""
        eng = self.engine
        snap_fn = getattr(eng, "devstats_snapshot", None)
        peaks_fn = getattr(eng, "devstats_peaks", None)
        if snap_fn is None or peaks_fn is None:
            return
        snap = snap_fn()
        wall = self._device_s + self._prefill_s
        f0, b0, w0 = self._util_prev
        util = devstats.utilization(
            snap["flops_total"] - f0, snap["bytes_total"] - b0,
            wall - w0, peaks_fn())
        if util is not None:
            self._mfu, self._mbu = util
            self._util_prev = (snap["flops_total"], snap["bytes_total"],
                               wall)


class SimRollingEngine:
    """Host-only twin of :class:`RollingGenerator`'s driving surface.

    Token emission is a pure function of (prompt, index), see
    :meth:`expected_tokens`, so streams are assertable without a model;
    ``step_s`` models a decode chunk's device time (one sleep per chunk
    whatever the occupancy). The scheduler cannot tell it from the real
    engine. Its speculation and adapter-slot surfaces (``spec_k``,
    ``adapter_slots``) wait for items 3 and 4.
    """

    kv_quantized = False

    def __init__(self, max_slots: int = 8, steps_per_call: int = 8,
                 prefill_chunk: Optional[int] = None,
                 step_s: float = 0.0, prefill_s: Optional[float] = None,
                 max_len: int = 2048, spec_k: int = 0,
                 adapter_slots: int = 0):
        if spec_k:
            raise NotImplementedError(
                f"SimRollingEngine(spec_k=...): speculation is not ported "
                f"yet ({_SPEC_ITEM})")
        if adapter_slots:
            raise NotImplementedError(
                f"SimRollingEngine(adapter_slots=...): adapters are not "
                f"ported yet ({_ADAPTERS_ITEM})")
        self.max_slots = max_slots
        self.max_len = max_len
        self.steps_per_call = steps_per_call
        self.prefill_chunk = prefill_chunk
        self.step_s = step_s
        self.prefill_s = prefill_s if prefill_s is not None else step_s
        self._queue: List[dict] = []
        self._rows: Dict[int, dict] = {}        # rid -> active request
        self._prefilling: Dict[int, dict] = {}  # rid -> request
        self._free = list(range(max_slots))
        self._next_rid = 0
        # pid -> tokens; emission stays a pure function of (prefix +
        # suffix, index), so shared-prefix streams are assertable too
        self._prefixes: Dict[int, dict] = {}
        self._next_prefix_id = 0
        # prompt tokens run through a "prefill" (suffix only for prefixed
        # submits; a registered prefix counts once)
        self.prefill_tokens = 0
        # nominal costs and "chip" peaks, so the utilization plane runs on
        # the host (a ~1B-param bf16 model on a nominal chip)
        self.sim_flops_per_token = 2.0e9
        self.sim_bytes_per_dispatch = 2.0e9
        self.peak_flops = 100e12
        self.peak_bw = 1.0e12
        self._devstats = devstats.AnalyticCosts()

    # -------------------------------------------------------- interface
    @staticmethod
    def expected_tokens(prompt: List[int], n: int) -> List[int]:
        """The exact token stream a request with this prompt emits
        (``prompt`` includes any shared prefix)."""
        seed = ",".join(str(int(t)) for t in prompt)
        return [int.from_bytes(
            hashlib.sha256(f"{seed}:{i}".encode()).digest()[:4],
            "little") % 32000 for i in range(n)]

    def register_prefix(self, tokens, adapter_id: int = -1) -> int:
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = {"tokens": [int(t) for t in tokens],
                               "adapter_id": int(adapter_id)}
        self.prefill_tokens += len(tokens)
        return pid

    def drop_prefix(self, prefix_id: int) -> bool:
        return self._prefixes.pop(prefix_id, None) is not None

    def prefix_len(self, prefix_id: int) -> int:
        return len(self._prefixes[prefix_id]["tokens"])

    def submit(self, prompt, max_new_tokens: int = 128,
               prefix_id: Optional[int] = None, adapter_id: int = -1,
               **_ignored) -> int:
        head: List[int] = []
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix_id {prefix_id}")
            entry = self._prefixes[prefix_id]
            if entry["adapter_id"] != int(adapter_id):
                raise ValueError(
                    f"prefix {prefix_id} was registered with adapter "
                    f"{entry['adapter_id']}; submit passed {adapter_id}")
            if not prompt:
                raise ValueError("prefixed submit needs >= 1 suffix token")
            head = entry["tokens"]
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append({"rid": rid,
                            "prompt": head + [int(t) for t in prompt],
                            "n": int(max_new_tokens), "emitted": 0,
                            "consumed": 0, "head": len(head),
                            "suffix": len(prompt), "slot": None})
        return rid

    def admit(self, max_rows: Optional[int] = None) -> int:
        admitted = 0
        while self._free and self._queue and (
                max_rows is None or admitted < max_rows):
            req = self._queue.pop(0)
            req["slot"] = self._free.pop(0)
            admitted += 1
            self.prefill_tokens += req.get("suffix", len(req["prompt"]))
            # a prefixed row's head is already "computed"
            req["consumed"] = req.get("head", 0)
            if (self.prefill_chunk is not None
                    and len(req["prompt"]) - req["consumed"]
                    > self.prefill_chunk):
                self._prefilling[req["rid"]] = req
            else:
                req["consumed"] = len(req["prompt"])
                self._rows[req["rid"]] = req
        return admitted

    def prefill_step(self) -> List[int]:
        if not self._prefilling:
            return []
        if self.prefill_s:
            time.sleep(self.prefill_s)
        activated = []
        chunk_toks = 0
        for rid, req in list(self._prefilling.items()):
            before = req["consumed"]
            req["consumed"] = min(len(req["prompt"]),
                                  req["consumed"] + self.prefill_chunk)
            chunk_toks += req["consumed"] - before
            if req["consumed"] >= len(req["prompt"]):
                del self._prefilling[rid]
                self._rows[rid] = req
                activated.append(rid)
        self._devstats.count(chunk_toks * self.sim_flops_per_token,
                             self.sim_bytes_per_dispatch)
        return activated

    def decode_step(self):
        if not self._rows:
            return []
        if self.step_s:
            time.sleep(self.step_s)
        events = []
        for rid, req in list(self._rows.items()):
            n_new = min(self.steps_per_call, req["n"] - req["emitted"])
            toks = self.expected_tokens(
                req["prompt"], req["emitted"] + n_new)[req["emitted"]:]
            req["emitted"] += n_new
            done = req["emitted"] >= req["n"]
            events.append((rid, toks, done))
            if done:
                self._free.append(req["slot"])
                del self._rows[rid]
        self._devstats.count(
            sum(len(t) for _, t, _ in events) * self.sim_flops_per_token,
            self.sim_bytes_per_dispatch)
        return events

    def devstats_snapshot(self) -> Dict[str, float]:
        return self._devstats.snapshot()

    def devstats_peaks(self) -> Tuple[float, float]:
        return (self.peak_flops, self.peak_bw)

    def step(self):
        self.admit()
        self.prefill_step()
        return self.decode_step()

    def export_row(self, rid: int, block_tokens: int = 16) -> dict:
        """Host twin of ``RollingGenerator.export_row``: the same tree
        shape (per-block ``kv`` leaves + the ``scalars`` header ``[ctx,
        emitted, max_new]``), with block content a pure function of
        (prompt, block index), byte-stable across re-parks."""
        import numpy as np

        req = self._rows.get(rid)
        if req is None:
            raise KeyError(f"rid {rid} is not decode-active")
        bt = max(1, int(block_tokens))
        ctx = len(req["prompt"]) + req["emitted"]
        nblocks = kvpool.padded_blocks(ctx, bt, self.max_len)
        seed = ",".join(str(t) for t in req["prompt"])
        kv = {f"{b:05d}": np.frombuffer(
            hashlib.sha256(f"kv:{seed}:{b}".encode()).digest(),
            np.uint8).reshape(4, 8).copy() for b in range(nblocks)}
        return {
            "kv": {"k": kv},
            "prompt": np.asarray(req["prompt"], np.int64),
            "scalars": np.asarray(
                [ctx, req["emitted"], req["n"]], np.int64),
            # [block_tokens, max_len, lora_slots], as the real engine
            "geom": np.asarray([bt, self.max_len, 0], np.int64),
        }

    def import_row(self, state: dict,
                   block_tokens: Optional[int] = None) -> int:
        import numpy as np

        geom = state.get("geom")
        if geom is not None:
            g = [int(x) for x in np.asarray(geom).reshape(-1)]
            exported = {"block_tokens": g[0], "max_len": g[1],
                        "lora_slots": g[2] if len(g) > 2 else 0}
            importer = {"block_tokens": (int(block_tokens)
                                         if block_tokens else g[0]),
                        "max_len": int(self.max_len), "lora_slots": 0}
            for axis in ("block_tokens", "max_len", "lora_slots"):
                if exported[axis] != importer[axis]:
                    raise KVGeometryMismatch(
                        f"cannot import row: exported geometry "
                        f"(block_tokens={exported['block_tokens']}, "
                        f"max_len={exported['max_len']}, "
                        f"lora_slots={exported['lora_slots']}) does "
                        f"not match importing engine geometry "
                        f"(block_tokens={importer['block_tokens']}, "
                        f"max_len={importer['max_len']}, "
                        f"lora_slots={importer['lora_slots']}): "
                        f"{axis} mismatch",
                        axis=axis, exported=exported, importer=importer)
        if not self._free:
            raise RuntimeError("no free row to import into")
        scalars = [int(x) for x in np.asarray(state["scalars"])]
        prompt = [int(t) for t in np.asarray(state["prompt"])]
        rid = self._next_rid
        self._next_rid += 1
        self._rows[rid] = {"rid": rid, "prompt": prompt,
                           "n": scalars[2], "emitted": scalars[1],
                           "consumed": len(prompt), "head": 0,
                           "suffix": 0, "slot": self._free.pop(0)}
        return rid

    def evict(self, rid: int) -> bool:
        for i, req in enumerate(self._queue):
            if req["rid"] == rid:
                self._queue.pop(i)
                return True
        req = self._prefilling.pop(rid, None) or self._rows.pop(rid, None)
        if req is None:
            return False
        self._free.append(req["slot"])
        return True

    # ------------------------------------------------------------ state
    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._rows) + len(self._prefilling)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def free_rows(self) -> int:
        return len(self._free)

    @property
    def active_rows(self) -> int:
        return len(self._rows)

    @property
    def prefilling_rows(self) -> int:
        return len(self._prefilling)
