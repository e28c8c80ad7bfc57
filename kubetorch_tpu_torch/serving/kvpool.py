"""Paged-KV manager: device memory as the multi-tenant resource (port of
``kubetorch_tpu/serving/kvpool.py`` without the disaggregated handoff
functions, which wait for ``ROADMAP.md`` Queue 1's disaggregated phases).

- **Shared prefixes**: prompts are split by a rule
  (``KT_KV_PREFIX_SPLIT``), the prefix half is content-hashed per adapter
  (:class:`PrefixCache`), a hit reuses the registered device block
  (refcounted), a miss registers once for every later program with the
  same hash, and cold (refcount-0) prefixes LRU-evict under the budget.
- **Session park and resume**: :func:`offload_session` /
  :func:`restore_session` park an exported row (KV + sampler state) in
  the store through the packed-array codec, raw by default so a resume is
  token-exact, with per-block leaves under a delta manifest so a re-park
  ships only its new blocks.

:class:`KVBlockLedger` is the accounting both share: device memory in KV
blocks (``KT_KV_BLOCK_TOKENS`` tokens each), one budget
(``KT_KV_HBM_BUDGET``) over row planes and prefix blocks. Everything here
is host-side bookkeeping, mutated under the engine's scheduler lock; the
classes carry no locks of their own.
"""

from __future__ import annotations

import hashlib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from kubetorch_tpu_torch.config import ConfigError, env_bool, env_str
from kubetorch_tpu_torch.observability import tracing


def blocks_for(tokens: int, block_tokens: int) -> int:
    """KV blocks a ``tokens``-deep context occupies (ceil, min 1)."""
    tokens = max(1, int(tokens))
    bt = max(1, int(block_tokens))
    return -(-tokens // bt)


def padded_blocks(ctx_tokens: int, block_tokens: int,
                  max_tokens: Optional[int] = None) -> int:
    """Block count a row EXPORT pads its KV to: the power-of-two >= the
    need (min 4), clamped to the grid depth. Padding buys a STABLE leaf
    structure across re-parks of a growing session — the delta manifest
    only skips unchanged leaves when the treedef matches, so a park that
    added one block must not change the tree shape — at the cost of up
    to 2x blocks on the first park (which the delta then amortizes)."""
    need = blocks_for(ctx_tokens, block_tokens)
    n = 4
    while n < need:
        n *= 2
    if max_tokens:
        n = min(n, blocks_for(max_tokens, block_tokens))
    return max(n, need)


# --------------------------------------------------------- split rules
def parse_split_rule(rule: Optional[str]) -> Optional[Callable]:
    """Compile ``KT_KV_PREFIX_SPLIT`` into ``prompt -> split index``
    (tokens before the index are the shared prefix) or None when off.

    - ``off`` / empty: no automatic sharing.
    - ``len:N``: the first N tokens are the prefix — the fixed-length
      system-prompt deployment shape. Prompts with <= N tokens take the
      UNSHARED path (split 0): by construction they don't contain the
      shared system prefix, and hashing a near-whole short prompt would
      register a never-shared entry per prompt — an extra device
      prefill dispatch each, churning the budgeted cache against the
      genuinely shared prefix.
    - ``token:ID``: split after the LAST occurrence of token ID (e.g.
      the system-prompt terminator / end-of-turn token); prompts without
      the token don't share.

    The engine clamps the returned index to ``[0, len(prompt) - 1]`` so
    a prefixed submit always keeps >= 1 suffix token (the rolling
    engine's contract)."""
    rule = (rule if rule is not None else env_str("KT_KV_PREFIX_SPLIT")
            or "off").strip().lower()
    if rule in ("", "off", "none", "0"):
        return None
    m = re.fullmatch(r"len:(\d+)", rule)
    if m:
        n = int(m.group(1))
        if n <= 0:
            return None
        return lambda prompt: n if len(prompt) > n else 0
    m = re.fullmatch(r"token:(\d+)", rule)
    if m:
        tid = int(m.group(1))

        def _after_last(prompt, tid=tid):
            for i in range(len(prompt) - 1, -1, -1):
                if int(prompt[i]) == tid:
                    return i + 1
            return 0

        return _after_last
    raise ConfigError(
        f"KT_KV_PREFIX_SPLIT={rule!r} is not a valid split rule "
        f"(use 'off', 'len:N', or 'token:ID')")


def split_prompt(prompt: Sequence[int],
                 rule: Optional[Callable]) -> Tuple[List[int], List[int]]:
    """Apply a compiled split rule; → ``(prefix, suffix)`` with suffix
    never empty (a whole-prompt prefix keeps its last token as suffix so
    the prefixed admission has something to forward)."""
    prompt = [int(t) for t in prompt]
    if rule is None or len(prompt) < 2:
        return [], prompt
    idx = max(0, min(int(rule(prompt)), len(prompt) - 1))
    return prompt[:idx], prompt[idx:]


def prefix_key(tokens: Sequence[int], adapter: Any = -1) -> str:
    """Content hash of a prefix. Keyed per adapter IDENTITY: prefix KV
    is weight-dependent, so the same tokens under two adapters are two
    cache entries. ``adapter`` is a stable NAME (str) for pool-managed
    adapters and the raw slot int for directly-driven engines — named
    adapters must NOT key by slot: the pool recycles slots (cold
    adapters LRU-evict and the slot reloads with another tenant's
    weights), and a slot-keyed entry would splice tenant A's prefix KV
    under tenant B's rows after one evict/load cycle."""
    h = hashlib.sha256()
    # distinct domains: a tenant NAMED "0" must not collide with raw
    # slot 0 (a ctor-frozen engine's adapter_id)
    if isinstance(adapter, str):
        h.update(f"an{adapter}:".encode())
    else:
        h.update(f"a{int(adapter)}:".encode())
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.hexdigest()


# ------------------------------------------------------------- ledger
class KVBlockLedger:
    """HBM accounting in KV blocks over row planes + prefix blocks.

    One budget for both: a block a cached prefix holds is a block a
    live row cannot, which is exactly the tension the LRU eviction and
    the admission scheduler arbitrate. Rows reserve their WORST-CASE
    footprint (context + full token budget) at submit — the admission
    decision must hold for the row's whole life, not just its first
    chunk."""

    def __init__(self, budget_blocks: int, block_tokens: int):
        self.budget = max(0, int(budget_blocks))   # 0 = unbounded
        self.block_tokens = max(1, int(block_tokens))
        self._rows: Dict[int, int] = {}            # rid -> blocks
        self._prefix_blocks = 0

    # rows ------------------------------------------------------------
    # (no gauge writes here: the engine's _publish_gauges refreshes
    # kv_blocks_{used,free} from this ledger every driver tick — a
    # second writer per reserve/release would just add hot-path lock
    # traffic on the same numbers)
    def reserve_row(self, rid: int, tokens: int) -> int:
        blocks = blocks_for(tokens, self.block_tokens)
        self._rows[rid] = self._rows.get(rid, 0) + blocks
        return blocks

    def release_row(self, rid: int) -> int:
        return self._rows.pop(rid, 0)

    # prefixes --------------------------------------------------------
    def add_prefix(self, blocks: int) -> None:
        self._prefix_blocks += max(0, int(blocks))

    def drop_prefix(self, blocks: int) -> None:
        self._prefix_blocks = max(0, self._prefix_blocks - max(0, blocks))

    # state -----------------------------------------------------------
    @property
    def row_blocks(self) -> int:
        return sum(self._rows.values())

    @property
    def prefix_blocks(self) -> int:
        return self._prefix_blocks

    @property
    def used(self) -> int:
        return self.row_blocks + self._prefix_blocks

    @property
    def free(self) -> int:
        if not self.budget:
            return 1 << 30
        return max(0, self.budget - self.used)


# ------------------------------------------------------- prefix cache
class PrefixEntry:
    __slots__ = ("key", "pid", "tokens", "blocks", "adapter_id", "refs",
                 "last_used", "hits")

    def __init__(self, key: str, pid: int, tokens: int, blocks: int,
                 adapter_id: Any):
        self.key = key
        self.pid = pid            # engine-level prefix id (register_prefix)
        self.tokens = tokens
        self.blocks = blocks
        self.adapter_id = adapter_id   # name (str) or raw slot (int)
        self.refs = 0             # live rows decoding under this prefix
        self.last_used = time.monotonic()
        self.hits = 0


class PrefixCache:
    """Content-hash → registered device prefix block, refcounted + LRU.

    The cache OWNS the policy only; the device blocks belong to the
    engine (``register_prefix``/``drop_prefix``). ``evict_for`` returns
    the entries to drop and the caller (the engine lock holder) frees
    the device side — the cache never reaches into the engine."""

    def __init__(self, ledger: KVBlockLedger):
        self._ledger = ledger
        self._entries: Dict[str, PrefixEntry] = {}
        self._by_pid: Dict[int, PrefixEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, key: str) -> Optional[PrefixEntry]:
        """Read-only probe (shed-check pricing): no LRU touch, no hit
        count — only :meth:`lookup` (the admission path) counts."""
        return self._entries.get(key)

    def lookup(self, key: str) -> Optional[PrefixEntry]:
        entry = self._entries.get(key)
        if entry is not None:
            entry.last_used = time.monotonic()
            entry.hits += 1
        return entry

    def insert(self, key: str, pid: int, tokens: int,
               adapter_id: Any) -> PrefixEntry:
        blocks = blocks_for(tokens, self._ledger.block_tokens)
        entry = PrefixEntry(key, pid, tokens, blocks, adapter_id)
        self._entries[key] = entry
        self._by_pid[pid] = entry
        self._ledger.add_prefix(blocks)
        return entry

    def acquire(self, entry: PrefixEntry) -> None:
        entry.refs += 1
        entry.last_used = time.monotonic()

    def release_pid(self, pid: int) -> None:
        entry = self._by_pid.get(pid)
        if entry is not None and entry.refs > 0:
            entry.refs -= 1
            entry.last_used = time.monotonic()

    def remove(self, pid: int) -> Optional[PrefixEntry]:
        """Drop one entry by pid (refs must be 0) — THE removal
        bookkeeping, shared by LRU eviction and explicit drops so the
        ledger can never desync from the entry dicts."""
        entry = self._by_pid.get(pid)
        if entry is None:
            return None
        if entry.refs:
            raise ValueError(
                f"prefix {pid} has {entry.refs} live row(s) decoding "
                f"under it")
        del self._entries[entry.key]
        del self._by_pid[entry.pid]
        self._ledger.drop_prefix(entry.blocks)
        return entry

    def remove_by_adapter(self, adapter: Any) -> List[PrefixEntry]:
        """Drop every COLD entry keyed under ``adapter`` — run when the
        adapter pool evicts a named adapter: its name-keyed entries can
        never hit again until a reload, so their device KV blocks are
        HBM rent for a tenant that is no longer resident. Pinned
        entries are skipped defensively (a live row under the adapter
        also pins the adapter in the pool, so eviction should never see
        one). Returns the dropped entries — the caller frees their
        device blocks."""
        dropped: List[PrefixEntry] = []
        for entry in [e for e in self._entries.values()
                      if e.adapter_id == adapter]:
            if entry.refs:
                continue
            self.remove(entry.pid)
            dropped.append(entry)
        return dropped

    def evict_for(self, needed_blocks: int,
                  protect: frozenset = frozenset()) -> List[PrefixEntry]:
        """Cold-prefix LRU: pop refcount-0 entries (oldest
        ``last_used`` first) until ``needed_blocks`` fit the budget;
        in-use prefixes — and pids in ``protect`` (e.g. the prefix the
        caller JUST resolved for the row being admitted, not yet
        refcounted) — are never touched. Returns the dropped entries —
        the caller frees their device blocks."""
        dropped: List[PrefixEntry] = []
        if not self._ledger.budget:
            return dropped
        while self._ledger.free < needed_blocks:
            cold = [e for e in self._entries.values()
                    if e.refs == 0 and e.pid not in protect]
            if not cold:
                break
            victim = min(cold, key=lambda e: e.last_used)
            self.remove(victim.pid)
            dropped.append(victim)
        return dropped

    def stats(self) -> Dict[str, int]:
        return {
            "prefixes": len(self._entries),
            "prefix_blocks": self._ledger.prefix_blocks,
            "prefix_refs": sum(e.refs for e in self._entries.values()),
            "prefix_cache_hits": sum(e.hits
                                     for e in self._entries.values()),
        }


# --------------------------------------------------- session offload
_SAFE_SESSION = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,127}")


def check_session_id(session_id: str) -> str:
    """Session ids become store keys — validate before they touch the
    key namespace (same hygiene as ``client._safe_key``). ``fullmatch``,
    not ``match``+``$``: ``$`` would accept a trailing newline, and
    ``"abc\\n"`` must not become a store key."""
    if not isinstance(session_id, str) or not _SAFE_SESSION.fullmatch(
            session_id):
        raise ValueError(
            f"session_id {session_id!r} must match "
            f"[A-Za-z0-9][A-Za-z0-9._-]{{0,127}}")
    return session_id


def session_key(session_id: str) -> str:
    prefix = (env_str("KT_KV_SESSION_PREFIX") or "kv/sessions").strip("/")
    return f"{prefix}/{check_session_id(session_id)}"


def offload_codec(quantized: bool) -> str:
    """Codec for parked KV. ``auto`` = ``raw`` for every grid: a parked
    session must resume TOKEN-IDENTICAL by default, and the int8 wire
    codec would lossy-quantize a bf16 grid's KV planes (an int8 grid's
    export is already ``(q, scale)`` pairs at half size — and its f32
    SCALE planes are >=2-D floats the int8 codec would re-quantize, so
    raw is right there twice over). Setting ``KT_KV_OFFLOAD_CODEC=int8``
    opts a bf16 grid into ~2x fewer wire bytes at the cost of exact
    resume (the same near-tie-argmax drift as the int8 KV grid);
    ``zlib``/``zstd`` compress losslessly."""
    codec = (env_str("KT_KV_OFFLOAD_CODEC") or "auto").strip().lower()
    del quantized  # kept in the signature for callers/tests; 'auto' no
    #                longer branches on it (exactness is the default)
    if codec == "auto":
        return "raw"
    return codec


def state_summary(state: Dict[str, Any]) -> Tuple[int, int, int]:
    """Engine-agnostic header of an exported row state: every engine's
    ``export_row`` puts ``[context_tokens, emitted_tokens,
    max_new_tokens]`` in ``state["scalars"]`` — the pool needs exactly
    this much (block accounting + budget) without understanding the
    engine-specific KV layout around it."""
    scalars = state["scalars"]
    return int(scalars[0]), int(scalars[1]), int(scalars[2])


def _schema_of(tree: Any) -> Any:
    """Leaf-shape-free copy of the state tree (every leaf → 0) — the
    unflatten template a restorer needs, published as a tiny JSON
    sidecar next to the array blob (``get_arrays`` without a template
    returns a flat leaf list; the exported tree's block count varies per
    park, so the structure must travel with the data)."""
    if isinstance(tree, dict):
        return {k: _schema_of(v) for k, v in tree.items()}
    return 0


def offload_session(session_id: str, state: Dict[str, Any],
                    quantized: bool = False) -> str:
    """Park one exported row: publish its state tree to the store under
    the session key through the packed-array codec (plus a JSON schema
    sidecar under ``<key>.schema`` so the restorer can rebuild the tree).
    Per-block KV leaves + ``delta=True`` (``KT_KV_SESSION_DELTA``) mean a
    re-park of the same session ships only the blocks that changed since
    the last park."""
    import json

    from kubetorch_tpu_torch.data_store.client import DataStoreClient
    from kubetorch_tpu_torch.data_store.device_transfer import put_arrays

    key = session_key(session_id)
    ctx, emitted, _ = state_summary(state)
    t0 = time.perf_counter()
    with tracing.span("kv.offload",
                      attrs={"session": session_id, "ctx_tokens": ctx,
                             "emitted": emitted}):
        put_arrays(key, state, codec=offload_codec(quantized),
                   delta=env_bool("KT_KV_SESSION_DELTA"))
        # arrays first, schema second: a visible schema implies its
        # arrays already landed
        DataStoreClient.default()._backend().put_blob(
            f"{key}.schema", json.dumps(_schema_of(state)).encode())
    tracing.record_span("kv.offload_wall", time.perf_counter() - t0,
                        attrs={"session": session_id})
    return key


def restore_session(session_id: str) -> Optional[Dict[str, Any]]:
    """Fetch a parked session's state tree back through the streaming
    restore (leaves assembled chunk by chunk; int8-coded leaves dequantize
    on unpack) as CPU tensors. → None when nothing is parked under the
    id: the caller falls back to a normal prefill."""
    import json

    from kubetorch_tpu_torch.data_store.client import DataStoreClient
    from kubetorch_tpu_torch.data_store.device_transfer import get_arrays
    from kubetorch_tpu_torch.exceptions import DataStoreError

    key = session_key(session_id)
    with tracing.span("kv.restore", attrs={"session": session_id}):
        try:
            template = json.loads(DataStoreClient.default()._backend()
                                  .get_blob(f"{key}.schema"))
            return get_arrays(key, template=template, streaming=None)
        except (DataStoreError, ValueError, OSError):
            # nothing parked, a schema/blob mismatch from a racing
            # re-park, or the blob deleted under the read (a
            # completion-drop racing this restore): the caller re-prefills
            return None


def drop_session(session_id: str) -> bool:
    """Delete a parked session blob + its schema sidecar — run when the
    session's generation completes (a finished session's blob is stale:
    left in place it would shadow the session's next program) or when
    the conversation ends."""
    from kubetorch_tpu_torch.data_store.client import DataStoreClient
    from kubetorch_tpu_torch.exceptions import DataStoreError

    key = session_key(session_id)
    dropped = False
    for k in (key, f"{key}.schema"):
        try:
            dropped = bool(DataStoreClient.default().delete(k)) or dropped
        except DataStoreError:
            pass
    return dropped


# ---------------------------------------------------------- the pool
class PagedKVPool:
    """The engine-facing facade: one ledger + one prefix cache +
    per-row metadata, all mutated under the engine's scheduler lock.

    ``row_cost(ctx_tokens)`` is the admission currency: the scheduler
    asks "how many blocks would this program pin" and compares against
    :attr:`free_blocks` — a prefix-hit program's ``ctx_tokens`` is only
    its suffix + budget, which is the whole point."""

    def __init__(self, budget_blocks: int, block_tokens: int,
                 split_rule: Optional[str] = None):
        self.ledger = KVBlockLedger(budget_blocks, block_tokens)
        self.prefixes = PrefixCache(self.ledger)
        self.split = parse_split_rule(split_rule)
        self._row_prefix: Dict[int, int] = {}     # rid -> prefix pid

    # accounting ------------------------------------------------------
    @property
    def block_tokens(self) -> int:
        return self.ledger.block_tokens

    @property
    def free_blocks(self) -> int:
        return self.ledger.free

    @property
    def used_blocks(self) -> int:
        return self.ledger.used

    def row_cost(self, ctx_tokens: int) -> int:
        return blocks_for(ctx_tokens, self.ledger.block_tokens)

    def reserve_row(self, rid: int, ctx_tokens: int,
                    prefix_pid: Optional[int] = None) -> int:
        blocks = self.ledger.reserve_row(rid, ctx_tokens)
        if prefix_pid is not None:
            entry = self.prefixes._by_pid.get(prefix_pid)
            if entry is not None:
                self.prefixes.acquire(entry)
                self._row_prefix[rid] = prefix_pid
        return blocks

    def release_row(self, rid: int) -> int:
        pid = self._row_prefix.pop(rid, None)
        if pid is not None:
            self.prefixes.release_pid(pid)
        return self.ledger.release_row(rid)

    def stats(self) -> Dict[str, Any]:
        return {
            "kv_block_tokens": self.ledger.block_tokens,
            "kv_budget_blocks": self.ledger.budget,
            "kv_blocks_used": self.ledger.used,
            "kv_blocks_free": (self.ledger.free if self.ledger.budget
                               else -1),
            "kv_row_blocks": self.ledger.row_blocks,
            **self.prefixes.stats(),
        }
