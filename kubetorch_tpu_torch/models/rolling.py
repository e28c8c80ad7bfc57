"""Continuous (rolling) batching for KV-cache generation (port of the core
of ``kubetorch_tpu/models/rolling.py``).

Requests join and leave a shared decode batch at any time, instead of the
whole batch waiting for its slowest member (the static
:class:`~kubetorch_tpu_torch.models.generate.Generator` contract).

- The engine owns a ``[L, max_slots, max_len, Hkv, D]`` grid cache; a
  *slot* is a batch row. New requests prefill into free rows (grouped by
  padded-length bucket), and decode advances **all** rows, each at its own
  depth.
- A decode chunk runs ``steps_per_call`` tokens with the grid read-only:
  each step's K/V land in a small ``[L, max_slots, steps_per_call]`` chunk
  cache, attention spans grid plus chunk, and the chunk merges into the
  grid once at the end (``llama.merge_chunk_into_grid``). Requests that
  finish mid-chunk are trimmed on the host and free their row at the chunk
  boundary. One host synchronisation per chunk reads the emitted tokens.
- Each row's depth and activity are kept on the host (the JAX package
  keeps them on the device to spare a TPU dispatch); every change to them
  is known there, so no call waits for the card to report them.
- ``prefill_chunk``: prompts longer than this prefill ``prefill_chunk``
  tokens at a time, written straight into the grid at the row's depth by
  :meth:`RollingGenerator.prefill_step`, which runs over the prefilling
  rows only. A long prompt never stalls the live rows for more than one
  chunk.

A decode-active row exports as a host tree (:meth:`RollingGenerator.
export_row`, per-block KV leaves) and imports into a free row of any
engine of the same geometry, of this package or of the JAX package
(:meth:`RollingGenerator.import_row`); the serving engine parks sessions
through the store with them (``serving/kvpool.py``).

Not ported yet (``ROADMAP.md`` Queue 1): adapters (item 3), speculation
(item 4), a mesh (item 6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kubetorch_tpu_torch._device import check_on_device, resolve_device
from kubetorch_tpu_torch.exceptions import KVGeometryMismatch
from kubetorch_tpu_torch.models import llama
from kubetorch_tpu_torch.models.configs import LlamaConfig
from kubetorch_tpu_torch.models.generate import filter_logits
from kubetorch_tpu_torch.observability import devstats

_WINDOW = 64    # recent tokens a repetition penalty looks at

# Arguments of the JAX engine that this slice does not port, and the
# ROADMAP.md Queue 1 item that brings each.
_NOT_PORTED = {
    "mesh": "item 6 (multi-GPU)", "rules": "item 6 (multi-GPU)",
    "adapters": "item 3 (LoRA)", "adapter_scale": "item 3 (LoRA)",
    "lora_slots": "item 3 (LoRA)", "spec_k": "item 4 (speculation)",
    "spec_ngram": "item 4 (speculation)",
    "spec_ema_alpha": "item 4 (speculation)",
    "adapter_id": "item 3 (LoRA)",
}


def _check_adapter_id(adapter_id: int) -> None:
    """-1 (the base model) is the only adapter id without LoRA."""
    if adapter_id != -1:
        raise NotImplementedError(
            f"adapter_id={adapter_id}: adapters are not ported yet "
            f"(ROADMAP.md Queue 1 {_NOT_PORTED['adapter_id']})")


def _bucket(n: int, lo: int = 16) -> int:
    """Pad length → power-of-two bucket (few prefill shapes cover all
    prompts)."""
    b = lo
    while b < n:
        b *= 2
    return b


class Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature",
                 "tokens", "done", "slot", "prefix_id", "stop",
                 "repetition_penalty", "consumed")

    def __init__(self, rid, prompt, max_new_tokens, temperature):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.tokens: List[int] = []
        self.done = False
        self.slot: Optional[int] = None
        self.prefix_id: Optional[int] = None
        self.stop: List[List[int]] = []
        self.repetition_penalty: float = 1.0
        self.consumed = 0  # prompt tokens already prefilled (chunked path)

    def match_stop(self) -> Optional[int]:
        """Earliest index (exclusive) at which a stop sequence completes in
        ``tokens``; None if no stop sequence has appeared."""
        best = None
        for seq in self.stop:
            n = len(seq)
            for end in range(n, len(self.tokens) + 1):
                if self.tokens[end - n:end] == seq:
                    if best is None or end < best:
                        best = end
                    break
        return best


def _penalize(logits: torch.Tensor, win: torch.Tensor,
              pen: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty over each row's window ``win`` [B, W] of
    recent token ids (−1 = empty): the logits of those tokens are divided
    by ``pen`` [B] where positive and multiplied where not. The window's
    tokens are marked by counting (``scatter_add_``), so a token seen twice
    adds twice to one entry and no index is written with two values."""
    B, V = logits.shape
    idx = torch.where(win >= 0, win, torch.full_like(win, V))
    seen = torch.zeros((B, V + 1), dtype=torch.int32, device=logits.device)
    seen.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    adjusted = torch.where(logits > 0, logits / pen[:, None],
                           logits * pen[:, None])
    return torch.where(seen[:, :V] > 0, adjusted, logits)


class RollingGenerator:
    """Continuous-batching engine over a fixed slot grid.

    >>> eng = RollingGenerator(params, cfg, max_slots=8)   # params on the card
    >>> rid = eng.submit([1, 2, 3], max_new_tokens=64)
    >>> while eng.pending:
    ...     for rid, toks, done in eng.step():
    ...         ...

    ``kv_dtype="int8"``: a per-vector-quantized grid (half the cache
    bytes). Decode chunks stay in the compute dtype (bf16 on the int8 grid)
    and quantize at the once-per-chunk merge; admission prefills quantize
    on write.

    ``prefill_chunk``: prompts longer than this prefill in chunks of that
    many tokens written straight into the grid (:meth:`prefill_step`, one
    call per chunk for all prefilling rows) instead of one private-cache
    prefill. ``None`` keeps the one-shot bucketed admission everywhere;
    requests with a ``prefix_id`` keep it regardless.

    ``device`` is where the params lie and the work runs: ``cuda`` unless
    the caller asks for ``cpu``. Sampling draws from a ``torch.Generator``
    on that device seeded with ``seed`` (other numbers than the JAX
    package's for the same seed).
    """

    def __init__(self, params: Dict[str, Any], cfg: LlamaConfig,
                 max_slots: int = 8, max_len: Optional[int] = None,
                 mesh=None, rules=None, eos_id: Optional[int] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, steps_per_call: int = 8, admit_width: int = 0,
                 adapters=None, adapter_scale: Optional[float] = None,
                 lora_slots: Optional[int] = None, kv_dtype: str = "bf16",
                 spec_k: Optional[int] = 0, spec_ngram: Optional[int] = None,
                 spec_ema_alpha: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        given = {"mesh": mesh, "rules": rules, "adapters": adapters,
                 "adapter_scale": adapter_scale, "lora_slots": lora_slots,
                 "spec_k": spec_k or None, "spec_ngram": spec_ngram,
                 "spec_ema_alpha": spec_ema_alpha}
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"RollingGenerator({name}=...) is not ported yet "
                    f"(ROADMAP.md Queue 1 {_NOT_PORTED[name]})")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.device = resolve_device(device)
        check_on_device(params["embedding"], self.device, "params")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len or cfg.max_seq_len
        # widest single admission prefill (0 = max_slots)
        self.admit_width = min(admit_width or max_slots, max_slots)
        self.eos_id = eos_id
        self.top_k = top_k
        self.top_p = top_p
        self.steps_per_call = max(1, steps_per_call)
        self.prefill_chunk = prefill_chunk
        self.kv_quantized = kv_dtype == "int8"
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # device state: the grid and each row's pending next-token logits
        self.cache = llama.init_cache(cfg, max_slots, self.max_len,
                                      quantized=self.kv_quantized,
                                      device=self.device)
        self._logits = torch.zeros((max_slots, cfg.vocab_size),
                                   dtype=torch.float32, device=self.device)
        # host state: each row's depth (grid rows written) and whether it
        # decodes
        self._pos = np.zeros(max_slots, np.int64)
        self._active = np.zeros(max_slots, bool)

        # host bookkeeping
        self._free = list(range(max_slots))
        self._slots: Dict[int, Request] = {}
        self._queue: List[Request] = []
        # slot -> Request mid-chunked-prefill: the row is owned (not in
        # _free) but not decoding yet; prefill_step() advances these
        self._prefilling: Dict[int, Request] = {}
        self._next_rid = 0
        self._temps = np.zeros(max_slots, np.float32)
        self._penalties = np.ones(max_slots, np.float32)
        self._win = np.full((max_slots, _WINDOW), -1, np.int64)
        # prefix_id -> {"planes": KV cache of the prefix, "len": tokens}.
        # Ids come from a counter: drop_prefix punches holes, and a reused
        # id would serve the wrong prefix to an old submitter.
        self._prefixes: Dict[int, dict] = {}
        self._next_prefix_id = 0
        # prompt tokens run through a prefill forward (each shared prefix
        # counts once, at register_prefix)
        self.prefill_tokens = 0
        # utilization accounting: every forward dispatch below counts its
        # analytic FLOPs and bytes here (_count), the numerators of the
        # serving engine's MFU/MBU
        self._devstats = devstats.AnalyticCosts()
        self._devstats_peaks: Any = "unset"
        self._cost_model()

    # ------------------------------------------------------------ public
    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._slots)
                + len(self._prefilling))

    @property
    def queued(self) -> int:
        """Requests waiting for a row (not yet admitted)."""
        return len(self._queue)

    @property
    def free_rows(self) -> int:
        return len(self._free)

    @property
    def active_rows(self) -> int:
        return len(self._slots)

    @property
    def prefilling_rows(self) -> int:
        return len(self._prefilling)

    def devstats_snapshot(self) -> Dict[str, float]:
        """Cumulative analytic dispatch costs (FLOPs, device-memory bytes,
        dispatch count): the MFU/MBU numerators. Same surface as
        ``SimRollingEngine.devstats_snapshot``."""
        return self._devstats.snapshot()

    def devstats_peaks(self) -> Optional[Tuple[float, float]]:
        """(peak_flops, peak_bytes_per_s) of the engine's card, or None on
        the CPU or an unknown card (the serving engine then publishes no
        MFU/MBU). Cached after the first read."""
        if self._devstats_peaks == "unset":
            self._devstats_peaks = devstats.device_peaks(self.device)
        return self._devstats_peaks

    def submit(self, prompt, max_new_tokens: int = 128,
               temperature: float = 0.0, prefix_id: Optional[int] = None,
               stop: Optional[List[List[int]]] = None,
               repetition_penalty: float = 1.0,
               adapter_id: int = -1) -> int:
        """Queue a request; returns its id. ``stop``: token sequences that
        end generation when they appear (included in the output, like
        ``eos_id``), checked on the host per chunk. ``repetition_penalty``
        > 1 discounts tokens seen in the last 64 positions (HF semantics),
        applied on the device at every step. ``adapter_id`` must be -1
        (the base model) until adapters are ported."""
        _check_adapter_id(adapter_id)
        prompt = list(prompt)
        prefix_len = 0
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix_id {prefix_id}")
            if not prompt:
                raise ValueError("prefixed submit needs >= 1 suffix token")
            prefix_len = self._prefixes[prefix_id]["len"]
        elif not prompt:
            raise ValueError("empty prompt")
        total = prefix_len + len(prompt) + max_new_tokens
        # worst-case overrun: a request can finish mid-chunk and keep
        # advancing until the chunk boundary
        margin = self.steps_per_call
        if total + margin > self.max_len:
            raise ValueError(
                f"prefix+prompt+max_new_tokens+chunk_margin "
                f"{prefix_len}+{len(prompt)}+{max_new_tokens}"
                f"+{margin} exceeds max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, float(temperature))
        req.prefix_id = prefix_id
        req.stop = [list(s) for s in (stop or []) if s]
        req.repetition_penalty = float(repetition_penalty)
        self._queue.append(req)
        return rid

    def step(self) -> List[Tuple[int, List[int], bool]]:
        """Admit queued requests into free rows, advance any chunked
        prefills by one chunk, run one decode chunk (``steps_per_call``
        tokens). Returns ``(rid, new_tokens, finished)`` per active
        request."""
        self.admit()
        self.prefill_step()
        return self.decode_step()

    def admit(self, max_rows: Optional[int] = None) -> int:
        """Move queued requests into free rows (at most ``max_rows`` this
        wave). Short prompts prefill grouped by (bucket, prefix), at most
        ``admit_width`` a call; prompts longer than ``prefill_chunk`` claim
        their row now and fill it one :meth:`prefill_step` chunk at a time.
        Returns the number of rows claimed."""
        admitted = 0
        by_key: Dict[tuple, List[Request]] = {}
        while self._free and self._queue and (
                max_rows is None or admitted < max_rows):
            req = self._queue.pop(0)
            req.slot = self._free.pop(0)
            admitted += 1
            if (self.prefill_chunk is not None
                    and req.prefix_id is None
                    and len(req.prompt) > self.prefill_chunk):
                self._start_chunked(req)
                continue
            key = (_bucket(len(req.prompt)), req.prefix_id)
            by_key.setdefault(key, []).append(req)
        for (p_pad, prefix_id), group in by_key.items():
            for i in range(0, len(group), self.admit_width):
                self._admit_group(group[i:i + self.admit_width], p_pad,
                                  prefix_id)
        return admitted

    def decode_step(self) -> List[Tuple[int, List[int], bool]]:
        """One decode chunk over the active rows (no admission)."""
        if not self._slots:
            return []
        return self._decode_chunk()

    def prefill_step(self) -> List[int]:
        """Advance every mid-chunked-prefill row by one ``prefill_chunk``
        of its prompt, in one forward over those rows, and activate the rows
        whose prompt completes. Returns their rids."""
        if not self._prefilling:
            return []
        C = self.prefill_chunk
        rows = np.fromiter(self._prefilling, np.int64,
                           len(self._prefilling))
        feed = np.zeros((len(rows), C), np.int64)
        counts = np.zeros(len(rows), np.int64)
        finals = np.zeros(len(rows), bool)
        done_reqs: List[Request] = []
        for i, req in enumerate(self._prefilling.values()):
            rem = req.prompt[req.consumed:req.consumed + C]
            feed[i, :len(rem)] = rem
            counts[i] = len(rem)
            req.consumed += len(rem)
            if req.consumed >= len(req.prompt):
                finals[i] = True
                done_reqs.append(req)
        self._prefill_extend_impl(rows, feed, counts, finals)
        activated: List[int] = []
        for req in done_reqs:
            del self._prefilling[req.slot]
            self._activate(req, req.prompt)
            activated.append(req.rid)
        return activated

    def evict(self, rid: int) -> bool:
        """Cancel a queued, mid-prefill or decoding request and free its row
        now. The row's stale K/V are never read: attention is masked to
        each row's depth, and a new admission rewrites the row from 0.
        Returns whether the rid was found."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                return True
        slot = None
        for s, req in self._prefilling.items():
            if req.rid == rid:
                slot = s
                break
        if slot is not None:
            del self._prefilling[slot]
        else:
            for s, req in self._slots.items():
                if req.rid == rid:
                    slot = s
                    break
            if slot is None:
                return False
            del self._slots[slot]
        self._free_rows([slot])
        return True

    def run(self) -> Dict[int, List[int]]:
        """Drain everything; → {rid: generated tokens}."""
        out: Dict[int, List[int]] = {}
        while self.pending:
            for rid, toks, done in self.step():
                out.setdefault(rid, []).extend(toks)
        return out

    def register_prefix(self, tokens, adapter_id: int = -1) -> int:
        """Prefill a shared prefix (a system prompt) once; submissions that
        pass the returned ``prefix_id`` prefill only their suffix, on top
        of a copy of the prefix's K/V. On the int8 grid the prefix's cache
        is quantized, by the same writes admission prefills use. (The
        prefix runs at its own padded width, so its K/V, and near-tie
        argmaxes, can differ in the last bits from a full-prompt
        admission.) ``adapter_id`` must be -1, as in :meth:`submit`."""
        _check_adapter_id(adapter_id)
        tokens = list(tokens)
        if not tokens:
            raise ValueError("empty prefix")
        toks = np.zeros((1, _bucket(len(tokens))), np.int64)
        toks[0, :len(tokens)] = tokens
        planes = self._prefix_fill_impl(toks, len(tokens))
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = {"planes": planes, "len": len(tokens)}
        self.prefill_tokens += len(tokens)
        return pid

    def drop_prefix(self, prefix_id: int) -> bool:
        """Release a registered prefix's K/V. Rows already admitted keep
        their copy; only later submits with this id fail."""
        return self._prefixes.pop(prefix_id, None) is not None

    def prefix_len(self, prefix_id: int) -> int:
        return self._prefixes[prefix_id]["len"]

    def export_row(self, rid: int, block_tokens: int = 16
                   ) -> Dict[str, Any]:
        """Export a decode-active row as a host tree (CPU tensors): its
        grid K/V up to the row's depth and what it takes to resume the
        request elsewhere or later (sampler settings, penalty window,
        emitted tokens, stop sequences). The serving engine's session park
        publishes this tree through the store (``serving/kvpool.py``).

        The K/V goes out as per-block leaves (``block_tokens`` positions
        each, the depth padded to a block count, zeroed past the depth: a
        freed row keeps its previous occupant's K/V, which must not leave
        the engine, and zeros keep the padding byte-stable for the delta
        manifest). On the int8 grid the planes are the grid's ``(q,
        scale)`` pairs as they are, so a restore is bit-exact. A prefixed
        row exports its spliced prefix rows too: the tree is
        self-contained. Leaf names, dtypes and layout are the JAX
        package's, so either package imports the other's export (the JAX
        package's speculation leaves are not written here).

        Queued and mid-prefill rows raise ``KeyError`` (their logits are
        not seeded yet)."""
        from kubetorch_tpu_torch.serving.kvpool import padded_blocks

        slot = next((s for s, req in self._slots.items() if req.rid == rid),
                    None)
        if slot is None:
            raise KeyError(
                f"rid {rid} is not decode-active (queued and "
                f"mid-prefill rows cannot export)")
        req = self._slots[slot]
        bt = max(1, int(block_tokens))
        dpos = int(self._pos[slot])
        dend = padded_blocks(dpos, bt, self.max_len) * bt
        if dend > self.max_len:
            # the grid's tail is not block-aligned: whole blocks only,
            # which must still cover the row's depth
            dend = (self.max_len // bt) * bt
            if dpos > dend:
                raise ValueError(
                    f"cannot export a depth-{dpos} row in {bt}-token "
                    f"blocks on a max_len-{self.max_len} grid — pick a "
                    f"KT_KV_BLOCK_TOKENS that divides max_len")
        kv: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, grid in self.cache.items():
            plane = grid[:, slot, :dend].to("cpu", copy=True)
            plane[:, dpos:] = 0
            kv[name] = {f"{b:05d}": plane[:, b * bt:(b + 1) * bt]
                        for b in range(dend // bt)}

        def host(values, dtype):
            return torch.from_numpy(np.asarray(values, dtype))

        return {
            "kv": kv,
            "logits": self._logits[slot].to("cpu", copy=True),
            "win": host(self._win[slot], np.int32),
            "sampler": host([req.temperature, req.repetition_penalty],
                            np.float32),
            "prompt": host(req.prompt, np.int64),
            "tokens": host(req.tokens, np.int64),
            "stop_flat": host([t for seq in req.stop for t in seq],
                              np.int64),
            "stop_lens": host([len(s) for s in req.stop], np.int64),
            # [ctx_tokens, emitted, max_new_tokens, adapter_id,
            #  int8 grid, block_tokens]: the first three are the
            # engine-agnostic header kvpool.state_summary reads
            "scalars": host([dpos, len(req.tokens), req.max_new_tokens, -1,
                             int(self.kv_quantized), bt], np.int64),
            # the grid geometry the row left: [block_tokens, max_len,
            # lora_slots]; an importer that differs on any axis refuses
            "geom": host([bt, self.max_len, 0], np.int64),
        }

    def _check_geometry(self, state: Dict[str, Any],
                        expect_block_tokens: Optional[int]) -> None:
        """Refuse, with :class:`KVGeometryMismatch` naming both geometries
        and the axis, a state exported from a grid of another block size,
        ``max_len`` or LoRA slot count. States without a ``geom`` leaf
        keep the shape checks of :meth:`import_row` only."""
        geom = state.get("geom")
        if geom is None:
            return
        g = [int(x) for x in np.asarray(geom).reshape(-1)]
        exported = {"block_tokens": g[0], "max_len": g[1],
                    "lora_slots": g[2] if len(g) > 2 else 0}
        importer = {"block_tokens": (int(expect_block_tokens)
                                     if expect_block_tokens else g[0]),
                    "max_len": int(self.max_len), "lora_slots": 0}
        for axis in ("block_tokens", "max_len", "lora_slots"):
            if exported[axis] != importer[axis]:
                raise KVGeometryMismatch(
                    f"cannot import row: exported geometry "
                    f"(block_tokens={exported['block_tokens']}, "
                    f"max_len={exported['max_len']}, "
                    f"lora_slots={exported['lora_slots']}) does not "
                    f"match importing engine geometry "
                    f"(block_tokens={importer['block_tokens']}, "
                    f"max_len={importer['max_len']}, "
                    f"lora_slots={importer['lora_slots']}): "
                    f"{axis} mismatch",
                    axis=axis, exported=exported, importer=importer)

    def import_row(self, state: Dict[str, Any],
                   block_tokens: Optional[int] = None) -> int:
        """Splice an exported row (of this package's or the JAX package's
        ``export_row``; leaves as tensors or numpy arrays) into a free row
        and resume decoding it. The grid must match: layers, heads, head
        width and ``kv_dtype``, with the depth inside ``max_len``. Returns
        the new rid. The sampler's random stream is the engine's, not the
        row's: a greedy resume is token-identical to an uninterrupted run,
        a sampled one draws fresh numbers."""
        from kubetorch_tpu_torch.data_store.device_transfer import (
            as_host_tensor)

        if "spec" in state:
            raise NotImplementedError(
                "state was exported from a speculative engine; speculation "
                "is not ported yet (ROADMAP.md Queue 1 item 4 "
                "(speculation))")
        self._check_geometry(state, block_tokens)
        if not self._free:
            raise RuntimeError("no free row to import into")
        if set(state["kv"]) != set(self.cache):
            raise ValueError(
                f"KV planes {sorted(state['kv'])} do not match this "
                f"grid's {sorted(self.cache)} — kv_dtype mismatch "
                f"between export and import engines")
        scalars = [int(x) for x in np.asarray(state["scalars"])]
        dpos, n_emitted, max_new = scalars[0], scalars[1], scalars[2]
        _check_adapter_id(scalars[3] if len(scalars) > 3 else -1)
        planes = {name: torch.cat([as_host_tensor(blocks[b])
                                   for b in sorted(blocks)], dim=1)
                  for name, blocks in state["kv"].items()}
        grid = self.cache["k"]
        dend = planes["k"].shape[1]
        if (dend > self.max_len or planes["k"].shape[0] != grid.shape[0]
                or tuple(planes["k"].shape[2:]) != tuple(grid.shape[3:])):
            raise ValueError(
                f"imported KV shape {tuple(planes['k'].shape)} does not "
                f"fit grid {tuple(grid.shape)} (max_len {self.max_len})")
        margin = self.steps_per_call
        if dpos + (max_new - n_emitted) + margin > self.max_len:
            raise ValueError(
                f"restored depth {dpos} + remaining budget "
                f"{max_new - n_emitted} + chunk margin {margin} exceeds "
                f"max_len {self.max_len}")
        slot = self._free.pop(0)
        for name, plane in self.cache.items():
            plane[:, slot, :dend] = planes[name].to(
                device=self.device, dtype=plane.dtype)
        self._logits[slot] = as_host_tensor(state["logits"]).to(
            device=self.device, dtype=torch.float32)
        self._pos[slot] = dpos
        self._active[slot] = True
        temp, penalty = (float(x) for x in np.asarray(state["sampler"]))
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, [int(t) for t in np.asarray(state["prompt"])],
                      max_new, temp)
        req.tokens = [int(t) for t in np.asarray(state["tokens"])]
        req.consumed = len(req.prompt)
        req.repetition_penalty = penalty
        stop_flat = [int(t) for t in np.asarray(state["stop_flat"])]
        stops, at = [], 0
        for n in (int(x) for x in np.asarray(state["stop_lens"])):
            stops.append(stop_flat[at:at + n])
            at += n
        req.stop = stops
        req.slot = slot
        self._temps[slot] = temp
        self._penalties[slot] = penalty
        self._win[slot] = np.asarray(state["win"], np.int64)
        self._slots[slot] = req
        return rid

    def warmup(self, prompt_buckets=(16, 64, 128),
               sampling: bool = False) -> None:
        """Run the serving shapes once before traffic: a one-row and a
        full-width admission for each prompt bucket, and the decode chunk.
        Nothing compiles per shape here, but the first call builds the
        kernels and sizes the allocator's pools. ``sampling`` only matters
        to a speculative engine (not ported)."""
        del sampling
        for p_pad in sorted(set(_bucket(b) for b in prompt_buckets)):
            for width in sorted({1, self.max_slots}):
                for _ in range(width):
                    self.submit([1] * min(p_pad, self.max_len // 2),
                                max_new_tokens=1)
                self.run()

    # ----------------------------------------------------------- host side
    def _start_chunked(self, req: Request) -> None:
        """Claim the row for a chunked prefill. Nothing runs here: the
        row's depth is already 0 (rows reset when freed), and its grid rows
        are rewritten from 0 by the chunks."""
        req.consumed = 0
        self._prefilling[req.slot] = req
        self.prefill_tokens += len(req.prompt)

    def _activate(self, req: Request, prompt: List[int]) -> None:
        """The host half of an admission: the row's sampling settings and
        penalty window (seeded from the prompt's tail), and the row joins
        the decode batch."""
        slot = req.slot
        self._temps[slot] = req.temperature
        self._penalties[slot] = req.repetition_penalty
        self._win[slot] = -1
        tail = prompt[-_WINDOW:]
        if req.repetition_penalty != 1.0 and tail:
            self._win[slot, -len(tail):] = tail
        self._slots[slot] = req

    def _admit_group(self, group: List[Request], p_pad: int,
                     prefix_id: Optional[int] = None) -> None:
        """Prefill N same-(bucket, prefix) requests in one call. The JAX
        package pads N to one of two widths (dummy rows aimed past the grid)
        only to bound its XLA compiles; nothing here compiles per shape,
        so exactly N rows run."""
        n = len(group)
        toks = np.zeros((n, p_pad), np.int64)
        lens = np.zeros(n, np.int64)
        slots = np.zeros(n, np.int64)
        for i, req in enumerate(group):
            toks[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
            slots[i] = req.slot
            self._activate(req, req.prompt)
            self.prefill_tokens += len(req.prompt)
        if prefix_id is None:
            self._prefill_impl(toks, lens, slots)
        else:
            pfx = self._prefixes[prefix_id]
            self._prefill_px_impl(pfx["planes"], pfx["len"], toks, lens,
                                  slots)

    def _decode_chunk(self) -> List[Tuple[int, List[int], bool]]:
        toks = self._decode_impl(self.steps_per_call)   # [K, B]: the one sync
        # roll the host-side penalty windows by this chunk's tokens
        K, W = toks.shape[0], self._win.shape[1]
        if K >= W:
            self._win[:] = toks[-W:].T
        else:
            self._win[:, :-K] = self._win[:, K:]
            self._win[:, -K:] = toks.T
        return self._finish_events(
            {slot: [int(t) for t in toks[:, slot]] for slot in self._slots})

    def _finish_events(self, new_by_slot: Dict[int, List[int]]
                       ) -> List[Tuple[int, List[int], bool]]:
        """Trim each row's new tokens to its budget, eos and stop
        sequences, emit (rid, tokens, done) events, and free finished rows
        at the chunk boundary."""
        events: List[Tuple[int, List[int], bool]] = []
        freed: List[int] = []
        for slot in list(self._slots):
            req = self._slots[slot]
            new = new_by_slot[slot]
            room = req.max_new_tokens - len(req.tokens)
            new = new[:room]
            if self.eos_id is not None and self.eos_id in new:
                new = new[: new.index(self.eos_id) + 1]
            prev_len = len(req.tokens)
            req.tokens.extend(new)
            stopped = False
            if req.stop:
                cut = req.match_stop()
                if cut is not None:
                    req.tokens = req.tokens[:cut]
                    new = req.tokens[prev_len:]
                    stopped = True
            done = (stopped
                    or len(req.tokens) >= req.max_new_tokens
                    or (self.eos_id is not None
                        and bool(new) and new[-1] == self.eos_id))
            events.append((req.rid, new, done))
            if done:
                req.done = True
                del self._slots[slot]
                freed.append(slot)
        if freed:
            self._free_rows(freed)
        return events

    def _free_rows(self, freed: List[int]) -> None:
        """Release rows back to the free pool (finish or evict)."""
        self._active[freed] = False
        self._pos[freed] = 0
        self._win[freed] = -1
        self._penalties[freed] = 1.0
        self._free.extend(freed)

    # -------------------------------------------------------- device side
    def _cost_model(self) -> None:
        """Per-token constants of the analytic dispatch costs: elements of
        the stacked projection weights (``[L, K, N]`` leaves, scales
        aside) and of the output projection, the bytes a forward streams (every
        parameter but the embedding table, of which a forward gathers a
        few rows, unless it doubles as the output projection), and the
        K/V bytes of one cached token."""
        def nbytes(t):
            return t.numel() * t.element_size()

        layer_mm = sum(t.numel() for k, t in self.params["layers"].items()
                       if t.ndim >= 3 and not k.endswith("_scale"))
        head = self.params.get("lm_head", self.params["embedding"])
        self._layer_mm = layer_mm
        self._head_mm = head.numel()
        self._weight_bytes = (
            sum(nbytes(t) for t in self.params["layers"].values())
            + nbytes(head)
            + sum(nbytes(t) for k, t in self.params.items()
                  if k not in ("layers", "embedding", "lm_head")))
        self._kv_token_bytes = sum(
            nbytes(plane[:, 0, 0]) for plane in self.cache.values())

    def _count(self, tokens: int, unembedded: int, attn_pairs: int,
               kv_tokens_read: int, forwards: int = 1) -> None:
        """Count one dispatch into the devstats totals: 2 FLOPs per weight
        element and token (the output projection only for ``unembedded``
        positions), 4·L·Hq·D per attended (query, key) pair; bytes: the
        weights once per forward plus the cached K/V read."""
        cfg = self.cfg
        flops = (2 * self._layer_mm * tokens + 2 * self._head_mm * unembedded
                 + 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                 * attn_pairs)
        self._devstats.count(
            flops, forwards * self._weight_bytes
            + self._kv_token_bytes * kv_tokens_read)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _own_cache(self, n: int, width: int) -> Dict[str, torch.Tensor]:
        """A private cache of ``n`` rows and ``width`` slots, of the grid's
        kind."""
        return llama.init_cache(
            self.cfg, n, width,
            dtype=None if self.kv_quantized else self.cache["k"].dtype,
            quantized=self.kv_quantized, device=self.device)

    @torch.no_grad()
    def _prefill_impl(self, tokens: np.ndarray, prompt_lens: np.ndarray,
                      slots: np.ndarray) -> None:
        """Prefill N rows at once: one forward over a private N-row cache
        that covers only the padded prompt (a full-``max_len`` one would be
        a second grid), unembedded at each row's last real token, then
        spliced into the grid at ``slots``."""
        N, P = tokens.shape
        dev = self.device
        lens = self._tensor(prompt_lens)
        positions = torch.arange(P, device=dev)[None, :].expand(N, P)
        m = torch.arange(P, device=dev)[None, None, :]
        mask = (m <= positions[:, :, None]) & (m < lens[:, None, None])
        out, own = llama.forward_cached(
            self.params, self._tensor(tokens), positions,
            self._own_cache(N, P), 0, mask, self.cfg,
            unembed_positions=lens - 1)
        self._finish_admit(own, out[:, 0], slots, prompt_lens)
        self._count(N * P, N, N * P * P, N * P)

    def _finish_admit(self, own: Dict[str, torch.Tensor],
                      last: torch.Tensor, slots: np.ndarray,
                      new_pos: np.ndarray) -> None:
        """Splice own-cache rows ``[0, M_own)`` into the grid at ``slots``
        (prefill always writes from slot 0) and set each row's logits
        (``last`` [N, V], at its final real token), depth and activity."""
        idx = self._tensor(slots)
        width = min(own["k"].shape[2], self.max_len)
        for name, plane in self.cache.items():
            plane[:, idx, :width] = own[name][:, :, :width]
        self._logits[idx] = last
        self._pos[slots] = new_pos
        self._active[slots] = True

    @torch.no_grad()
    def _prefix_fill_impl(self, tokens: np.ndarray,
                          prefix_len: int) -> Dict[str, torch.Tensor]:
        """Forward a shared prefix once → its K/V planes (a 1-row private
        cache of the prefix's padded width)."""
        P = tokens.shape[1]
        dev = self.device
        positions = torch.arange(P, device=dev)[None, :]
        m = torch.arange(P, device=dev)[None, None, :]
        mask = (m <= positions[:, :, None]) & (m < prefix_len)
        _, own = llama.forward_cached(
            self.params, self._tensor(tokens), positions,
            self._own_cache(1, P), 0, mask, self.cfg,
            unembed_positions=torch.tensor([prefix_len - 1], device=dev))
        self._count(P, 1, P * P, P)
        return own

    @torch.no_grad()
    def _prefill_px_impl(self, planes: Dict[str, torch.Tensor],
                         prefix_len: int, tokens: np.ndarray,
                         prompt_lens: np.ndarray, slots: np.ndarray) -> None:
        """Prefill N suffixes on top of a shared, already computed prefix:
        the prefix's K/V rows are copied into each row's private cache and
        only the suffix runs, written from ``prefix_len``. The private cache
        spans the prefix and the padded suffix; the splice stops at the
        grid's end (only the real tokens must fit, which ``submit``
        checked)."""
        N, P = tokens.shape
        dev = self.device
        width = prefix_len + P
        own = self._own_cache(N, width)
        for name, plane in own.items():
            plane[:, :, :prefix_len] = planes[name][:, :, :prefix_len]
        positions = prefix_len + torch.arange(P, device=dev)[None, :].expand(
            N, P)
        m = torch.arange(width, device=dev)[None, None, :]
        mask = m <= positions[:, :, None]
        lens = self._tensor(prompt_lens)
        out, own = llama.forward_cached(
            self.params, self._tensor(tokens), positions, own, prefix_len,
            mask, self.cfg, unembed_positions=lens - 1)
        self._finish_admit(own, out[:, 0], slots, prefix_len + prompt_lens)
        self._count(N * P, N, N * P * width, N * width)

    @torch.no_grad()
    def _prefill_extend_impl(self, rows: np.ndarray, feed: np.ndarray,
                             counts: np.ndarray, finals: np.ndarray) -> None:
        """Advance the chunked prefills of grid rows ``rows`` by
        ``counts`` (≤ C) tokens each (``feed`` [R, C]), over those rows
        only: the chunk forward reads their grid rows through
        ``grid_rows``, attends each row's written grid rows plus the causal
        chunk, and merges the new K/V at each row's depth. (The JAX package
        runs the chunk at full grid width so that one XLA executable serves
        every chunk.) With one row and ``C`` ≤ 256 every projection takes
        the int8 kernel.

        ``finals`` marks rows whose prompt completes here: their last real
        token's logits seed decoding and the row activates."""
        R, C = feed.shape
        dev = self.device
        L, _, M, Hkv, D = self.cache["k"].shape
        cdt = torch.bfloat16 if self.kv_quantized else self.cache["k"].dtype
        start = self._pos[rows]
        start_t, counts_t = self._tensor(start), self._tensor(counts)
        ar = torch.arange(C, device=dev)
        positions = start_t[:, None] + ar[None, :]
        gmask = (torch.arange(M, device=dev)[None, None, :]
                 < start_t[:, None, None]).expand(R, C, M)
        # causal within the chunk, clipped to each row's real tokens;
        # queries past the count attend real columns only (their outputs
        # are dropped, and their chunk columns are not merged)
        emask = ((ar[None, None, :] <= ar[None, :, None])
                 & (ar[None, None, :] < counts_t[:, None, None]))
        chunk = {name: torch.zeros((L, R, C, Hkv, D), dtype=cdt, device=dev)
                 for name in ("k", "v")}
        out, chunk = llama.forward_cached(
            self.params, self._tensor(feed), positions, self.cache, None,
            gmask, self.cfg, unembed_positions=(counts_t - 1).clamp(min=0),
            chunk=chunk, chunk_col=0, chunk_mask=emask,
            grid_rows=self._tensor(rows))
        llama.merge_chunk_into_grid(self.cache, chunk, start, counts, rows)
        if finals.any():
            self._logits[self._tensor(rows[finals])] = \
                out[self._tensor(np.flatnonzero(finals)), 0]
        self._pos[rows] += counts
        self._active[rows[finals]] = True
        self._count(R * C, R, R * C * (M + C), R * M)

    def _sample(self, logits: torch.Tensor,
                temps: torch.Tensor) -> torch.Tensor:
        """One draw per row: temper, then filter (the order of
        ``generate.sample_tokens``, so the nucleus is the tempered one's),
        then a Gumbel-max draw from the engine's generator."""
        lf = filter_logits(logits / temps.clamp(min=1e-6)[:, None],
                           self.top_k, self.top_p)
        u = torch.rand(lf.shape, generator=self._gen, device=lf.device)
        return (lf - torch.log(-torch.log(u))).argmax(-1)

    @torch.no_grad()
    def _decode_impl(self, n_steps: int) -> np.ndarray:
        """``n_steps`` tokens for every row, each at its own depth → the
        emitted [n_steps, B] block on the host.

        The grid is read-only during the chunk: step j's K/V land at
        column j of a small chunk cache, attention spans grid plus chunk
        (``llama._cached_attn_merged``), and the chunk merges into the grid
        once at the end: a per-row-offset write into every layer at every
        step would rewrite far more. Inactive rows (free, or mid-chunked-
        prefill) merge nothing and keep their depth, or a prefilling row's
        next chunk would land past its prompt.

        Per step: the repetition penalty over each row's window (which
        rolls inside the chunk, so a token emitted at step j is penalized
        at step j+1), then the greedy token, and for rows at temperature >
        0 a sampled one. Rows with no penalty and greedy rows skip that
        work when no active row needs it: a penalty of 1 and the discarded
        draw change no token.
        """
        dev = self.device
        L, B, M, Hkv, D = self.cache["k"].shape
        live = self._active
        sampling = bool((self._temps[live] > 0).any())
        penalized = bool((self._penalties[live] != 1.0).any())
        pos0 = self._tensor(self._pos)
        act = self._tensor(live)
        # grid rows < depth hold every earlier token; this chunk's rows
        # live in the chunk cache, so the grid mask is fixed for the chunk
        gmask = ((torch.arange(M, device=dev)[None, None, :]
                  < pos0[:, None, None]) & act[:, None, None])
        cdt = torch.bfloat16 if self.kv_quantized else self.cache["k"].dtype
        chunk = {name: torch.zeros((L, B, n_steps, Hkv, D), dtype=cdt,
                                   device=dev) for name in ("k", "v")}
        cols = torch.arange(n_steps, device=dev)
        if sampling:
            temps = self._tensor(self._temps)
        if penalized:
            pen = self._tensor(self._penalties)
            win = self._tensor(self._win)
        logits = self._logits
        toks = []
        for j in range(n_steps):
            if penalized:
                logits = _penalize(logits, win, pen)
            tok = logits.argmax(-1)
            if sampling:
                tok = torch.where(temps > 0, self._sample(logits, temps), tok)
            if penalized:
                win = torch.cat([win[:, 1:], tok[:, None]], dim=1)
            emask = (cols[None, None, :] <= j) & act[:, None, None]
            out, chunk = llama.forward_cached(
                self.params, tok[:, None], (pos0 + j)[:, None], self.cache,
                None, gmask, self.cfg, chunk=chunk, chunk_col=j,
                chunk_mask=emask)
            logits = out[:, 0]
            toks.append(tok)
        counts = np.where(live, n_steps, 0)
        llama.merge_chunk_into_grid(self.cache, chunk, self._pos, counts)
        # every step runs all rows over the whole grid
        self._count(B * n_steps, B * n_steps, B * n_steps * (M + n_steps),
                    B * M * n_steps, forwards=n_steps)
        self._logits = logits
        self._pos = self._pos + counts
        return torch.stack(toks).cpu().numpy()


class RollingDecoder:
    """Remote-facing decode driver: every method takes and returns plain
    JSON-able values, for a caller that drives the engine one chunk at a
    time over a call channel (the channel itself belongs to the
    pod-server path)."""

    def __init__(self, engine: RollingGenerator):
        self.engine = engine

    def submit(self, prompt, max_new_tokens: int = 128,
               temperature: float = 0.0,
               prefix_id: Optional[int] = None,
               stop: Optional[List[List[int]]] = None,
               repetition_penalty: float = 1.0,
               adapter_id: int = -1) -> int:
        return self.engine.submit(
            [int(t) for t in prompt], max_new_tokens=max_new_tokens,
            temperature=temperature, prefix_id=prefix_id, stop=stop,
            repetition_penalty=repetition_penalty, adapter_id=adapter_id)

    def register_prefix(self, tokens, adapter_id: int = -1) -> int:
        """Prefill a shared prefix once; the id goes back into
        :meth:`submit`'s ``prefix_id``."""
        return int(self.engine.register_prefix(
            [int(t) for t in tokens], adapter_id=int(adapter_id)))

    def drop_prefix(self, prefix_id: int) -> bool:
        return bool(self.engine.drop_prefix(int(prefix_id)))

    def step(self) -> Dict[str, Any]:
        """One engine step. Returns ``{"events": [[rid, tokens, done],
        ...], "pending": n, "device_ms": t}``; ``device_ms`` is the step's
        wall time in the engine's process (the step ends on the host's
        read of the chunk's tokens)."""
        import time as _time

        t0 = _time.perf_counter()
        events = self.engine.step()
        device_ms = (_time.perf_counter() - t0) * 1e3
        return {"events": [[rid, [int(t) for t in toks], bool(done)]
                           for rid, toks, done in events],
                "pending": self.engine.pending,
                "device_ms": round(device_ms, 3)}

    def pending(self) -> int:
        """Host bookkeeping only: no device sync."""
        return self.engine.pending

    def warmup(self, prompt_buckets=(16, 64, 128)) -> bool:
        self.engine.warmup(tuple(int(b) for b in prompt_buckets))
        return True

    def stats(self) -> Dict[str, Any]:
        """Host bookkeeping only: no device sync."""
        eng = self.engine
        return {"max_slots": eng.max_slots, "max_len": eng.max_len,
                "steps_per_call": eng.steps_per_call,
                "free_slots": eng.free_rows, "queued": eng.queued,
                "active": eng.active_rows,
                "prefilling": eng.prefilling_rows}


class RollingService:
    """Thread-safe facade: concurrent callers share one rolling batch.

    Every concurrent :meth:`generate` lands in the same continuous batch;
    one driver thread advances the engine while any request is pending.
    :meth:`close` stops and joins the driver.
    """

    def __init__(self, engine: RollingGenerator):
        import contextvars
        import threading

        self.engine = engine
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._results: Dict[int, List[int]] = {}
        self._done: Dict[int, bool] = {}
        self._live: Dict[int, Any] = {}  # rid -> token queue (generate_iter)
        self._stop = False
        # copy_context: driver-thread spans keep the submitter's ids
        self._driver = threading.Thread(
            target=contextvars.copy_context().run, args=(self._drive,),
            name="kt-rolling-driver", daemon=True)
        self._driver.start()

    def generate(self, prompt, max_new_tokens: int = 128,
                 temperature: float = 0.0, prefix_id: Optional[int] = None,
                 stop: Optional[List[List[int]]] = None,
                 timeout: Optional[float] = None,
                 adapter_id: int = -1) -> List[int]:
        """Submit and block until this request finishes; other callers'
        requests decode in the same chunks meanwhile."""
        import time as _time

        deadline = None if timeout is None else _time.time() + timeout
        with self._wake:
            rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                     temperature=temperature,
                                     prefix_id=prefix_id, stop=stop,
                                     adapter_id=adapter_id)
            self._results[rid] = []
            self._done[rid] = False
            self._wake.notify_all()
            while not self._done[rid]:
                rem = None if deadline is None else deadline - _time.time()
                if rem is not None and rem <= 0:
                    raise TimeoutError(f"request {rid} timed out")
                if self._stop:
                    raise RuntimeError("RollingService closed")
                self._wake.wait(timeout=rem if rem is not None else 1.0)
            self._done.pop(rid)
            return self._results.pop(rid)

    def generate_iter(self, prompt, max_new_tokens: int = 128,
                      temperature: float = 0.0,
                      prefix_id: Optional[int] = None,
                      stop: Optional[List[List[int]]] = None,
                      adapter_id: int = -1):
        """Yield tokens as decode chunks land."""
        import queue as _queue

        live: "_queue.SimpleQueue" = _queue.SimpleQueue()
        with self._wake:
            rid = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                     temperature=temperature,
                                     prefix_id=prefix_id, stop=stop,
                                     adapter_id=adapter_id)
            self._live[rid] = live
            self._wake.notify_all()
        while True:
            item = live.get()
            if item is None:
                return
            yield item

    def close(self) -> None:
        """Stop the driver thread and wait for it."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        self._driver.join(timeout=30.0)

    def _drive(self):
        while True:
            with self._wake:
                while not self._stop and not self.engine.pending:
                    self._wake.wait()
                if self._stop:
                    for live in self._live.values():
                        live.put(None)
                    return
                events = self.engine.step()
                for rid, toks, done in events:
                    live = self._live.get(rid)
                    if live is not None:
                        for tok in toks:
                            live.put(tok)
                        if done:
                            live.put(None)
                            del self._live[rid]
                        continue
                    self._results.setdefault(rid, []).extend(toks)
                    if done:
                        self._done[rid] = True
                if any(done for _, _, done in events):
                    self._wake.notify_all()
