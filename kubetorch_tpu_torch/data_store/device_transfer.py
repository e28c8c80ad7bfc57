"""Tensor-tree transfer through the data store, host-staged (port of
``kubetorch_tpu/data_store/device_transfer.py`` for torch tensors).

A tree (nested dicts, lists and tuples) of tensors is fetched to the host,
packed into one buffer (header = MessagePack tree spec + each leaf's shape
and dtype name, then the leaves' bytes), moved through the store, and
placed back on a device. The blob format is the JAX package's, byte for
byte: a tree packed here unpacks there and the other way round. Leaves
are flattened in the JAX package's order (dict keys sorted) and the tree
spec is written as JAX prints it (``PyTreeDef({'a': *, ...})``). A
``torch.bfloat16`` leaf travels as its raw 2-byte payload under the dtype
name ``bfloat16``, as an ml_dtypes leaf does. numpy leaves are accepted
too; unpacked leaves come back as CPU tensors, or on ``device``.

Placement onto a CUDA device runs on a background thread as pinned
host-to-device copies on a side stream, overlapping the next leaves'
fetch; int8-coded leaves cross as their small ``(q, scale)`` form and
dequantize on the card (:func:`codec.dequant`).
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from kubetorch_tpu_torch.data_store import codec as codec_mod
from kubetorch_tpu_torch.data_store.client import (DataStoreClient,
                                                   iter_file_chunks)
from kubetorch_tpu_torch.data_store.types import BLOB_DELTA_SUFFIX
from kubetorch_tpu_torch.exceptions import DataStoreError
from kubetorch_tpu_torch.observability import tracing

# Decomposition of the most recent get_arrays restore / put_arrays
# publish in this process (overwritten by each).
_LAST_RESTORE: Dict[str, float] = {}
_LAST_PUBLISH: Dict[str, float] = {}

# key → manifest of the last published blob (header digest, per-leaf
# digests/codecs/frame offsets): what a delta publish diffs against.
# Process-local: a manifest the store disagrees with costs one 409 and a
# full re-publish.
_PUBLISH_MANIFESTS: Dict[str, dict] = {}


def last_restore_stats() -> Dict[str, float]:
    """Decomposition of the most recent restore: wall/fetch/place seconds,
    bytes (wire vs decoded), decode/dequant seconds, leaves, and the
    fetch/placement overlap ratio."""
    return dict(_LAST_RESTORE)


def last_publish_stats() -> Dict[str, float]:
    """Decomposition of the most recent publish: wire vs raw bytes,
    encode seconds, and (for delta publishes) leaves skipped."""
    return dict(_LAST_PUBLISH)


# ------------------------------------------------------------------ trees
def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves in the JAX package's order, the tree spec as JAX prints
    it). ``None`` is an empty subtree, as in JAX."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """Rebuild ``template``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def as_host_tensor(x: Any) -> torch.Tensor:
    """A CPU tensor of ``x``: a tensor (any device), a numpy array
    (an ml_dtypes bfloat16 array as ``torch.bfloat16``) or a scalar."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def device_get_chunked(leaves, chunk_bytes: int = 256 << 20
                       ) -> List[torch.Tensor]:
    """Device→host fetch of many tensors in O(total/chunk) copies instead
    of O(leaves): same-dtype leaves on one card are concatenated on the
    card (a device-memory copy) up to ``chunk_bytes`` and fetched in one
    transfer each."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    groups: Dict[tuple, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            groups.setdefault((leaf.dtype, leaf.device), []).append(i)
        else:
            out[i] = as_host_tensor(leaf)

    def flush(batch):
        if len(batch) == 1:
            out[batch[0]] = leaves[batch[0]].detach().cpu()
        elif batch:
            host = torch.cat([leaves[i].detach().reshape(-1)
                              for i in batch]).cpu()
            off = 0
            for i in batch:
                n = leaves[i].numel()
                out[i] = host[off:off + n].reshape(leaves[i].shape)
                off += n

    for idxs in groups.values():
        batch, size = [], 0
        for i in idxs:
            nbytes = leaves[i].numel() * leaves[i].element_size()
            if batch and size + nbytes > chunk_bytes:
                flush(batch)
                batch, size = [], 0
            batch.append(i)
            size += nbytes
        flush(batch)
    return out


def _host_leaves(tree: Any) -> Tuple[List[torch.Tensor], str]:
    leaves, treedef = tree_flatten(tree)
    return device_get_chunked(leaves), treedef


# ------------------------------------------------------------ pack/unpack
def pack_arrays(tree: Any, codec: Optional[str] = None) -> bytes:
    """Pack a tree of tensors into one buffer. ``codec`` (None →
    ``KT_WIRE_CODEC`` → ``raw``): ``raw`` emits the V1 format, any other
    codec the framed V2 format."""
    return b"".join(bytes(c) for c in iter_packed(tree, codec=codec))


def iter_packed(tree: Any, chunk: int = 8 << 20,
                codec: Optional[str] = None):
    """Yield the packed form in chunks without one giant buffer."""
    codec = codec_mod.resolve_codec(codec)
    host_leaves, treedef = _host_leaves(tree)
    if codec == "raw":
        yield codec_mod.build_header_v1(treedef, host_leaves)
        yield from _iter_leaf_bytes(host_leaves, chunk)
        return
    codecs = [codec_mod.leaf_codec(codec, t) for t in host_leaves]
    yield from codec_mod.pack_stream(treedef, host_leaves, codecs,
                                     codec_name=codec)


def _iter_leaf_bytes(host_leaves, chunk: int = 32 << 20):
    """Zero-copy memoryview chunks over the leaves' raw bytes."""
    for t in host_leaves:
        mv = memoryview(codec_mod.contig_bytes(t))
        for i in range(0, len(mv), chunk):
            yield mv[i:i + chunk]


def unpack_arrays(data, template: Optional[Any] = None) -> Any:
    """Unpack a V1 or V2 blob to CPU tensors (each owning its memory);
    structure from ``template`` when given, else a flat list."""
    unpacker = StreamUnpacker()
    leaves: List[Any] = []
    for _ix, t in unpacker.feed(data):
        leaves.append(t)
    unpacker.finish()
    if template is not None:
        return tree_unflatten(template, leaves)
    return leaves


class StreamUnpacker:
    """Incremental parser for the packed-array wire format.

    Feed it chunks as they arrive; it hands back ``(leaf_index, tensor)``
    for each leaf whose last byte arrived. Bytes are copied straight into
    each leaf's own buffer, so peak buffering is O(header + chunk +
    current leaf) and the whole blob is never held. Speaks V1 and V2;
    ``device_dequant=True`` hands int8-coded leaves back as
    :class:`~kubetorch_tpu_torch.data_store.codec.QuantLeaf` so placement
    can ship the small form and dequantize on the card.
    """

    def __init__(self, device_dequant: bool = False):
        self._pending = bytearray()   # unparsed bytes before the header ends
        self.header: Optional[dict] = None
        self._v2 = False
        self._device_dequant = device_dequant
        self._leafspecs: List[Tuple[dict, torch.dtype]] = []
        self._leaf_ix = 0
        self._prefix = bytearray()    # partial u64 frame-length prefix (V2)
        self._dec = None              # active leaf decoder
        self._dec_left = 0
        self.bytes_fed = 0
        self.peak_buffered = 0
        self.decode_s = 0.0           # time in non-raw codec decoders
        self.raw_bytes = 0            # decoded (pre-codec) payload total

    @property
    def num_leaves(self) -> Optional[int]:
        return None if self.header is None else len(self._leafspecs)

    @property
    def complete(self) -> bool:
        return (self.header is not None
                and self._leaf_ix >= len(self._leafspecs)
                and self._dec is None and not self._prefix
                and not self._pending)

    def _note_buffered(self):
        cur = self._dec.buffered if self._dec is not None else 0
        self.peak_buffered = max(self.peak_buffered,
                                 len(self._pending) + cur)

    def _parse_header(self) -> bool:
        magic_n = len(codec_mod.MAGIC_V1)
        base = magic_n + 8
        if len(self._pending) < magic_n:
            return False
        magic = bytes(self._pending[:magic_n])
        if magic not in (codec_mod.MAGIC_V1, codec_mod.MAGIC_V2):
            raise ValueError("not a packed-array stream")
        if len(self._pending) < base:
            return False
        head_len = int.from_bytes(self._pending[magic_n:base], "little")
        if len(self._pending) < base + head_len:
            return False
        self.header, _ = codec_mod.parse_header(
            bytes(self._pending[:base + head_len]))
        self._v2 = magic == codec_mod.MAGIC_V2
        for spec in self.header["leaves"]:
            dtype = codec_mod.torch_dtype(spec["dtype"])
            count = 1
            for d in spec["shape"]:
                count *= d
            self.raw_bytes += count * torch.empty(
                (), dtype=dtype).element_size()
            self._leafspecs.append((spec, dtype))
        del self._pending[:base + head_len]
        return True

    def _open_leaf(self, out: List[Tuple[int, Any]]) -> None:
        """V1: start the next leaf's raw decoder (frames carry no length
        prefix); zero-byte leaves complete at once."""
        while self._dec is None and self._leaf_ix < len(self._leafspecs):
            spec, dtype = self._leafspecs[self._leaf_ix]
            self._dec = codec_mod.make_decoder({"shape": spec["shape"]},
                                               dtype)
            self._dec_left = self._dec.buffered
            if self._dec_left == 0:
                out.append(self._finish_leaf())

    def feed(self, data) -> List[Tuple[int, Any]]:
        """Consume one chunk; return the ``(leaf_index, leaf)`` pairs that
        completed inside it."""
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        self.bytes_fed += len(mv)
        out: List[Tuple[int, Any]] = []
        if self.header is None:
            self._pending += mv
            self._note_buffered()
            if not self._parse_header():
                return out
            if not self._v2:
                self._open_leaf(out)
            # the header's tail may carry leaf bytes
            mv = memoryview(bytes(self._pending))
            self._pending.clear()
        off = 0
        n = len(self._leafspecs)
        while off < len(mv):
            if self._dec is None:
                if self._leaf_ix >= n:
                    raise ValueError(
                        f"stream carries {len(mv) - off} bytes past the "
                        f"declared leaves")
                if not self._v2:
                    self._open_leaf(out)
                    continue
                take = min(8 - len(self._prefix), len(mv) - off)
                self._prefix += mv[off:off + take]
                off += take
                if len(self._prefix) < 8:
                    return out
                enc = int.from_bytes(self._prefix, "little")
                self._prefix.clear()
                spec, dtype = self._leafspecs[self._leaf_ix]
                self._dec = codec_mod.make_decoder(
                    spec, dtype, self._device_dequant)
                if spec.get("codec", "raw") == "raw" and \
                        enc != self._dec.buffered:
                    raise ValueError(
                        f"raw leaf frame {enc} bytes != shape's "
                        f"{self._dec.buffered}")
                self._dec_left = enc
                self._note_buffered()
                if enc == 0:
                    out.append(self._finish_leaf())
                continue
            take = min(self._dec_left, len(mv) - off)
            t0 = time.perf_counter()
            self._dec.feed(mv[off:off + take])
            if self._dec.timed:
                self.decode_s += time.perf_counter() - t0
            off += take
            self._dec_left -= take
            if self._dec_left == 0:
                out.append(self._finish_leaf())
                if not self._v2:
                    self._open_leaf(out)
        return out

    def _finish_leaf(self) -> Tuple[int, Any]:
        t0 = time.perf_counter()
        item = self._dec.finish()
        if self._dec.timed:
            self.decode_s += time.perf_counter() - t0
        ix = self._leaf_ix
        self._leaf_ix += 1
        self._dec = None
        return ix, item

    def finish(self) -> None:
        """Raise unless every declared leaf arrived in full."""
        if self.header is None:
            raise ValueError("stream ended before the header completed")
        if (self._dec is not None or self._prefix
                or self._leaf_ix < len(self._leafspecs)):
            raise ValueError(
                f"stream ended at leaf {self._leaf_ix}/"
                f"{len(self._leafspecs)} (short read)")


def iter_unpack_arrays(chunks: Iterable) -> Iterable[Tuple[int, Any]]:
    """Streaming twin of :func:`unpack_arrays`: yield ``(leaf_index,
    tensor)`` as each leaf's bytes arrive; raises on a short stream."""
    unpacker = StreamUnpacker()
    for chunk in chunks:
        yield from unpacker.feed(chunk)
    unpacker.finish()


# ---------------------------------------------------------------- publish
def _record_publish(stats: Dict[str, float]) -> None:
    _LAST_PUBLISH.clear()
    _LAST_PUBLISH.update(stats)


def put_arrays(key: str, tree: Any, codec: Optional[str] = None,
               delta: Optional[bool] = None) -> str:
    """Publish a tree of tensors under ``key``.

    ``codec`` (None → ``KT_WIRE_CODEC`` → ``raw``): ``raw`` ships the V1
    format; ``zlib``/``zstd`` compress losslessly; ``int8`` quantizes
    float leaves per row. ``delta`` (None → ``KT_WIRE_DELTA`` → off)
    keeps per-leaf digests of the last publish of ``key`` and ships only
    changed leaves as a patch the store splices; a store without the
    expected base (404/409) degrades to a full publish."""
    codec = codec_mod.resolve_codec(codec)
    delta = codec_mod.delta_enabled(delta)
    backend = DataStoreClient.default()._backend()
    with tracing.span("store.put_arrays",
                      attrs={"key": key, "codec": codec,
                             "delta": bool(delta)}):
        return _put_arrays(key, tree, codec, delta, backend)


def _put_arrays(key: str, tree: Any, codec: str, delta: bool,
                backend) -> str:
    t_start = time.perf_counter()
    host_leaves, treedef = _host_leaves(tree)
    raw_bytes = sum(t.numel() * t.element_size() for t in host_leaves)

    if codec == "raw" and not delta:
        # the V1 path; an untracked publish breaks any delta chain
        _PUBLISH_MANIFESTS.pop(key, None)
        header = codec_mod.build_header_v1(treedef, host_leaves)
        backend.put_blob(key, b"".join(
            [header] + [bytes(c) for c in _iter_leaf_bytes(host_leaves)]))
        _record_publish({
            "wall_s": time.perf_counter() - t_start,
            "wire_bytes": len(header) + raw_bytes, "raw_bytes": raw_bytes,
            "encode_s": 0.0, "leaves": len(host_leaves),
            "leaves_sent": len(host_leaves), "leaves_skipped": 0,
            "delta": 0.0, "codec": 0.0})
        return key

    codecs = [codec_mod.leaf_codec(codec, t) for t in host_leaves]
    digests = ([codec_mod.leaf_digest(t) for t in host_leaves]
               if delta else None)
    delta_fallback = 0.0
    prev = _PUBLISH_MANIFESTS.get(key) if delta else None
    if prev is not None and prev.get("treedef") == treedef:
        built = codec_mod.build_delta(prev, treedef, host_leaves, codecs,
                                      digests)
        if built is not None:
            delta_blob, manifest, stats = built
            try:
                backend.put_blob_delta(key, delta_blob)
            except DataStoreError as exc:
                # base drifted under us: a full publish heals the chain
                if getattr(exc, "status", None) not in (404, 409):
                    raise
                delta_fallback = 1.0
            else:
                manifest["treedef"] = treedef
                _PUBLISH_MANIFESTS[key] = manifest
                _record_publish({
                    "wall_s": time.perf_counter() - t_start,
                    "wire_bytes": stats["wire_bytes"],
                    "raw_bytes": raw_bytes,
                    "encode_s": stats["encode_s"],
                    "leaves": stats["leaves_total"],
                    "leaves_sent": stats["leaves_sent"],
                    "leaves_skipped": stats["leaves_skipped"],
                    "delta": 1.0, "codec": 1.0})
                return key

    record: Dict[str, Any] = {}
    backend.put_blob(key, b"".join(
        bytes(c) for c in codec_mod.pack_stream(
            treedef, host_leaves, codecs, digests=digests, record=record,
            codec_name=codec)))
    if delta:
        _PUBLISH_MANIFESTS[key] = {
            "hdr_digest": record["hdr_digest"], "total": record["total"],
            "digests": digests, "codecs": codecs,
            "metas": [codec_mod.leaf_meta(c, t)
                      for c, t in zip(codecs, host_leaves)],
            "frames": record["frames"], "codec": codec,
            "treedef": treedef}
    _record_publish({
        "wall_s": time.perf_counter() - t_start,
        "wire_bytes": record.get("total", 0), "raw_bytes": raw_bytes,
        "encode_s": record.get("encode_s", 0.0),
        "leaves": len(host_leaves), "leaves_sent": len(host_leaves),
        "leaves_skipped": 0, "delta": 0.0,
        "delta_fallback": delta_fallback, "codec": 1.0})
    return key


# ---------------------------------------------------------------- restore
class _PlacementPipeline:
    """Background host→device placement for the streaming restore.

    The fetch loop enqueues batches of completed host leaves; this thread
    pins them and copies them to the card on its own stream (int8-coded
    leaves as ``(q, scale)``, dequantized there), then waits for the
    stream so the host buffers can go. The bounded queue double-buffers:
    one batch crosses to the card while the next fills from the store.
    """

    def __init__(self, out: List, device: torch.device, depth: int = 2):
        self.out = out
        self.device = device
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.error: Optional[BaseException] = None
        self.place_s = 0.0
        self.dequant_s = 0.0
        self.leaves_placed = 0
        self.bytes_placed = 0
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(
            target=lambda: ctx.run(self._run),
            name="kt-restore-place", daemon=True)
        self._thread.start()

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self):
        stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.default_stream(self.device)
        while True:
            item = self.queue.get()
            if item is None:
                return
            if self.error is not None:
                continue  # drain so the producer never blocks forever
            idxs, arrays = item
            t0 = time.perf_counter()
            wall0 = time.time()
            dequant_d = 0.0
            try:
                with torch.cuda.stream(stream):
                    placed = []
                    for leaf in arrays:
                        if isinstance(leaf, codec_mod.QuantLeaf):
                            q, s = self._copy(leaf.q), self._copy(leaf.scale)
                            t1 = time.perf_counter()
                            placed.append(codec_mod.dequant(q, s,
                                                            leaf.dtype))
                            dequant_d += time.perf_counter() - t1
                        else:
                            placed.append(self._copy(leaf))
                stream.synchronize()
                # the tensors are read on the default stream from here on
                for t in placed:
                    t.record_stream(consumer)
            except BaseException as exc:  # surfaced in close()/submit()
                self.error = exc
                continue
            batch_s = time.perf_counter() - t0
            self.place_s += batch_s
            self.dequant_s += dequant_d
            nbytes = sum(a.nbytes if isinstance(a, codec_mod.QuantLeaf)
                         else a.numel() * a.element_size() for a in arrays)
            tracing.record_span("restore.device_put", batch_s, start=wall0,
                                attrs={"leaves": len(idxs),
                                       "bytes": nbytes})
            for i, t in zip(idxs, placed):
                self.out[i] = t
            self.leaves_placed += len(idxs)
            self.bytes_placed += nbytes

    def submit(self, idxs: List[int], arrays: List) -> None:
        if self.error is not None:
            raise self.error
        self.queue.put((idxs, arrays))

    def close(self) -> None:
        self.queue.put(None)
        self._thread.join()
        if self.error is not None:
            raise self.error


def _streamed_restore(chunks: Iterable, template: Optional[Any],
                      device: Optional[torch.device],
                      batch_bytes: int = 64 << 20,
                      pipeline_depth: int = 2,
                      wire_bytes: Optional[int] = None,
                      pre_fetch_s: float = 0.0,
                      delta_hit: Optional[bool] = None) -> Any:
    """Assemble leaves from a chunk stream and place them as they land:
    completed leaves batch up to ``batch_bytes`` and go to the placement
    thread while the stream fills the next batch. Without a CUDA
    ``device`` the leaves stay host tensors (moved with ``.to`` when a
    CPU device is named)."""
    t_start = time.perf_counter()
    on_card = device is not None and device.type == "cuda"
    unpacker = StreamUnpacker(device_dequant=on_card)
    out: List[Any] = []
    pipeline: Optional[_PlacementPipeline] = None
    batch: Tuple[List[int], List[Any]] = ([], [])
    batch_n = 0
    fetch_s = 0.0
    bytes_streamed = 0

    def on_leaf(ix: int, leaf) -> None:
        nonlocal pipeline, batch, batch_n
        if not on_card:
            out[ix] = leaf if device is None else leaf.to(device)
            return
        if pipeline is None:
            pipeline = _PlacementPipeline(out, device, depth=pipeline_depth)
        batch[0].append(ix)
        batch[1].append(leaf)
        batch_n += (leaf.nbytes if isinstance(leaf, codec_mod.QuantLeaf)
                    else leaf.numel() * leaf.element_size())
        if batch_n >= batch_bytes:
            pipeline.submit(*batch)
            batch, batch_n = ([], []), 0

    try:
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            try:
                chunk = next(it)
            except StopIteration:
                fetch_s += time.perf_counter() - t0
                break
            fetch_s += time.perf_counter() - t0
            bytes_streamed += len(chunk)
            completed = unpacker.feed(chunk)
            if not out and unpacker.header is not None:
                out = [None] * unpacker.num_leaves
            for ix, leaf in completed:
                on_leaf(ix, leaf)
        unpacker.finish()
        if batch[0]:
            pipeline.submit(*batch)
    except BaseException:
        if pipeline is not None:
            try:
                pipeline.close()
            # ktlint: disable=KT004 -- the original error is the one to surface
            except BaseException:
                pass
        raise
    place_s = dequant_s = 0.0
    if pipeline is not None:
        pipeline.close()
        place_s, dequant_s = pipeline.place_s, pipeline.dequant_s
    wall_s = time.perf_counter() - t_start
    tracing.record_span("restore.fetch", fetch_s, start=time.time() - wall_s,
                        attrs={"bytes": bytes_streamed,
                               "leaves": unpacker.num_leaves or 0})
    if unpacker.decode_s > 0.0:
        tracing.record_span("restore.decode", unpacker.decode_s,
                            attrs={"raw_bytes": unpacker.raw_bytes})
    # share of placement hidden under the fetch: 1.0 = fully overlapped
    hidden = fetch_s + place_s - wall_s
    overlap = max(0.0, min(1.0, hidden / place_s)) if place_s > 1e-9 else 1.0
    _LAST_RESTORE.clear()
    _LAST_RESTORE.update({
        "wall_s": wall_s + pre_fetch_s, "fetch_s": fetch_s + pre_fetch_s,
        "place_s": place_s, "bytes_streamed": bytes_streamed,
        "wire_bytes": bytes_streamed if wire_bytes is None else wire_bytes,
        "raw_bytes": unpacker.raw_bytes,
        "codec_decode_s": unpacker.decode_s, "dequant_s": dequant_s,
        "leaves": len(out),
        "leaves_placed": pipeline.leaves_placed if pipeline else 0,
        "overlap_ratio": round(overlap, 4),
        "peak_buffered_bytes": unpacker.peak_buffered,
        "streaming": 1.0,
    })
    if delta_hit is not None:
        _LAST_RESTORE["delta_hit"] = 1.0 if delta_hit else 0.0
    if template is not None:
        return tree_unflatten(template, out)
    return out


def _tmp_tag() -> str:
    """Unique per call: concurrent fetches of one key must not share a
    tmp file."""
    import uuid

    return f"{os.getpid()}-{uuid.uuid4().hex[:8]}"


def _try_delta_splice(backend, key: str):
    """Fetch-side delta: if the store's patch sidecar names the blob in
    the restore cache as its base, pull the patch and splice the full
    blob into the cache → ``(cache_path, wire_bytes)``, else None (the
    caller fetches in full)."""
    cache = codec_mod.restore_cache_root() / key
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    if not cache.is_file():
        return None
    try:
        buf = backend.get_blob(key + BLOB_DELTA_SUFFIX)
        plan, _ = codec_mod.parse_delta_plan(buf)
    except (DataStoreError, OSError, ValueError):
        return None  # no sidecar (full put) or corrupt
    data_bytes = sum(op[1] for op in plan["ops"] if op[0] == 0)
    if (data_bytes > plan["new_len"] * 0.5
            or cache.stat().st_size != plan["base_len"]
            or codec_mod.blob_header_digest(cache)
            != plan["base_hdr_digest"]):
        return None
    tmp = cache.with_name(f".{cache.name}.{_tmp_tag()}.tmp")
    try:
        codec_mod.splice_delta(buf, cache, tmp)
        os.replace(tmp, cache)
    except (codec_mod.DeltaMismatch, ValueError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return cache, len(buf)


def _tee_to_cache(chunks: Iterable, cache: Path):
    """Pass chunks through while writing them to the restore cache (tmp +
    atomic publish on completion), so the next fetch can splice."""
    tmp = cache.with_name(f".{cache.name}.{_tmp_tag()}.tmp")
    try:
        fh = open(tmp, "wb")
    except OSError:
        yield from chunks  # unwritable cache: the restore still works
        return
    try:
        for chunk in chunks:
            fh.write(chunk)
            yield chunk
    except BaseException:
        fh.close()
        tmp.unlink(missing_ok=True)
        raise
    fh.close()
    os.replace(tmp, cache)


def get_arrays(key: str, template: Optional[Any] = None,
               device: Union[str, torch.device, None] = None, *,
               streaming: Optional[bool] = None,
               chunk_bytes: Optional[int] = None,
               batch_bytes: int = 64 << 20, pipeline_depth: int = 2,
               delta: Optional[bool] = None) -> Any:
    """Fetch a tree published by :func:`put_arrays` (or by the JAX
    package's). ``device`` (the port's stand-in for JAX shardings: one
    device for every leaf) places each leaf there; None returns CPU
    tensors. Structure from ``template`` when given, else a flat list.

    The restore streams (``streaming=None`` picks it when the backend can
    stream): leaves assemble from ``chunk_bytes`` reads and, on a CUDA
    device, go to the placement thread in batches of up to
    ``batch_bytes``, so fetch and host→device copies overlap. ``delta``
    (None → ``KT_WIRE_DELTA`` → off): keep the last restored blob per key
    in the restore cache and, when the store's patch sidecar names it as
    the base, fetch only the patch."""
    dev = torch.device(device) if device is not None else None
    with tracing.span("store.get_arrays",
                      attrs={"key": key, "device": str(dev)}):
        return _get_arrays(key, template, dev, streaming=streaming,
                           chunk_bytes=chunk_bytes, batch_bytes=batch_bytes,
                           pipeline_depth=pipeline_depth, delta=delta)


def _get_arrays(key, template, device, *, streaming, chunk_bytes,
                batch_bytes, pipeline_depth, delta):
    chunk_bytes = chunk_bytes or codec_mod.default_chunk_bytes(8 << 20)
    delta = codec_mod.delta_enabled(delta)
    backend = DataStoreClient.default()._backend()
    local_path = None
    wire_bytes: Optional[int] = None
    delta_hit: Optional[bool] = None
    pre_fetch_s = 0.0
    if delta:
        t0 = time.perf_counter()
        spliced = _try_delta_splice(backend, key)
        pre_fetch_s = time.perf_counter() - t0
        if spliced is not None:
            local_path, wire_bytes = spliced
            delta_hit = True
        else:
            delta_hit = False   # miss: full fetch, teed into the cache
    if streaming is None:
        streaming = (local_path is not None
                     or hasattr(backend, "get_blob_stream"))
    if streaming:
        if local_path is not None:
            chunks = iter_file_chunks(local_path, chunk_bytes)
        else:
            chunks = backend.get_blob_stream(key, chunk_bytes=chunk_bytes)
            if delta:
                chunks = _tee_to_cache(
                    chunks, codec_mod.restore_cache_root() / key)
        return _streamed_restore(chunks, template, device,
                                 batch_bytes=batch_bytes,
                                 pipeline_depth=pipeline_depth,
                                 wire_bytes=wire_bytes,
                                 pre_fetch_s=pre_fetch_s,
                                 delta_hit=delta_hit)
    t0 = time.perf_counter()
    if local_path is not None:
        blob = local_path.read_bytes()
    else:
        blob = backend.get_blob(key)
        wire_bytes = len(blob)
        if delta:
            cache = codec_mod.restore_cache_root() / key
            tmp = cache.with_name(f".{cache.name}.{_tmp_tag()}.tmp")
            try:
                cache.parent.mkdir(parents=True, exist_ok=True)
                tmp.write_bytes(blob)
                os.replace(tmp, cache)
            except OSError:
                tmp.unlink(missing_ok=True)
    fetch_s = pre_fetch_s + time.perf_counter() - t0
    leaves = unpack_arrays(blob)
    t1 = time.perf_counter()
    if device is not None:
        leaves = [t.to(device) for t in leaves]
    place_s = time.perf_counter() - t1
    _LAST_RESTORE.clear()
    _LAST_RESTORE.update({
        "wall_s": fetch_s + place_s, "fetch_s": fetch_s,
        "place_s": place_s, "bytes_streamed": len(blob),
        "wire_bytes": len(blob) if wire_bytes is None else wire_bytes,
        "leaves": len(leaves),
        "leaves_placed": len(leaves) if device is not None else 0,
        "overlap_ratio": 0.0, "streaming": 0.0,
    })
    if delta_hit is not None:
        _LAST_RESTORE["delta_hit"] = 1.0 if delta_hit else 0.0
    if template is not None:
        return tree_unflatten(template, leaves)
    return leaves
