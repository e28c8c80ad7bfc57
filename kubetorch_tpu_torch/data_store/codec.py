"""Blob wire codecs and delta publish for the packed-array format (port of
``kubetorch_tpu/data_store/codec.py``; the bytes on the wire are the JAX
package's).

- **Framed codecs**: every leaf payload is length-prefixed and encoded as
  ``raw`` (bytes as they are), ``zlib``/``zstd`` (lossless; ``zstd``
  falls back to ``zlib`` on encode when the optional ``zstandard`` module
  is absent, and decoding a zstd-framed leaf without it raises with the
  install hint) or ``int8`` (per-row symmetric quantization with float32
  scales; non-float, 1-D and 1-byte leaves stay raw). V1 blobs carry no
  codec; V2 headers name each leaf's.
- **Delta publish**: a publisher keeps a per-leaf digest manifest of its
  last published blob and sends only changed leaves as a byte patch
  (copy-from-base and data ops) that the store splices against its
  current blob. A patch names its base by header digest, so a mismatched
  base is never spliced.

Host leaves are CPU ``torch`` tensors (numpy has no bfloat16); a leaf's
dtype goes into the header under the name the JAX package writes
(``float32``, ``bfloat16``, ``int8``, ...). Headers are MessagePack,
written and read by :mod:`msgpack_lite`.
"""

from __future__ import annotations

import hashlib
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from kubetorch_tpu_torch.data_store import msgpack_lite
from kubetorch_tpu_torch.data_store.types import WIRE_CODECS

MAGIC_V1 = b"KTARRV1\x00"
MAGIC_V2 = b"KTARRV2\x00"
MAGIC_DELTA = b"KTARRD1\x00"

_SCALE_DTYPE = "float32"  # int8 codec per-row scale storage

# dtype names as the JAX package writes them (numpy's / ml_dtypes' names)
DTYPES: Dict[str, torch.dtype] = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"no wire name for dtype {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"blob carries dtype {name!r}, which the port "
                         f"does not read") from None


# ------------------------------------------------------------------ knobs
def default_chunk_bytes(fallback: int = 4 << 20) -> int:
    """The stream-granularity knob (``KT_STREAM_CHUNK_BYTES``) shared by
    the file streamers and the pipelined restore's ``chunk_bytes``."""
    from kubetorch_tpu_torch.config import env_int, env_set

    if env_set("KT_STREAM_CHUNK_BYTES"):
        return max(1 << 16, env_int("KT_STREAM_CHUNK_BYTES"))
    return fallback


def default_codec() -> str:
    """Wire codec when the caller doesn't pick one (``KT_WIRE_CODEC``)."""
    from kubetorch_tpu_torch.config import env_str

    return (env_str("KT_WIRE_CODEC") or "raw").strip().lower() or "raw"


def delta_enabled(explicit: Optional[bool] = None) -> bool:
    """Delta-publish/fetch default (``KT_WIRE_DELTA``); off unless asked."""
    if explicit is not None:
        return explicit
    from kubetorch_tpu_torch.config import env_bool

    return bool(env_bool("KT_WIRE_DELTA"))


def restore_cache_root() -> Path:
    """Where fetchers keep the last restored blob per key, the local
    splice base of delta fetches (``KT_RESTORE_CACHE``)."""
    from kubetorch_tpu_torch.config import env_path

    return env_path("KT_RESTORE_CACHE")


def _zstd():
    """The optional ``zstandard`` module, or None."""
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def resolve_codec(name: Optional[str]) -> str:
    """Normalize a requested codec: None → env default; ``zstd`` without
    ``zstandard`` degrades to ``zlib``; unknown names raise."""
    name = (name or default_codec()).strip().lower()
    if name == "zstd" and _zstd() is None:
        name = "zlib"
    if name not in WIRE_CODECS:
        raise ValueError(
            f"unknown wire codec {name!r} (choose from {WIRE_CODECS})")
    return name


# ------------------------------------------------------------ leaf codecs
def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


def leaf_codec(requested: str, t: torch.Tensor) -> str:
    """Per-leaf codec: ``int8`` only for >= 2-D float leaves of > 1-byte
    items; ints, bools, empty, 0-d and 1-D leaves stay lossless raw."""
    if requested == "int8":
        if (_is_float(t.dtype) and t.element_size() > 1
                and t.numel() > 0 and t.ndim >= 2):
            return "int8"
        return "raw"
    return requested


def leaf_meta(codec: str, t: torch.Tensor) -> Dict[str, Any]:
    meta: Dict[str, Any] = {"shape": list(t.shape),
                            "dtype": dtype_name(t.dtype), "codec": codec}
    if codec == "int8":
        meta["cols"] = int(t.shape[-1]) if t.ndim else 1
        meta["sdt"] = _SCALE_DTYPE
    return meta


def contig_bytes(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a contiguous uint8 numpy array."""
    if t.numel() == 0:
        return np.zeros(0, np.uint8)
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def leaf_digest(t: torch.Tensor) -> str:
    """Content digest of a host leaf's bytes (blake2b-64), the delta
    manifest's currency."""
    return hashlib.blake2b(contig_bytes(t), digest_size=8).hexdigest()


def _quantize_rows(t: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 with float32 scales over the last axis, in
    numpy on the float32 values (the JAX package's arithmetic, so the
    bytes agree)."""
    cols = int(t.shape[-1]) if t.ndim else 1
    f = t.contiguous().reshape(-1, cols).float().numpy()
    absmax = np.max(np.abs(f), axis=1)
    scale = (np.maximum(absmax, 1e-8) / 127.0).astype(np.float32)
    q = np.clip(np.rint(f / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def encode_leaf(codec: str, t: torch.Tensor) -> Tuple[List[Any], int]:
    """Encode one host leaf → (payload chunks, encoded byte count)."""
    if codec == "raw":
        mv = memoryview(contig_bytes(t))
        step = default_chunk_bytes(32 << 20)
        chunks = [mv[i:i + step] for i in range(0, len(mv), step)]
        return chunks, len(mv)
    if codec in ("zlib", "zstd"):
        data = contig_bytes(t).tobytes()
        zs = _zstd() if codec == "zstd" else None
        if zs is not None:
            payload = zs.ZstdCompressor(level=3).compress(data)
        else:
            # level 1 keeps encode faster than the link
            payload = zlib.compress(data, 1)
        return [payload], len(payload)
    if codec == "int8":
        q, scale = _quantize_rows(t)
        return [scale.tobytes(), q.tobytes()], scale.nbytes + q.nbytes
    raise ValueError(f"unknown leaf codec {codec!r}")


def encoded_size(codec: str, t: torch.Tensor) -> Optional[int]:
    """Encoded payload size when it is knowable without encoding (raw,
    int8); None for compressors."""
    if codec == "raw":
        return t.numel() * t.element_size()
    if codec == "int8":
        cols = int(t.shape[-1]) if t.ndim else 1
        rows = t.numel() // max(1, cols)
        return rows * 4 + t.numel()
    return None


def dequant(q: torch.Tensor, scale: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """int8 rows × their float32 scales → ``dtype``, on whatever device
    ``q`` and ``scale`` lie (the JAX package's jitted on-device dequant and
    its host fallback are the same arithmetic)."""
    cols = q.shape[-1] if q.ndim else 1
    f = q.reshape(-1, max(1, cols)).float() * scale[:, None]
    return f.to(dtype).reshape(q.shape)


class QuantLeaf:
    """An int8-coded leaf decoded to its small form: ``q`` (int8,
    leaf-shaped) and per-row ``scale`` (float32). The placement pipeline
    copies these to the card and dequantizes there; :meth:`dequant` is
    the host version."""

    __slots__ = ("q", "scale", "shape", "dtype", "cols")

    def __init__(self, q, scale, shape, dtype, cols):
        self.q = q
        self.scale = scale
        self.shape = shape
        self.dtype = dtype
        self.cols = cols

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()

    def dequant(self) -> torch.Tensor:
        return dequant(self.q, self.scale, self.dtype)


# -------------------------------------------------------------- decoders
def _byte_view(t: torch.Tensor) -> np.ndarray:
    """A writable uint8 numpy view of a fresh tensor's storage."""
    if t.numel() == 0:
        return np.zeros(0, np.uint8)
    return t.reshape(-1).view(torch.uint8).numpy()


class _RawDecoder:
    """Fills the preallocated leaf tensor in place."""

    timed = False

    def __init__(self, shape, dtype):
        self.arr = torch.empty(shape, dtype=dtype)
        self._buf = _byte_view(self.arr)
        self._off = 0
        self.buffered = len(self._buf)

    def feed(self, mv) -> None:
        n = len(mv)
        self._buf[self._off:self._off + n] = np.frombuffer(mv, np.uint8)
        self._off += n

    def finish(self):
        if self._off != len(self._buf):
            raise ValueError(
                f"leaf payload short: {self._off}/{len(self._buf)}")
        return self.arr


class _InflateDecoder:
    """Streaming decompress straight into the preallocated leaf."""

    timed = True

    def __init__(self, shape, dtype, codec: str):
        self.arr = torch.empty(shape, dtype=dtype)
        self._buf = _byte_view(self.arr)
        self._off = 0
        if codec == "zstd":
            zs = _zstd()
            if zs is None:
                raise ValueError(
                    "blob is zstd-framed but the optional 'zstandard' "
                    "module is absent — pip install kubetorch-tpu[zstd]")
            self._z = zs.ZstdDecompressor().decompressobj()
        else:
            self._z = zlib.decompressobj()
        self.buffered = len(self._buf)

    def feed(self, mv) -> None:
        out = self._z.decompress(bytes(mv))
        if out:
            n = len(out)
            if self._off + n > len(self._buf):
                raise ValueError("compressed leaf inflates past its shape")
            self._buf[self._off:self._off + n] = np.frombuffer(out, np.uint8)
            self._off += n

    def finish(self):
        self.feed(b"")
        if self._off != len(self._buf):
            raise ValueError(
                f"compressed leaf short: {self._off}/{len(self._buf)}")
        return self.arr


class _Int8Decoder:
    """Accumulates the [scales][q] payload; yields a host-dequantized
    tensor, or the small :class:`QuantLeaf` when the caller dequantizes
    on the card."""

    timed = True

    def __init__(self, shape, dtype, cols: int, device_dequant: bool):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.cols = max(1, int(cols))
        size = 1
        for d in self.shape:
            size *= d
        self._scale = torch.empty(size // self.cols, dtype=torch.float32)
        self._q = torch.empty(self.shape, dtype=torch.int8)
        self._sbuf = _byte_view(self._scale)
        self._qbuf = _byte_view(self._q)
        self._off = 0
        self._device = device_dequant
        self.buffered = len(self._sbuf) + len(self._qbuf)

    def feed(self, mv) -> None:
        off = 0
        ns = len(self._sbuf)
        while off < len(mv):
            if self._off < ns:
                take = min(ns - self._off, len(mv) - off)
                self._sbuf[self._off:self._off + take] = np.frombuffer(
                    mv[off:off + take], np.uint8)
            else:
                take = len(mv) - off
                qo = self._off - ns
                if qo + take > len(self._qbuf):
                    raise ValueError("int8 leaf payload overruns its shape")
                self._qbuf[qo:qo + take] = np.frombuffer(
                    mv[off:off + take], np.uint8)
            self._off += take
            off += take

    def finish(self):
        if self._off != len(self._sbuf) + len(self._qbuf):
            raise ValueError(
                f"int8 leaf short: {self._off}/"
                f"{len(self._sbuf) + len(self._qbuf)}")
        leaf = QuantLeaf(self._q, self._scale, self.shape, self.dtype,
                         self.cols)
        return leaf if self._device else leaf.dequant()


def make_decoder(spec: Dict[str, Any], dtype: torch.dtype,
                 device_dequant: bool = False):
    """Decoder for one V2 leaf spec."""
    codec = spec.get("codec", "raw")
    shape = tuple(spec["shape"])
    if codec == "raw":
        return _RawDecoder(shape, dtype)
    if codec in ("zlib", "zstd"):
        return _InflateDecoder(shape, dtype, codec)
    if codec == "int8":
        return _Int8Decoder(shape, dtype, spec.get("cols", 1),
                            device_dequant)
    raise ValueError(f"blob carries unknown leaf codec {codec!r}")


# ------------------------------------------------------- V1/V2 headers
def build_header_v1(treedef_str: str, host_leaves) -> bytes:
    """The V1 (no codec) header: tree spec, then each leaf's shape and
    dtype name."""
    head = msgpack_lite.packb({
        "treedef": treedef_str,
        "leaves": [{"shape": list(t.shape), "dtype": dtype_name(t.dtype)}
                   for t in host_leaves]})
    return MAGIC_V1 + len(head).to_bytes(8, "little") + head


def build_header(treedef_str: str, metas: List[Dict[str, Any]],
                 codec: str, digests: Optional[List[str]] = None) -> bytes:
    header: Dict[str, Any] = {"treedef": treedef_str, "codec": codec,
                              "leaves": metas}
    if digests is not None:
        header["digests"] = digests
    head = msgpack_lite.packb(header)
    return MAGIC_V2 + len(head).to_bytes(8, "little") + head


def parse_header(data) -> Tuple[Dict[str, Any], int]:
    """(header dict, body offset) from a V1 or V2 blob prefix."""
    mv = memoryview(data)
    if bytes(mv[:len(MAGIC_V2)]) not in (MAGIC_V1, MAGIC_V2):
        raise ValueError("not a packed-array buffer")
    base = len(MAGIC_V2) + 8
    head_len = int.from_bytes(mv[len(MAGIC_V2):base], "little")
    return msgpack_lite.unpackb(mv[base:base + head_len]), base + head_len


def pack_stream(treedef_str: str, host_leaves, codecs: List[str],
                digests: Optional[List[str]] = None,
                record: Optional[Dict[str, Any]] = None,
                codec_name: str = "raw") -> Iterable[bytes]:
    """Generator of V2 wire chunks: header, then per-leaf ``u64 enc |
    payload`` frames. ``record`` (reset per invocation) captures the
    publish manifest the next delta publish needs."""
    metas = [leaf_meta(c, t) for c, t in zip(codecs, host_leaves)]
    header = build_header(treedef_str, metas, codec_name, digests)
    if record is not None:
        record.clear()
        record.update(header=header, frames=[], encode_s=0.0,
                      hdr_digest=hashlib.blake2b(
                          header, digest_size=8).hexdigest())
    yield header
    off = len(header)
    encode_total = 0.0
    for codec, t in zip(codecs, host_leaves):
        t0 = time.perf_counter()
        chunks, enc = encode_leaf(codec, t)
        enc_s = time.perf_counter() - t0
        yield enc.to_bytes(8, "little")
        yield from chunks
        if codec != "raw":
            encode_total += enc_s
            if record is not None:
                record["encode_s"] += enc_s
        if record is not None:
            record["frames"].append((off, 8 + enc))
        off += 8 + enc
    if record is not None:
        record["total"] = off
    if encode_total > 0.0:
        from kubetorch_tpu_torch.observability import tracing

        tracing.record_span("codec.encode", encode_total,
                            attrs={"codec": codec_name,
                                   "leaves": len(host_leaves),
                                   "bytes": off})


def packed_size(host_leaves, codecs: List[str],
                header_len: int) -> Optional[int]:
    """Exact V2 blob size when every codec is size-deterministic
    (raw/int8), else None."""
    total = header_len
    for codec, t in zip(codecs, host_leaves):
        enc = encoded_size(codec, t)
        if enc is None:
            return None
        total += 8 + enc
    return total


# ----------------------------------------------------------------- delta
class DeltaMismatch(ValueError):
    """The patch's named base is not the blob we hold."""


def build_delta(prev: Dict[str, Any], treedef_str: str, host_leaves,
                codecs: List[str], digests: List[str]
                ) -> Optional[Tuple[bytes, Dict[str, Any], Dict[str, Any]]]:
    """Byte-level patch re-sending only changed leaves (span-recorded).

    ``prev`` is the manifest :func:`pack_stream` recorded for the last
    published version. Returns ``(delta_bytes, new_manifest, stats)``, or
    None when nothing can be skipped or most bytes changed (a full
    streamed publish is then cheaper)."""
    t0 = time.perf_counter()
    out = _build_delta(prev, treedef_str, host_leaves, codecs, digests)
    from kubetorch_tpu_torch.observability import tracing

    tracing.record_span("codec.build_delta", time.perf_counter() - t0,
                        attrs={"built": out is not None})
    return out


def _build_delta(prev, treedef_str, host_leaves, codecs, digests):
    n = len(host_leaves)
    if (len(prev.get("digests", ())) != n
            or len(prev.get("frames", ())) != n
            or len(prev.get("metas", ())) != n):
        return None
    metas = [leaf_meta(c, t) for c, t in zip(codecs, host_leaves)]
    # unchanged = same bytes AND same shape/dtype/codec (a reshaped leaf
    # with identical bytes must re-send: its base frame has the old layout)
    unchanged = {i for i in range(n)
                 if digests[i] == prev["digests"][i]
                 and metas[i] == prev["metas"][i]}
    if not unchanged:
        return None
    changed_est = sum(encoded_size(codecs[i], host_leaves[i])
                      or host_leaves[i].numel() * host_leaves[i].element_size()
                      for i in range(n) if i not in unchanged)
    if changed_est > max(1, prev.get("total", 0)) * 0.5:
        return None
    header = build_header(treedef_str, metas, prev.get("codec", "raw"),
                          digests)
    ops: List[List[int]] = [[0, len(header)]]
    data: List[bytes] = [header]
    frames: List[Tuple[int, int]] = []
    off = len(header)
    sent = 0
    encode_s = 0.0
    for i, (codec, t) in enumerate(zip(codecs, host_leaves)):
        if i in unchanged:
            poff, plen = prev["frames"][i]
            last = ops[-1]
            if last[0] == 1 and last[1] + last[2] == poff:
                last[2] += plen
            else:
                ops.append([1, poff, plen])
            framed = plen
        else:
            t0 = time.perf_counter()
            chunks, enc = encode_leaf(codec, t)
            encode_s += time.perf_counter() - t0
            blob = enc.to_bytes(8, "little") + b"".join(
                bytes(c) for c in chunks)
            last = ops[-1]
            if last[0] == 0:
                last[1] += len(blob)
            else:
                ops.append([0, len(blob)])
            data.append(blob)
            sent += 1
            framed = len(blob)
        frames.append((off, framed))
        off += framed
    plan = {"base_hdr_digest": prev["hdr_digest"],
            "base_len": prev["total"], "new_len": off, "ops": ops,
            "leaves_total": n, "leaves_sent": sent}
    plan_b = msgpack_lite.packb(plan)
    delta = (MAGIC_DELTA + len(plan_b).to_bytes(8, "little") + plan_b
             + b"".join(data))
    manifest = {"hdr_digest": hashlib.blake2b(
                    header, digest_size=8).hexdigest(),
                "total": off, "digests": digests, "codecs": codecs,
                "metas": metas, "frames": frames,
                "codec": prev.get("codec", "raw")}
    stats = {"leaves_total": n, "leaves_sent": sent,
             "leaves_skipped": n - sent, "wire_bytes": len(delta),
             "full_bytes": off, "encode_s": encode_s}
    return delta, manifest, stats


def parse_delta_plan(data) -> Tuple[Dict[str, Any], int]:
    """(plan dict, data-section offset) from a delta blob prefix."""
    mv = memoryview(data)
    if bytes(mv[:len(MAGIC_DELTA)]) != MAGIC_DELTA:
        raise ValueError("not a delta patch")
    base = len(MAGIC_DELTA) + 8
    plan_len = int.from_bytes(mv[len(MAGIC_DELTA):base], "little")
    return (msgpack_lite.unpackb(mv[base:base + plan_len]),
            base + plan_len)


def blob_header_digest(path) -> Optional[str]:
    """Digest over a stored blob's header prefix (magic + length + header),
    the identity a delta patch names its base by; None for other files."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(8)
            if magic not in (MAGIC_V2, MAGIC_V1):
                return None
            raw_len = fh.read(8)
            head_len = int.from_bytes(raw_len, "little")
            if len(raw_len) != 8 or head_len > (512 << 20):
                return None
            head = fh.read(head_len)
            if len(head) != head_len:
                return None
    except OSError:
        return None
    return hashlib.blake2b(magic + raw_len + head,
                           digest_size=8).hexdigest()


def splice_delta(delta, base_path, out_path) -> Dict[str, Any]:
    """Apply a delta patch to ``base_path``, writing the full new blob at
    ``out_path``; returns the plan. Raises :class:`DeltaMismatch` when the
    base is not the one the patch names, ValueError on a corrupt patch."""
    if isinstance(delta, (str, Path)):
        delta = Path(delta).read_bytes()
    mv = memoryview(delta)
    plan, data_off = parse_delta_plan(mv)
    base_path = Path(base_path)
    try:
        base_len = base_path.stat().st_size
    except OSError:
        raise DeltaMismatch(f"delta base missing: {base_path}") from None
    if base_len != plan["base_len"]:
        raise DeltaMismatch(
            f"delta base is {base_len} bytes, patch expects "
            f"{plan['base_len']}")
    have = blob_header_digest(base_path)
    if have != plan["base_hdr_digest"]:
        raise DeltaMismatch(
            f"delta base header digest {have} != patch's "
            f"{plan['base_hdr_digest']}")
    pos = data_off
    with open(base_path, "rb") as bf, open(out_path, "wb") as of:
        for op in plan["ops"]:
            if op[0] == 0:
                n = op[1]
                if pos + n > len(mv):
                    raise ValueError("delta data section short")
                of.write(mv[pos:pos + n])
                pos += n
            elif op[0] == 1:
                off, n = op[1], op[2]
                if off + n > base_len:
                    raise ValueError("delta copy op past base end")
                bf.seek(off)
                left = n
                while left:
                    chunk = bf.read(min(left, default_chunk_bytes()))
                    if not chunk:
                        raise ValueError("short read splicing base")
                    of.write(chunk)
                    left -= len(chunk)
            else:
                raise ValueError(f"unknown delta op {op!r}")
    out_len = Path(out_path).stat().st_size
    if out_len != plan["new_len"]:
        raise ValueError(
            f"splice produced {out_len} bytes, plan says {plan['new_len']}")
    return plan
