"""Data-store client over the local filesystem backend (port of the blob
half of ``kubetorch_tpu/data_store/client.py``).

The local backend keeps blobs under ``KT_LOCAL_STORE`` (default
``~/.ktpu/store``), with the same blob verbs as the JAX package's: whole
and streamed reads, whole writes, delta-patch writes spliced against the
stored blob, listing and deletes. What the engine path does not use
(object pickling, file-tree sync) is not ported. The HTTP backend waits
for the pod-server path (``ROADMAP.md`` Queue 1 item 2): with
``KT_STORE_URL`` set the client raises instead of writing where the caller
did not ask.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from kubetorch_tpu_torch.config import env_path, env_str
from kubetorch_tpu_torch.data_store.types import BLOB_DELTA_SUFFIX
from kubetorch_tpu_torch.exceptions import DataStoreError


def _safe_key(key: str) -> str:
    key = key.strip("/")
    if not key or ".." in key.split("/"):
        raise DataStoreError(f"invalid store key {key!r}")
    return key


def iter_file_chunks(path, chunk_bytes: Optional[int] = None):
    """Stream a local file as bytes chunks."""
    from kubetorch_tpu_torch.data_store.codec import default_chunk_bytes

    chunk_bytes = chunk_bytes or default_chunk_bytes()
    with open(path, "rb") as fh:
        while True:
            data = fh.read(chunk_bytes)
            if not data:
                return
            yield data


class DataStoreClient:
    """Facade over the store backend."""

    _default: Optional["DataStoreClient"] = None

    def __init__(self, store_url: Optional[str] = None):
        self.store_url = store_url

    @classmethod
    def default(cls) -> "DataStoreClient":
        url = env_str("KT_STORE_URL")
        if cls._default is None or cls._default.store_url != url:
            cls._default = cls(store_url=url)
        return cls._default

    def _backend(self) -> "LocalStoreBackend":
        if self.store_url:
            raise NotImplementedError(
                f"store {self.store_url!r} (KT_STORE_URL): the HTTP store "
                f"backend is not ported yet (ROADMAP.md Queue 1 item 2, the "
                f"pod-server path); unset KT_STORE_URL to use the local "
                f"store")
        return LocalStoreBackend()

    def list_keys(self, prefix: str = "") -> List[dict]:
        return self._backend().list_keys(prefix.strip("/"))

    def delete(self, key: str, recursive: bool = False) -> int:
        return self._backend().delete(_safe_key(key), recursive)


class LocalStoreBackend:
    """Filesystem store; metadata is the filesystem itself. The root is
    read from ``KT_LOCAL_STORE`` when the backend is made."""

    def __init__(self, root: Optional[Path] = None):
        self.root = root or env_path("KT_LOCAL_STORE")
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / _safe_key(key)

    def put_blob(self, key: str, blob: bytes) -> str:
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
        # a full put supersedes any recorded delta chain
        path.with_name(path.name + BLOB_DELTA_SUFFIX).unlink(
            missing_ok=True)
        return key

    def put_blob_delta(self, key: str, delta: bytes) -> str:
        """Splice a delta patch against the stored blob and keep the patch
        as the fetch sidecar; 409 when the base does not match."""
        from kubetorch_tpu_torch.data_store import codec as codec_mod

        path = self._path(key)
        if not path.is_file():
            raise DataStoreError(f"no blob {key!r} to delta against",
                                 status=409)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        try:
            codec_mod.splice_delta(delta, path, tmp)
        except codec_mod.DeltaMismatch as exc:
            tmp.unlink(missing_ok=True)
            raise DataStoreError(str(exc), status=409) from exc
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        # sidecar first, blob second: the reverse order crashing midway
        # would pair the new blob with the old patch
        side = path.with_name(path.name + BLOB_DELTA_SUFFIX)
        side_tmp = side.with_name(side.name + ".tmp")
        side_tmp.write_bytes(delta)
        os.replace(side_tmp, side)
        os.replace(tmp, path)
        return key

    def get_blob(self, key: str) -> bytes:
        path = self._path(key)
        if not path.exists() or path.is_dir():
            raise DataStoreError(f"no such key {key!r}")
        return path.read_bytes()

    def get_blob_stream(self, key: str, chunk_bytes: Optional[int] = None):
        """Chunked reads off disk."""
        path = self._path(key)
        if not path.exists() or path.is_dir():
            raise DataStoreError(f"no such key {key!r}")
        return iter_file_chunks(path, chunk_bytes)

    def list_keys(self, prefix: str = "") -> List[dict]:
        base = self.root / prefix if prefix else self.root
        if not base.exists():
            return []
        out = []
        for path in sorted(base.rglob("*")):
            if path.name.endswith(BLOB_DELTA_SUFFIX):
                continue  # internal delta-patch sidecar
            if path.is_file():
                stat = path.stat()
                out.append({"key": str(path.relative_to(self.root)),
                            "size": stat.st_size, "mtime": stat.st_mtime})
        return out

    def delete(self, key: str, recursive: bool = False) -> int:
        import shutil

        path = self._path(key)
        if not path.exists():
            return 0
        if path.is_dir():
            if not recursive:
                raise DataStoreError(
                    f"{key!r} is a prefix; pass recursive=True")
            count = sum(1 for p in path.rglob("*") if p.is_file())
            shutil.rmtree(path)
            return count
        path.unlink()
        path.with_name(path.name + BLOB_DELTA_SUFFIX).unlink(
            missing_ok=True)
        return 1
