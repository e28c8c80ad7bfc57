"""The typed errors the port's store, KV pool and engine raise or catch (a
copy of those classes in ``kubetorch_tpu/exceptions.py``)."""

from __future__ import annotations

from typing import Dict, Optional


class KubetorchError(Exception):
    """Base class for all framework errors."""


class DataStoreError(KubetorchError):
    """Data store operation failed (missing key, no source, etc.).

    ``status`` carries the HTTP-style status of the failure (409 when a
    delta patch's base does not match), so callers can tell a recoverable
    base mismatch from a real error."""

    def __init__(self, message: str, status: "int | None" = None):
        super().__init__(message)
        self.status = status


class DeadlineExceeded(KubetorchError):
    """The program's deadline passed before (or while) the work ran.
    ``deadline`` is the unix timestamp that passed."""

    def __init__(self, message: str = "call deadline exceeded",
                 deadline: Optional[float] = None):
        super().__init__(message)
        self.deadline = deadline


class ServerOverloaded(KubetorchError):
    """Admission control shed this program; ``retry_after`` is the
    server-computed number of seconds to wait (the program never ran, so
    a retry is safe)."""

    def __init__(self, message: str = "server overloaded",
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


class KVGeometryMismatch(KubetorchError):
    """An exported row names a grid geometry (block size, ``max_len``,
    LoRA slot-axis width) that the importing engine does not match.
    Splicing anyway would write corrupt state, so the import refuses,
    naming both geometries and the mismatched ``axis``."""

    def __init__(self, message: str, axis: str = "",
                 exported: Optional[Dict[str, int]] = None,
                 importer: Optional[Dict[str, int]] = None):
        super().__init__(message)
        self.axis = axis
        self.exported = exported or {}
        self.importer = importer or {}
