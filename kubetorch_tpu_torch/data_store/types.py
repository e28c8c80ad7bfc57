"""Data-store wire constants (a copy of the part of
``kubetorch_tpu/data_store/types.py`` the array transfer uses)."""

from __future__ import annotations

# Wire codecs the packed-array blob format can frame leaves with
# (``data_store/codec.py``): lossless ``raw``/``zlib``/``zstd`` (zstd is
# an optional extra that degrades to zlib) and lossy ``int8`` per-row
# symmetric quantization for float leaves.
WIRE_CODECS = ("raw", "zlib", "zstd", "int8")

# Sidecar key suffix under which the store keeps the most recent delta
# patch for a blob (written on a delta publish, hidden from listings).
# Fetchers holding the previous version pull this instead of the full
# blob and splice locally.
BLOB_DELTA_SUFFIX = ".kt-delta"
