"""``KT_*`` knob reads for the port (a copy of the part of
``kubetorch_tpu/config.py`` that the store, the KV pool and the engine
use).

Only the knobs the copied modules read are declared, each with the JAX
package's name and default, and read through the same accessors:

- an unset or empty variable means the declared default;
- a set but malformed value raises :class:`ConfigError` naming it;
- reading an undeclared name raises :class:`ConfigError`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional


class ConfigError(Exception):
    """A ``KT_*`` environment variable is undeclared or holds a value that
    cannot be parsed as its declared type."""


# name -> (type, default), as declared in kubetorch_tpu/config.py
KNOBS: Dict[str, tuple] = {
    # serving admission
    "KT_MAX_QUEUE_DELAY_S": ("float", 30.0),
    # serving engine
    "KT_ENGINE_ADMIT_ROWS": ("int", 0),
    "KT_ENGINE_MAX_WAITING": ("int", 512),
    "KT_ENGINE_POLL_S": ("float", 0.02),
    "KT_ENGINE_STALL_S": ("float", 120.0),
    # engine KV manager
    "KT_KV_BLOCK_TOKENS": ("int", 16),
    "KT_KV_HBM_BUDGET": ("int", 0),
    "KT_KV_PREFIX_SPLIT": ("str", "off"),
    "KT_KV_OFFLOAD_CODEC": ("str", "auto"),
    "KT_KV_SESSION_PREFIX": ("str", "kv/sessions"),
    "KT_KV_SESSION_DELTA": ("bool", True),
    # disaggregated serving (only "mixed" is ported)
    "KT_DISAGG_PHASE": ("str", "mixed"),
    # tracing and the flight recorder
    "KT_TRACE_DISABLE": ("bool", False),
    "KT_TRACE_RING": ("int", 4096),
    "KT_TRACE_PROC": ("str", "client"),
    "KT_SERVICE_NAME": ("str", ""),
    "KT_POD_NAME": ("str", None),
    "KT_FLIGHT_RING": ("int", 2048),
    "KT_FLIGHT_DISABLE": ("bool", False),
    # data store
    "KT_STORE_URL": ("str", None),
    "KT_LOCAL_STORE": ("str", "~/.ktpu/store"),
    "KT_STREAM_CHUNK_BYTES": ("int", 4 << 20),
    "KT_WIRE_CODEC": ("str", "raw"),
    "KT_WIRE_DELTA": ("bool", False),
    "KT_RESTORE_CACHE": ("str", "~/.ktpu/restore_cache"),
}


def _raw(name: str) -> Optional[str]:
    """Registered-knob env read; unset and empty both mean 'default'."""
    if name not in KNOBS:
        raise ConfigError(
            f"{name} is not a registered KT_* knob of the port; declare it "
            f"in kubetorch_tpu_torch/config.py before reading it")
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    return raw


def _default(name: str) -> Any:
    return KNOBS[name][1]


def env_str(name: str) -> Optional[str]:
    raw = _raw(name)
    return _default(name) if raw is None else raw


def env_int(name: str) -> Optional[int]:
    raw = _raw(name)
    if raw is None:
        return _default(name)
    try:
        return int(raw.strip())
    except ValueError:
        raise ConfigError(
            f"{name}={raw!r} is not a valid integer "
            f"(default: {_default(name)!r})") from None


def env_float(name: str) -> Optional[float]:
    raw = _raw(name)
    if raw is None:
        return _default(name)
    try:
        return float(raw.strip())
    except ValueError:
        raise ConfigError(
            f"{name}={raw!r} is not a valid number "
            f"(default: {_default(name)!r})") from None


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def env_bool(name: str) -> Optional[bool]:
    raw = _raw(name)
    if raw is None:
        return _default(name)
    low = raw.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ConfigError(
        f"{name}={raw!r} is not a valid boolean "
        f"(use one of {_TRUTHY + _FALSY})")


def env_path(name: str) -> Optional[Path]:
    """``env_str`` + ``Path(...).expanduser()`` (None stays None)."""
    value = env_str(name)
    return None if value is None else Path(value).expanduser()


def env_set(name: str) -> bool:
    """True when the (registered) variable is set to a non-empty value."""
    return _raw(name) is not None
