"""Input pipeline: per-process sharded LM batches (port of ``host_shard``
and ``lm_batches`` from ``kubetorch_tpu/training/data.py``).

Numpy only, so the same seed gives the same batches as the JAX package.
The process index and count come from ``torch.distributed`` when it is
initialised, else 0 and 1. ``prefetch_to_device`` and ``pack_documents``
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch.distributed as dist


def _process() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(global_batch: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> tuple:
    """(start, size) of this process's slice of a global batch dimension."""
    pi, pc = _process()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pc} hosts")
    size = global_batch // pc
    return pi * size, size


def lm_batches(
    tokens: np.ndarray,                 # [n_tokens] int array / memmap
    global_batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of LM batches ``{"inputs", "targets"}`` (this
    process's shard only), sampled as random contiguous windows of
    ``seq_len + 1``; works straight off a ``np.memmap`` token file."""
    n = tokens.shape[0]
    if n < seq_len + 1:
        raise ValueError(f"corpus of {n} tokens < seq_len+1={seq_len + 1}")
    start, size = host_shard(global_batch, process_index, process_count)
    rng = np.random.default_rng(seed)
    while True:
        # every process draws the same global offsets, then takes its
        # slice: deterministic global batches with no coordination. Valid
        # window starts are [0, n - seq_len - 1].
        offsets = rng.integers(0, n - seq_len, (global_batch,))
        mine = offsets[start:start + size]
        window = np.stack([np.asarray(tokens[o:o + seq_len + 1])
                           for o in mine])
        yield {"inputs": window[:, :-1].astype(np.int32),
               "targets": window[:, 1:].astype(np.int32)}


__all__ = ["host_shard", "lm_batches"]
