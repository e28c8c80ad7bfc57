"""int8-weight decode matmul: ``out = (x @ w_q) * scale`` (port of
``kubetorch_tpu/ops/quant_matmul.py``).

On a CUDA tensor :func:`int8_matmul` launches the hand-written W8A16 kernel
in ``csrc/int8_matmul.cu`` (a producer warp streams weight and activation
tiles by TMA into a shared-memory ring; consumer warps dequantize the
weights into tensor-core products with float32 accumulation; K splits
summed in a fixed order inside a thread-block cluster); on a CPU tensor it
takes
:func:`int8_matmul_plain`, the same function in plain PyTorch.

Unlike the JAX package, the kernel is the default for int8 decode: there,
a Pallas custom call forced each layer's slice of the scanned stacked weight
to be copied out first, so the kernel sat behind an opt-in. Here
``w[li]`` of a stacked ``[L, K, N]`` tensor is a contiguous view and nothing
is copied.

Numerics: ``(x @ bf16(w_q)) * scale`` with float32 accumulation, cast to
``x.dtype`` — associativity-equal to ``x @ (w_q * scale)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from kubetorch_tpu_torch.ops import _build

_BN, _BK, _KSTEP = 128, 64, 16   # the kernel's column tile, stage rows, k-step
_MAX_SPLITS = 8       # K splits of a tile share one (portable) cluster
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 product of x and the int8 weights, then the
    per-column scale, cast to ``x.dtype``."""
    acc = x.float() @ w_q.float()
    return (acc * scale.reshape(1, -1).float()).to(x.dtype)


def _batch_chunk(b: int) -> int:
    """Batch rows per block: 8, 16 or 32 (the kernel's NT = 1, 2, 4)."""
    return 8 if b <= 8 else 16 if b <= 16 else 32


def _blocks_per_sm(b: int) -> int:
    """Blocks the partition plans for on one SM: two up to 16 batch rows
    (three fit at 8: the headroom lets clusters of 8 find room on every
    GPC in one wave), one above (a 32-row chunk takes more registers and a
    deeper ring)."""
    return 2 if b <= 16 else 1


def pick_splits(b: int, k: int, n: int, sms: int) -> Tuple[int, int]:
    """(K splits, K rows per split): as many splits as keep every block of
    the grid resident at once on ``sms`` SMs, at most 8 (one portable
    cluster) and at most one per 64-row stage; each split a whole number of
    stages and none empty."""
    tiles = -(-b // _batch_chunk(b)) * -(-n // _BN)
    want = max(1, min(sms * _blocks_per_sm(b) // tiles, -(-k // _BK),
                      _MAX_SPLITS))
    per = -(-k // want)
    per = -(-per // _BK) * _BK
    return -(-k // per), per


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ (w_q * scale)`` with the dequant fused into the weight stream.

    x: [B, K] bf16 or f32; w_q: [K, N] int8, N contiguous; scale: [N] or
    [1, N], bf16 or f32. Returns [B, N] in ``x.dtype``.
    """
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} "
                         "must be 2-D")
    B, K = x.shape
    Kw, N = w_q.shape
    if Kw != K:
        raise ValueError(f"x K={K} vs w K={Kw}")
    if scale.numel() != N:
        raise ValueError(f"scale has {scale.numel()} entries for N={N}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    return _launch(x, w_q, scale.reshape(-1))


int8_matmul.launches = 0


def _launch(x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, "
                             f"x on {x.device}")
    if x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul kernel takes bf16/f32 x and scale, "
                        f"got {x.dtype} and {scale.dtype}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int8_matmul kernel needs contiguous x, w_q, scale")
    B, K = x.shape
    N = w_q.shape[1]
    if N % _BN or K % _KSTEP or w_q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"int8_matmul kernel needs N % {_BN} == 0, "
                         f"K % {_KSTEP} == 0 and 16-byte aligned x and "
                         f"weights (K={K}, N={N})")
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    splits, per = pick_splits(B, K, N, _sm_count(x.device.index))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kt_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, K, N, splits, per, _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype],
        stream)
    _build.check(lib, err, "int8_matmul")
    int8_matmul.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    fn = lib.kt_int8_matmul
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a c_int would cut them
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
    return lib


def decode_matmul_viable(x: torch.Tensor, w: torch.Tensor,
                         scale: Optional[torch.Tensor]) -> bool:
    """The kernel path's gate, kept from the JAX package: int8 weights, a
    scale present, and a decode-shaped activation of at most 256 tokens
    (above that the product is compute-bound and prefill dequantizes into
    a plain matmul instead)."""
    if scale is None or w.dtype != torch.int8:
        return False
    tokens = 1
    for d in x.shape[:-1]:
        tokens *= d
    return tokens <= 256
