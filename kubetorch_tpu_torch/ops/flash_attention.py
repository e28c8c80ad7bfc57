"""Flash-attention forward (port of the forward half of
``kubetorch_tpu/ops/flash_attention.py``).

On a CUDA tensor :func:`flash_forward` launches the hand-written kernel in
``csrc/flash_fwd.cu`` (tensor-core online softmax, causal tiles above the
diagonal skipped, GQA through ``h // group``, optional per-row logsumexp);
on a CPU tensor it takes :func:`flash_forward_plain`. Both read the model's
``[B, S, H, D]`` layout: the kernel goes through the strides, so there is
no transpose copy.

The kernel takes bf16 with ``D == 128`` and tiles 64 query rows by 64 keys;
the ``block_q``/``block_k`` arguments keep the JAX package's tileability
rule (:func:`flash_tileable`), so that the same shapes take the same path
in both packages. Forward only: the backward kernels come with training.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from kubetorch_tpu_torch.ops import _build
from kubetorch_tpu_torch.ops.attention import dot_product_attention

_TILE = 64        # the kernel's query and key tile
_HEAD_DIM = 128   # the only head dim the kernel takes


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: softmax attention in float32 over materialized scores.
    q [B,S,Hq,D], k/v [B,T,Hkv,D] → (out [B,S,Hq,D] in q.dtype,
    lse [B,Hq,S] f32)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = s.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s, dim=-1)                      # [B,Hkv,G,S]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return (out.reshape(B, S, Hq, D).to(q.dtype),
            lse.reshape(B, Hq, S))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool, with_lse: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out [B,S,Hq,D], lse [B,Hq,S] f32 or None). The counterpart of the
    JAX package's ``_flash_forward``; forward only."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward is not ported yet (training slice)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want [B,S,Hq,D] and "
                         "[B,T,Hkv,D] twice")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "do not match")
    if q.device.type == "cpu":
        out, lse = flash_forward_plain(q, k, v, scale=scale, causal=causal)
        return out, (lse if with_lse else None)
    return _launch(q, k, v, scale, causal, with_lse)


flash_forward.launches = 0


def _launch(q, k, v, scale, causal, with_lse):
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_forward: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_forward kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D != _HEAD_DIM or S % _TILE or T % _TILE:
        raise ValueError(f"flash_forward kernel needs D == {_HEAD_DIM} and "
                         f"S, T multiples of {_TILE} (D={D}, S={S}, T={T})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_forward kernel needs {name} with a contiguous head "
                f"dim, 16-byte aligned rows (strides {t.stride()})")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal), stream)
    _build.check(lib, err, "flash_forward")
    flash_forward.launches += 1
    return out, lse


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    fn = lib.kt_flash_fwd
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a c_int would cut them
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 6 + [ll] * 9
                       + [ctypes.c_float, i, p])
        fn.restype = i
    return lib


def auto_block_k(T: int, requested: Optional[int] = None) -> int:
    """KV block of the tileability rule: 1024 when it divides T, else 512,
    else at most 512 (kept from the JAX package)."""
    if requested is not None:
        return min(requested, T)
    if T >= 1024 and T % 1024 == 0:
        return 1024
    if T >= 512 and T % 512 == 0:
        return 512
    return min(512, T)


def auto_block_q(S: int, requested: Optional[int] = None) -> int:
    """Query block of the tileability rule (same ladder as for KV)."""
    if requested is not None:
        return min(requested, S)
    if S >= 1024 and S % 1024 == 0:
        return 1024
    if S >= 512 and S % 512 == 0:
        return 512
    return min(512, S)


def flash_tileable(q_shape, k_shape, block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> bool:
    """True when [B,S,H,D] / [B,T,Hkv,D] shapes fit the tiling rule."""
    B, S, Hq, D = q_shape
    T, Hkv = k_shape[1], k_shape[2]
    bq, bk = auto_block_q(S, block_q), auto_block_k(T, block_k)
    return (S % bq == 0 and T % bk == 0 and D % 128 == 0
            and Hq % Hkv == 0 and bq % 8 == 0 and bk % 8 == 0)


def flash_attention_with_lse(
    q: torch.Tensor,                 # [B, S, Hq, D] — must be tileable
    k: torch.Tensor,                 # [B, T, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward flash returning (out [B,S,H,D], lse [B,H,S] f32)."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if not flash_tileable(q.shape, k.shape, block_q, block_k):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         "do not tile")
    return flash_forward(q, k, v, scale=scale, causal=causal, with_lse=True)


def flash_attention(
    q: torch.Tensor,                 # [B, S, Hq, D]
    k: torch.Tensor,                 # [B, T, Hkv, D]
    v: torch.Tensor,                 # [B, T, Hkv, D]
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention in the model's [B, S, H, D] layout.

    Shapes that do not tile take the plain attention path, as in the JAX
    package — callers never need to special-case.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if not flash_tileable(q.shape, k.shape, block_q, block_k):
        return dot_product_attention(q, k, v, causal=causal, scale=scale)
    return flash_forward(q, k, v, scale=scale, causal=causal,
                         with_lse=False)[0]


__all__ = ["flash_attention", "flash_attention_with_lse", "flash_forward",
           "flash_forward_plain", "flash_tileable", "auto_block_q",
           "auto_block_k"]
