"""Flash attention (port of ``kubetorch_tpu/ops/flash_attention.py``).

Forward: on a CUDA tensor :func:`flash_forward` launches the hand-written
kernel in ``csrc/flash_fwd.cu`` (tensor-core online softmax, causal tiles
above the diagonal skipped, GQA through ``h // group``, optional per-row
logsumexp); on a CPU tensor it takes :func:`flash_forward_plain`.

Backward: :func:`flash_backward` launches the two kernels of
``csrc/flash_bwd.cu`` (``dq``, and ``dk``/``dv`` with the GQA group summed
in one pass) on a CUDA tensor and takes :func:`flash_backward_plain` on a
CPU tensor; ``delta = rowsum(dO * O)`` is computed outside the kernels
(:func:`flash_bwd_delta`), as the JAX package computes it in XLA, and a
caller may pass its own. :func:`flash_attention` differentiates through
:class:`_FlashFunction`, which saves ``(q, k, v, out, lse)`` and returns
``(dq, dk, dv)``.

All read the model's ``[B, S, H, D]`` layout through TMA tensor maps built
from the strides, so there is no transpose copy. They take bf16 with
``D == 128`` and S, T multiples of 64 (the forward tiles 128 rows by 128
keys, dk/dv 128 keys by 64 queries, dq 128 rows by 64 keys; a half tile at
the end is zero-filled and masked or left to an idle warpgroup); the
``block_q``/``block_k`` arguments keep the JAX package's tileability rule
(:func:`flash_tileable`), so that the same shapes take the same path in
both packages.
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
    JAX package's ``_flash_forward``; not differentiable itself (the
    gradient goes through :func:`flash_attention`)."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_forward_plain(q, k, v, scale=scale, causal=causal)
        return out, (lse if with_lse else None)
    return _launch(q, k, v, scale, causal, with_lse)


flash_forward.launches = 0


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want [B,S,Hq,D] and "
                         "[B,T,Hkv,D] twice")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "do not match")


def _check_kernel_inputs(what, q, k, v, *more):
    """What every flash kernel takes: CUDA bf16 q/k/v (and dO), D == 128,
    S and T multiples of the tile, a contiguous head dim and 16-byte
    aligned rows."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    named = (("q", q), ("k", k), ("v", v)) + tuple(more)
    if any(t.device != q.device for _, t in named):
        raise ValueError(f"{what}: inputs on different devices")
    if any(t.dtype != torch.bfloat16 for _, t in named):
        raise TypeError(f"{what} kernel takes bf16, got "
                        + "/".join(str(t.dtype) for _, t in named))
    B, S, Hq, D = q.shape
    T = k.shape[1]
    if D != _HEAD_DIM or S % _TILE or T % _TILE:
        raise ValueError(f"{what} kernel needs D == {_HEAD_DIM} and "
                         f"S, T multiples of {_TILE} (D={D}, S={S}, T={T})")
    for name, t in named:
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel needs {name} with a contiguous head "
                f"dim, 16-byte aligned rows (strides {t.stride()})")


def _launch(q, k, v, scale, causal, with_lse):
    _check_kernel_inputs("flash_forward", q, k, v)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
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


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def flash_bwd_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta[b, h, s] = rowsum(dO · O)`` in f32, ``[B, Hq, S]`` (the JAX
    package's 8-lane stats layout is dropped, as for lse). Loop-invariant
    over KV chunks: ring attention computes it once per backward."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         g: torch.Tensor, *, scale: float, causal: bool,
                         delta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the FlashAttention-2 backward over materialized f32
    scores. q/g/out [B,S,Hq,D], k/v [B,T,Hkv,D], lse/delta [B,Hq,S] f32 →
    (dq, dk, dv) in the inputs' dtypes."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if delta is None:
        delta = flash_bwd_delta(g, out)
    qg = q.reshape(B, S, Hkv, G, D).float()
    gg = g.reshape(B, S, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - lse.reshape(B, Hkv, G, S)[..., None])
    dp = torch.einsum("bskgd,btkd->bkgst", gg, vf)
    ds = p * (dp - delta.reshape(B, Hkv, G, S)[..., None]) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(B, S, Hq, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    dv = torch.einsum("bkgst,bskgd->btkd", p, gg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                   scale: float, causal: bool,
                   delta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq [B,S,Hq,D], dk, dv [B,T,Hkv,D]): the counterpart of the JAX
    package's ``_flash_backward``. ``delta`` ([B,Hq,S] f32) defaults to
    :func:`flash_bwd_delta` of ``g`` and ``out``."""
    _check_qkv(q, k, v)
    B, S, Hq, _ = q.shape
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(g.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and tuple(t.shape) != (B, Hq, S):
            raise ValueError(f"{name} {tuple(t.shape)}: want [B, Hq, S] = "
                             f"{(B, Hq, S)}")
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g, scale=scale,
                                    causal=causal, delta=delta)
    return _launch_bwd(q, k, v, out, lse, g, scale, causal, delta)


flash_backward.dq_launches = 0
flash_backward.dkv_launches = 0


def _launch_bwd(q, k, v, out, lse, g, scale, causal, delta):
    _check_kernel_inputs("flash_backward", q, k, v, ("dO", g))
    if delta is None:
        delta = flash_bwd_delta(g, out)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_backward kernel needs {name} as a "
                             "contiguous, 16-byte aligned f32 tensor on "
                             f"{q.device} (got {t.dtype} on {t.device})")
    return (_bwd_dq(q, k, v, g, lse, delta, scale, causal),
            *_bwd_dkv(q, k, v, g, lse, delta, scale, causal))


def _bwd_args(q, k, v, g, lse, delta):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    shape_strides = (B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
                     *v.stride()[:3], *g.stride()[:3])
    return ins, shape_strides


def _bwd_dq(q, k, v, g, lse, delta, scale, causal):
    """Launch the dq kernel on inputs :func:`_launch_bwd` has checked."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _bwd_lib()
    ins, shape_strides = _bwd_args(q, k, v, g, lse, delta)
    err = lib.kt_flash_bwd_dq(*ins, dq.data_ptr(), *shape_strides,
                              float(scale), int(causal),
                              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_backward (dq)")
    flash_backward.dq_launches += 1
    return dq


def _bwd_dkv(q, k, v, g, lse, delta, scale, causal):
    """Launch the dk/dv kernel on inputs :func:`_launch_bwd` has checked."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    lib = _bwd_lib()
    ins, shape_strides = _bwd_args(q, k, v, g, lse, delta)
    err = lib.kt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                               *shape_strides, float(scale), int(causal),
                               torch.cuda.current_stream(q.device)
                               .cuda_stream)
    _build.check(lib, err, "flash_backward (dk/dv)")
    flash_backward.dkv_launches += 1
    return dk, dv


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    if lib.kt_flash_bwd_dq.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i] * 6 + [ll] * 12 + [ctypes.c_float, i, p]
        lib.kt_flash_bwd_dq.argtypes = [p] * 7 + tail
        lib.kt_flash_bwd_dkv.argtypes = [p] * 8 + tail
        lib.kt_flash_bwd_dq.restype = lib.kt_flash_bwd_dkv.restype = i
    return lib


class _FlashFunction(torch.autograd.Function):
    """Flash attention with its backward on the backward kernels (the
    counterpart of the JAX package's ``jax.custom_vjp`` ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_forward(q, k, v, scale=scale, causal=causal,
                                 with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


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

    Shapes that do not tile (``flash_tileable``) take the plain attention
    path, as in the JAX package. On the card, tileable shapes that the
    kernels do not take yet (f32, D ≠ 128, S or T not a multiple of 64)
    raise the kernel's error: that coverage is owed (``ROADMAP.md`` Queue
    2), not routed around. Under autograd the forward keeps its lse and the
    backward runs :func:`flash_backward`.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if not flash_tileable(q.shape, k.shape, block_q, block_k):
        return dot_product_attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFunction.apply(q, k, v, scale, causal)
    return flash_forward(q, k, v, scale=scale, causal=causal,
                         with_lse=False)[0]


__all__ = ["flash_attention", "flash_attention_with_lse", "flash_forward",
           "flash_forward_plain", "flash_backward", "flash_backward_plain",
           "flash_bwd_delta", "flash_tileable", "auto_block_q",
           "auto_block_k"]
