"""Fused chunked softmax cross-entropy from hidden states (port of
``kubetorch_tpu/ops/xent.py``).

The LM loss never materializes ``[B, S, V]`` logits: tokens are processed
in chunks of ``chunk_size`` rows, so one ``[chunk, V]`` f32 logits tile is
live at a time (2.1 GB at chunk 4096 and V = 128256). Two backwards, as in
the JAX package:

- ``backward="streaming"`` (default): :class:`_StreamingSums`, whose
  forward accumulates the unscaled gradient contributions per chunk —
  ``gx = (softmax(logits) − onehot(t))·m @ headᵀ``, ``gW = xcᵀ @ (…)`` and
  ``gm = logz − gold`` — beside the loss; the backward scales them by the
  loss cotangent (no recompute). The one-hot is never built: 1 is
  subtracted at the target index in place.
- ``backward="recompute"``: each chunk under ``torch.utils.checkpoint``;
  the backward recomputes the chunk's logits.

Without autograd either way computes only the loss sums.

This is XLA code in the JAX package, so it ports as plain PyTorch. The
matmuls run in the hidden states' dtype (cuBLAS accumulates in f32 and
rounds each product once to that dtype, where XLA keeps f32 logits); the
``gW`` sum across chunks is kept in f32 and cast once, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _pad_to_multiple(n: int, chunk: int) -> int:
    """Padded token count: smallest multiple of ``chunk`` >= n."""
    return ((n + chunk - 1) // chunk) * chunk


def _chunk_stats(xc, head, tc, mc):
    """One chunk's f32 logits, logsumexp, gold logits and loss/accuracy
    sums."""
    logits = (xc @ head).float()                         # [chunk, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, tc[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == tc).float()
    loss, acc = ((logz - gold) * mc).sum(), (correct * mc).sum()
    return logits, logz, gold, loss, acc


class _StreamingSums(torch.autograd.Function):
    """(loss_sum, acc_sum) over pre-chunked ``x [n, chunk, E]``, ``t``,
    ``m [n, chunk]``; the forward accumulates the gradients (see the
    module docstring) and the backward only scales them."""

    @staticmethod
    def forward(ctx, x, head, t, m, head_grad):
        E, V = head.shape
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        acc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        gx = torch.empty_like(x)
        gm = torch.empty(m.shape, dtype=torch.float32, device=x.device)
        gW = (torch.zeros((E, V), dtype=torch.float32, device=x.device)
              if head_grad else None)
        rows = torch.arange(x.shape[1], device=x.device)
        for c in range(x.shape[0]):
            xc, tc, mc = x[c], t[c], m[c]
            logits, logz, gold, loss, acc = _chunk_stats(xc, head, tc, mc)
            loss_sum += loss
            acc_sum += acc
            gm[c] = logz - gold                 # ∂loss_sum/∂m
            # dlogits = (softmax − onehot(target)) · mask, in place
            dl = logits.sub_(logz[:, None]).exp_()
            dl[rows, tc] -= 1.0
            dl.mul_(mc[:, None])
            dl = dl.to(head.dtype)
            del logits
            gx[c] = dl @ head.T
            if head_grad:
                gW += (xc.T @ dl).float()
        ctx.head_grad = head_grad
        ctx.head_meta = (head.shape, head.dtype)
        ctx.save_for_backward(gx, gW.to(head.dtype) if head_grad else None,
                              gm)
        return loss_sum, acc_sum

    @staticmethod
    def backward(ctx, d_loss, d_acc):
        gx, gW, gm = ctx.saved_tensors
        dx = (gx.float() * d_loss).to(gx.dtype)
        if ctx.head_grad:
            dW = (gW.float() * d_loss).to(gW.dtype)
        else:
            shape, dtype = ctx.head_meta
            dW = torch.zeros(shape, dtype=dtype, device=gx.device)
        return dx, dW, None, gm * d_loss, None


def _chunk_sums(xc, head, tc, mc):
    return _chunk_stats(xc, head, tc, mc)[3:]


def fused_cross_entropy(
    hidden: torch.Tensor,             # [B, S, E] compute dtype
    head: torch.Tensor,               # [E, V] unembedding
    targets: torch.Tensor,            # [B, S] int
    mask: Optional[torch.Tensor] = None,   # [B, S] {0, 1}
    chunk_size: int = 512,
    backward: str = "streaming",
    head_grad: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """Masked mean LM cross-entropy without materializing [B, S, V] logits.

    Returns ``(loss, {"tokens", "accuracy"})`` as in the JAX package.
    ``head_grad=False`` (streaming only) declares the unembedding frozen:
    the forward skips the [E, V] gradient product and the head's gradient
    comes back zero."""
    if backward not in ("streaming", "recompute"):
        raise ValueError(f"backward must be 'streaming' or 'recompute', "
                         f"got {backward!r}")
    B, S, E = hidden.shape
    n = B * S
    chunk = min(chunk_size, n)
    n_pad = _pad_to_multiple(n, chunk)
    n_chunks = n_pad // chunk

    x = hidden.reshape(n, E)
    t = targets.reshape(n).long()
    m = (torch.ones((n,), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(n).float())
    if n_pad != n:
        # pad with masked-out tokens: any batch shape chunks cleanly
        x = F.pad(x, (0, 0, 0, n_pad - n))
        t = F.pad(t, (0, n_pad - n))
        m = F.pad(m, (0, n_pad - n))
    x = x.reshape(n_chunks, chunk, E)
    t = t.reshape(n_chunks, chunk)
    m = m.reshape(n_chunks, chunk)

    grad = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad
                                        or m.requires_grad)
    if grad and backward == "streaming":
        loss_sum, acc_sum = _StreamingSums.apply(x, head, t, m, head_grad)
    else:
        loss_sum = acc_sum = 0.0
        for c in range(n_chunks):
            args = (x[c], head, t[c], m[c])
            # recompute: the backward recomputes the chunk's logits instead
            # of saving them, so one [chunk, V] tile is live in both passes
            loss, acc = (checkpoint(_chunk_sums, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if grad else _chunk_sums(*args))
            loss_sum = loss_sum + loss
            acc_sum = acc_sum + acc
    n_tok = torch.clamp(m.sum(), min=1.0)
    return loss_sum / n_tok, {"tokens": n_tok,
                              "accuracy": (acc_sum / n_tok).detach()}


__all__ = ["fused_cross_entropy"]
