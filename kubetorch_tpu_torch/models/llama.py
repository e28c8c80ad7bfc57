"""Llama-3-style decoder (port of ``kubetorch_tpu/models/llama.py``).

Plain functions over a params dict keyed exactly like the JAX tree: every
per-layer weight keeps its leading ``[n_layers, ...]`` dim, and a Python
loop over layers takes the place of ``lax.scan`` (``w[li]`` of a stacked
tensor is a contiguous view, so nothing is copied).

Projections go through :func:`_proj`: int8 weights at decode shape (≤ 256
tokens) launch the W8A16 kernel, everything else dequantizes (``_wload``)
into a plain matmul. Full-sequence attention takes the flash kernel under
the JAX package's ``attn_impl="auto"`` rule (S ≥ 2048, S % 512 == 0,
D % 128 == 0).

The KV cache of :func:`forward_cached` is updated **in place**: the cache
dict passed in is the one returned, its tensors written at ``write_at``.
In chunk mode (the rolling generator) the grid cache is read-only and the
small chunk cache is written in place and returned instead;
:func:`merge_chunk_into_grid` later writes it into the grid.

Training: :func:`forward` and :func:`hidden_states` run under autograd;
gradients reach the stacked ``[L, ...]`` leaves through the per-layer
views. With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(:func:`_block_remat`), saving what the JAX package's ``_remat_policy``
saves by name (``qkv_q/k/v``, ``attn_out``, ``mlp_out``) and recomputing
the rest in the backward.

Not ported yet: ``forward_pipeline``, ring attention, MoE and LoRA.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubetorch_tpu_torch._device import resolve_device
from kubetorch_tpu_torch.models.configs import LlamaConfig
from kubetorch_tpu_torch.ops import (apply_rope, dot_product_attention,
                                     rms_norm, rope_angles)
from kubetorch_tpu_torch.ops import quant_matmul
from kubetorch_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _dense_init(gen, shape, dtype, device):
    fan_in = shape[-2]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(dtype)


def init(seed: Union[int, torch.Generator], cfg: LlamaConfig,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random params on ``device`` (truncated-normal fan-in init, as in the
    JAX package; the numbers differ for the same seed)."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    pdt = cfg.storage_dtype
    L, E, H, Hkv, D, M, V = (cfg.n_layers, cfg.embed_dim, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.mlp_dim,
                             cfg.vocab_size)
    layers: Params = {
        "attn_norm": torch.ones((L, E), dtype=pdt, device=dev),
        "wq": _dense_init(gen, (L, E, H * D), pdt, dev),
        "wk": _dense_init(gen, (L, E, Hkv * D), pdt, dev),
        "wv": _dense_init(gen, (L, E, Hkv * D), pdt, dev),
        "wo": _dense_init(gen, (L, H * D, E), pdt, dev),
        "mlp_norm": torch.ones((L, E), dtype=pdt, device=dev),
        "w_gate": _dense_init(gen, (L, E, M), pdt, dev),
        "w_up": _dense_init(gen, (L, E, M), pdt, dev),
        "w_down": _dense_init(gen, (L, M, E), pdt, dev),
    }
    params: Params = {
        "embedding": (torch.randn((V, E), generator=gen, device=dev)
                      * 0.02).to(pdt),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(gen, (E, V), pdt, dev)
    return params


def _layer_slices(layers: Params, n_layers: int) -> List[Params]:
    """Per-layer views of the stacked ``[L, ...]`` weights."""
    per_key = {name: w.unbind(0) for name, w in layers.items()}
    return [{name: ws[li] for name, ws in per_key.items()}
            for li in range(n_layers)]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _wload(layer: Params, name: str, dt: torch.dtype) -> torch.Tensor:
    """A matmul weight in compute dtype; int8 entries with a
    ``<name>_scale`` sibling are dequantized (``w * scale`` in ``dt``: the
    int8 × ``dt`` multiply promotes to ``dt`` in one pass, the same
    numbers as converting first)."""
    scale = layer.get(name + "_scale")
    if scale is not None:
        return layer[name] * scale.to(dt)
    return layer[name].to(dt)


def _proj(x: torch.Tensor, layer: Params, name: str,
          dt: torch.dtype) -> torch.Tensor:
    """``x [..., K] @ layer[name] [K, N] → [..., N]``: the int8 kernel at
    decode shape, else a matmul on the dequantized weight."""
    w = layer[name]
    scale = layer.get(name + "_scale")
    if quant_matmul.decode_matmul_viable(x, w, scale):
        lead = x.shape[:-1]
        out = quant_matmul.int8_matmul(
            x.reshape(-1, x.shape[-1]).contiguous(), w, scale)
        return out.reshape(*lead, w.shape[-1])
    return x @ _wload(layer, name, dt)


def _mlp_gate_up(x: torch.Tensor, layer: Params, cfg: LlamaConfig):
    """The MLP's pre-norm and its gate and up projections."""
    dt = cfg.compute_dtype
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    if "wgu" in layer:
        # serving layout: gate and up share one weight stream
        return _proj(h, layer, "wgu", dt).chunk(2, dim=-1)
    return _proj(h, layer, "w_gate", dt), _proj(h, layer, "w_up", dt)


def _mlp_down(gate, up, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    return _proj(F.silu(gate) * up, layer, "w_down", cfg.compute_dtype)


def _mlp(x: torch.Tensor, layer: Params, cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU sublayer incl. its pre-norm; returns the residual
    (``mlp_out``)."""
    gate, up = _mlp_gate_up(x, layer, cfg)
    return _mlp_down(gate, up, layer, cfg)


def _attn_qkv(x: torch.Tensor, layer: Params, cfg: LlamaConfig):
    """Pre-norm and the q/k/v projections (``qkv_q/k/v``, before RoPE)."""
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = (h @ _wload(layer, "wq", dt)).reshape(B, S, H, D)
    k = (h @ _wload(layer, "wk", dt)).reshape(B, S, Hkv, D)
    v = (h @ _wload(layer, "wv", dt)).reshape(B, S, Hkv, D)
    return q, k, v


def _attn_core(q, k, v, sin, cos, cfg: LlamaConfig,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RoPE and attention → ``attn_out`` [B, S, H*D]."""
    B, S, H, D = q.shape
    q = apply_rope(q, None, cfg.rope_theta, sin=sin, cos=cos)
    k = apply_rope(k, None, cfg.rope_theta, sin=sin, cos=cos)
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if (S >= 2048 and S % 512 == 0
                           and D % 128 == 0) else "xla"
    if impl == "flash" and segment_ids is None:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = dot_product_attention(q, k, v, causal=True,
                                     segment_ids=segment_ids)
    return attn.reshape(B, S, H * D)


def _block(x: torch.Tensor, layer: Params, sin, cos, cfg: LlamaConfig,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder block. ``x``: [B, S, E] in compute dtype."""
    q, k, v = _attn_qkv(x, layer, cfg)
    attn = _attn_core(q, k, v, sin, cos, cfg, segment_ids)
    x = x + attn @ _wload(layer, "wo", cfg.compute_dtype)
    return x + _mlp(x, layer, cfg)


_REMAT_POLICIES = ("nothing", "dots", "dots_and_attn", "dots_no_mlp")


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _block_remat(x: torch.Tensor, layer: Params, sin, cos, cfg: LlamaConfig,
                 segment_ids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """:func:`_block` under ``torch.utils.checkpoint``, saving what the JAX
    package's ``_remat_policy`` saves (besides the block's input):

    - ``"nothing"``: the whole block recomputes;
    - ``"dots"``: every projection's output (q, k, v, the ``wo`` output,
      gate, up, the MLP output); norms, RoPE, attention and ``silu·up``
      recompute;
    - ``"dots_and_attn"``: ``"dots"`` plus the attention itself (its
      autograd residuals, incl. lse), so the backward never re-runs the
      flash forward;
    - ``"dots_no_mlp"``: q, k, v, ``attn_out`` and ``mlp_out``; the wide
      gate/up activations recompute with the whole MLP.

    A checkpointed stage's inputs are what it saves, so the stage
    boundaries are the saved names. The flash forward runs twice per layer
    per step under every policy but ``"dots_and_attn"`` (forward and
    recompute). The residual stream after attention is also saved (one
    ``[B, S, E]`` per layer) where JAX would recompute it.
    """
    policy = cfg.remat_policy
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; options: "
                         + ", ".join(repr(p) for p in _REMAT_POLICIES))
    if policy == "nothing":
        return _ckpt(_block, x, layer, sin, cos, cfg, segment_ids)
    dt = cfg.compute_dtype
    q, k, v = _ckpt(_attn_qkv, x, layer, cfg)
    if policy == "dots":
        x = x + _ckpt(lambda q, k, v: _attn_core(q, k, v, sin, cos, cfg,
                                                 segment_ids)
                      @ _wload(layer, "wo", dt), q, k, v)
    else:
        attn = (_attn_core(q, k, v, sin, cos, cfg, segment_ids)
                if policy == "dots_and_attn" else
                _ckpt(_attn_core, q, k, v, sin, cos, cfg, segment_ids))
        x = x + attn @ _wload(layer, "wo", dt)
    if policy == "dots_no_mlp":
        return x + _ckpt(_mlp, x, layer, cfg)
    gate, up = _ckpt(_mlp_gate_up, x, layer, cfg)
    return x + _ckpt(_mlp_down, gate, up, layer, cfg)


def hidden_states(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                  segment_ids: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decoder stack → final-norm hidden states ``[B, S, E]`` (compute
    dtype). Under autograd with ``cfg.remat`` every block is
    checkpointed (:func:`_block_remat`)."""
    dt = cfg.compute_dtype
    B, S = tokens.shape
    x = params["embedding"][tokens].to(dt)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    block = (_block_remat if cfg.remat and torch.is_grad_enabled()
             else _block)
    for layer in _layer_slices(params["layers"], cfg.n_layers):
        x = block(x, layer, sin, cos, cfg, segment_ids)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def unembedding(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    """The [E, V] output projection (tied → embedding transpose), preferring
    the int8 forms ``quantize_params`` installs (``unembed_q`` or an
    in-place quantized ``lm_head``)."""
    dt = cfg.compute_dtype
    if "unembed_q" in params:
        return params["unembed_q"] * params["unembed_scale"].to(dt)
    if not cfg.tie_embeddings:
        return _wload(params, "lm_head", dt)
    return params["embedding"].T.to(dt)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            segment_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward pass → logits ``[B, S, vocab]`` (float32)."""
    x = hidden_states(params, tokens, cfg, segment_ids, positions)
    return (x @ unembedding(params, cfg)).float()


# --------------------------------------------------------------------------
# KV-cache inference path (prefill + single-token decode)
# --------------------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
               quantized: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """Preallocated KV cache: ``{"k","v"}`` of [L, B, max_len, Hkv, D].

    ``quantized=True``: int8 K/V with per-vector float32 absmax scales
    (``"ks"``/``"vs"`` of [L, B, max_len, Hkv]).
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev)}
    dt = dtype if dtype is not None else cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _kv_quantize(x: torch.Tensor):
    """[B, T, Hkv, D] → (int8 same shape, f32 scale [B, T, Hkv]):
    symmetric per-head-vector absmax.

    The scale is ``absmax`` times f32(1/127), not ``absmax / 127``: the
    JAX package quantizes the cache only inside jitted code, where XLA
    turns the division by a constant into that product (one ulp apart for
    some values), so the int8 grid matches its engine's bit for bit."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = s.masked_fill(~mask[:, None, None, :, :], -1e30)
    return torch.softmax(s, dim=-1)


# The two grouped-query contractions of the cached attention, as batched
# matmuls ("btkgd,bmkd->bkgtm" and "bkgtm,bmkd->btkgd"): the same products
# and sums as the einsums, at a fraction of einsum's per-call host cost,
# which dominates a decode step.

def _gqa_scores(qg: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    """qg [B,T,Hkv,G,D], ck [B,M,Hkv,D] → scores [B,Hkv,G,T,M]."""
    B, T, Hkv, G, D = qg.shape
    q2 = qg.permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, D)
    return (q2 @ ck.permute(0, 2, 3, 1)).reshape(B, Hkv, G, T, -1)


def _gqa_values(p: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """p [B,Hkv,G,T,M], cv [B,M,Hkv,D] → [B,T,Hkv,G,D]."""
    B, Hkv, G, T, M = p.shape
    o = p.reshape(B, Hkv, G * T, M) @ cv.permute(0, 2, 1, 3)
    return o.reshape(B, Hkv, G, T, -1).permute(0, 3, 1, 2, 4)


def _cached_attn_q(q, ck, cv, ks, vs, mask, cfg: LlamaConfig):
    """Quantized-KV attention: ck/cv int8 [B,M,Hkv,D], ks/vs f32 [B,M,Hkv].

    Same numerics as the JAX package, which rounds q and p to bf16 and
    contracts with f32 accumulation: here the bf16-rounded operands are
    upcast to f32 before the contraction (a CPU bf16 matmul would return bf16,
    rounding the result). int8 → f32 is exact. Scales apply per key row
    after the QK contraction and fold into p before the PV one.
    """
    B, T, H, D = q.shape
    Hkv = ck.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D).to(torch.bfloat16).float()
    s = _gqa_scores(qg, ck.float()) * (D ** -0.5)
    s = s * ks.transpose(1, 2)[:, :, None, None, :]          # [B,Hkv,1,1,M]
    p = _masked_softmax(s, mask)
    p = p * vs.transpose(1, 2)[:, :, None, None, :]
    out = _gqa_values(p.to(torch.bfloat16).float(), cv.float())
    return out.to(q.dtype).reshape(B, T, H, D)


def _cached_attn(q, ck, cv, mask, cfg: LlamaConfig):
    """q: [B,T,H,D]; ck/cv: [B,M,Hkv,D]; mask: [B,T,M] bool → [B,T,H,D].
    Grouped-query contractions in float32."""
    B, T, H, D = q.shape
    Hkv = ck.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    s = _gqa_scores(qg, ck.float()) * (D ** -0.5)
    p = _masked_softmax(s, mask)
    out = _gqa_values(p, cv.float())
    return out.to(q.dtype).reshape(B, T, H, D)


# --------------------------------------------------------------------------
# chunk mode (rolling decode and chunked prefill)
# --------------------------------------------------------------------------

def merge_chunk_into_grid(cache: Dict[str, torch.Tensor],
                          chunk: Dict[str, torch.Tensor], start, count,
                          rows=None) -> Dict[str, torch.Tensor]:
    """Write chunk columns ``[0, count[b])`` into grid slots
    ``start[b] + col`` of every layer, in place; ``count[b] == 0`` writes
    nothing to row ``b``, and slots past the grid's end are dropped.

    ``chunk``: stacked ``{"k", "v"}`` of [L, R, K, Hkv, D]; its row ``b``
    lands in grid row ``rows[b]`` (default ``b``). ``start``/``count``:
    [R] integers, read on the host (pass host tensors or arrays to keep the
    card from synchronising). On the int8 grid the written chunk rows are
    quantized first (:func:`_kv_quantize`), values and scales.

    One indexed write per cache plane covers all layers. The JAX package
    selects with a one-hot einsum only because a gather or scatter with
    computed indices serializes on a TPU.
    """
    start = torch.as_tensor(start).cpu().long()
    count = torch.as_tensor(count).cpu().long()
    K, M = chunk["k"].shape[2], cache["k"].shape[2]
    col = torch.arange(K)[None, :]
    valid = (col < count[:, None]) & (start[:, None] + col < M)
    b, c = valid.nonzero(as_tuple=True)
    pos = start[b] + c
    g = b if rows is None else torch.as_tensor(rows).cpu().long()[b]
    dev = cache["k"].device
    b, c, g, pos = (t.to(dev) for t in (b, c, g, pos))
    ek, ev = chunk["k"][:, b, c], chunk["v"][:, b, c]      # [L, N, Hkv, D]
    if "ks" in cache:
        ek, sk = _kv_quantize(ek)
        ev, sv = _kv_quantize(ev)
        cache["ks"][:, g, pos] = sk
        cache["vs"][:, g, pos] = sv
    cache["k"][:, g, pos] = ek.to(cache["k"].dtype)
    cache["v"][:, g, pos] = ev.to(cache["v"].dtype)
    return cache


def _bf16_products(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a @ b`` may take bf16 operands into f32 products and sums
    (``torch.bmm(..., out_dtype=torch.float32)``): on the card, for bf16
    ``a`` and a bf16 or int8 ``b``, both exact in bf16. ``aten::bmm.dtype``
    has no CPU kernel, so the CPU (and any f32 operand) upcasts instead;
    the products are the same."""
    return (a.is_cuda and a.dtype == torch.bfloat16
            and b.dtype in (torch.bfloat16, torch.int8))


def _heads_major(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, M, Hkv, D] → [B*Hkv, M, D] in ``dtype``: one copy that converts
    and transposes together, into the layout the batched matmul reads."""
    B, M, Hkv, D = t.shape
    out = torch.empty((B, Hkv, M, D), dtype=dtype, device=t.device)
    out.copy_(t.permute(0, 2, 1, 3))
    return out.view(B * Hkv, M, D)


def _scores_f32(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qg [B,T,Hkv,G,D], k [B,M,Hkv,D] → f32 scores [B,Hkv,G,T,M] of the
    operands as they stand ("btkgd,bmkd->bkgtm")."""
    B, T, Hkv, G, D = qg.shape
    q2 = qg.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * T, D)
    if _bf16_products(q2, k):
        s = torch.bmm(q2, _heads_major(k, torch.bfloat16).transpose(1, 2),
                      out_dtype=torch.float32)
    else:
        s = torch.bmm(q2.float(),
                      _heads_major(k, torch.float32).transpose(1, 2))
    return s.view(B, Hkv, G, T, -1)


def _values_f32(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,Hkv,G,T,M], v [B,M,Hkv,D] → f32 [B,T,Hkv,G,D]
    ("bkgtm,bmkd->btkgd"); an f32 ``p`` reads ``v`` upcast once."""
    B, Hkv, G, T, M = p.shape
    p2 = p.reshape(B * Hkv, G * T, M)
    if _bf16_products(p2, v):
        o = torch.bmm(p2, _heads_major(v, torch.bfloat16),
                      out_dtype=torch.float32)
    else:
        o = torch.bmm(p2.float(), _heads_major(v, torch.float32))
    return o.view(B, Hkv, G, T, -1).permute(0, 3, 1, 2, 4)


def _cached_attn_merged(q, gk, gv, ek, ev, gmask, emask, cfg: LlamaConfig):
    """Attention over a read-only grid cache plus a small chunk cache,
    without their concatenation.

    q: [B,T,H,D]; gk/gv: [B,M,Hkv,D] (grid); ek/ev: [B,K,Hkv,D] (chunk);
    gmask: [B,T,M]; emask: [B,T,K]. The scores over both sources
    concatenate, one softmax spans them, and the two value contractions
    sum. f32 scores and f32 p, as in the JAX package.
    """
    B, T, H, D = q.shape
    Hkv = gk.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, D)
    s = torch.cat([_scores_f32(qg, gk), _scores_f32(qg, ek)],
                  dim=-1) * (D ** -0.5)
    p = _masked_softmax(s, torch.cat([gmask, emask], dim=-1))
    M = gk.shape[1]
    out = _values_f32(p[..., :M], gv) + _values_f32(p[..., M:], ev)
    return out.to(q.dtype).reshape(B, T, H, D)


def _cached_attn_merged_q(q, gk, gv, gks, gvs, ek, ev, gmask, emask,
                          cfg: LlamaConfig):
    """:func:`_cached_attn_merged` over a QUANTIZED grid (gk/gv int8
    [B,M,Hkv,D], scales gks/gvs f32 [B,M,Hkv]) and a bf16 chunk: operands
    rounded to bf16, f32 sums, and the grid half's scales folded in as in
    :func:`_cached_attn_q` (after the QK contraction, into p before the PV
    one)."""
    B, T, H, D = q.shape
    Hkv = gk.shape[2]
    bf16 = torch.bfloat16
    qg = q.reshape(B, T, Hkv, H // Hkv, D).to(bf16)
    sg = _scores_f32(qg, gk) * (D ** -0.5)
    sg = sg * gks.transpose(1, 2)[:, :, None, None, :]       # [B,Hkv,1,1,M]
    se = _scores_f32(qg, ek.to(bf16)) * (D ** -0.5)
    p = _masked_softmax(torch.cat([sg, se], dim=-1),
                        torch.cat([gmask, emask], dim=-1))
    M = gk.shape[1]
    pg = (p[..., :M] * gvs.transpose(1, 2)[:, :, None, None, :]).to(bf16)
    out = (_values_f32(pg, gv)
           + _values_f32(p[..., M:].to(bf16), ev.to(bf16)))
    return out.to(q.dtype).reshape(B, T, H, D)


def _qkv_proj(x, layer, sin, cos, cfg: LlamaConfig):
    """Norm → QKV projection (fused ``wqkv`` or separate weights) → RoPE."""
    dt = cfg.compute_dtype
    B, T, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    if "wqkv" in layer:
        # torch.split takes section sizes; the JAX code's split points
        # [H*D, H*D + Hkv*D] are positions. q and k heads rotate in one
        # RoPE call (per-head math, so the same numbers as two calls).
        qk, v = _proj(h, layer, "wqkv", dt).split(
            [(H + Hkv) * D, Hkv * D], dim=-1)
        qk = apply_rope(qk.reshape(B, T, H + Hkv, D), None, cfg.rope_theta,
                        sin=sin, cos=cos)
        q, k = qk.split([H, Hkv], dim=2)
        return q, k, v.reshape(B, T, Hkv, D)
    q = _proj(h, layer, "wq", dt).reshape(B, T, H, D)
    k = _proj(h, layer, "wk", dt).reshape(B, T, Hkv, D)
    v = _proj(h, layer, "wv", dt).reshape(B, T, Hkv, D)
    q = apply_rope(q, None, cfg.rope_theta, sin=sin, cos=cos)
    k = apply_rope(k, None, cfg.rope_theta, sin=sin, cos=cos)
    return q, k, v


def _write_rows(c_all: torch.Tensor, li: int, rows: torch.Tensor,
                write_at) -> None:
    """Write ``rows [B, T, ...]`` into layer ``li`` of a stacked cache at
    slot ``write_at`` (int: uniform across the batch) or at per-sequence
    slots (``[B]`` tensor), in place."""
    T = rows.shape[1]
    if not torch.is_tensor(write_at) or write_at.dim() == 0:
        start = int(write_at)
        c_all[li, :, start:start + T] = rows
        return
    B = rows.shape[0]
    pos = write_at[:, None] + torch.arange(T, device=rows.device)[None, :]
    bidx = torch.arange(B, device=rows.device)[:, None].expand(B, T)
    c_all[li][bidx, pos] = rows


def _block_cached_q(x, layer, li, sin, cos, cache, write_at, mask,
                    cfg: LlamaConfig):
    """Decoder block over a QUANTIZED cache (int8 K/V + per-vector scales):
    this step's K/V quantize on write, attention folds the scales in."""
    dt = cfg.compute_dtype
    B, T, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv_proj(x, layer, sin, cos, cfg)

    kq, kscale = _kv_quantize(k)
    vq, vscale = _kv_quantize(v)
    _write_rows(cache["k"], li, kq, write_at)
    _write_rows(cache["v"], li, vq, write_at)
    _write_rows(cache["ks"], li, kscale, write_at)
    _write_rows(cache["vs"], li, vscale, write_at)

    attn = _cached_attn_q(q, cache["k"][li], cache["v"][li], cache["ks"][li],
                          cache["vs"][li], mask, cfg).reshape(B, T, H * D)
    x = x + _proj(attn, layer, "wo", dt)
    return x + _mlp(x, layer, cfg)


def _block_cached(x, layer, li, sin, cos, cache, write_at, mask,
                  cfg: LlamaConfig):
    """One decoder block in cache mode: writes this step's K/V into layer
    ``li`` of the stacked cache at ``write_at`` (in place), then attends the
    layer's whole cache under ``mask``."""
    dt = cfg.compute_dtype
    B, T, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv_proj(x, layer, sin, cos, cfg)

    cdt = cache["k"].dtype
    _write_rows(cache["k"], li, k.to(cdt), write_at)
    _write_rows(cache["v"], li, v.to(cdt), write_at)

    attn = _cached_attn(q, cache["k"][li], cache["v"][li], mask,
                        cfg).reshape(B, T, H * D)
    x = x + _proj(attn, layer, "wo", dt)
    return x + _mlp(x, layer, cfg)


def _block_cached_chunk(x, layer, li, sin, cos, grid, chunk, col, gmask,
                        emask, cfg: LlamaConfig,
                        grid_rows: Optional[torch.Tensor] = None):
    """One decoder block in chunk mode: the stacked ``grid`` cache is
    read-only; this step's K/V land at the uniform column ``col`` of the
    stacked ``chunk`` cache (in place), and attention spans the layer's
    grid under ``gmask`` plus its chunk under ``emask``. A bf16 or an int8
    grid (``"ks"`` present) picks the attention. ``grid_rows`` ([R] index)
    reads only those grid rows, layer by layer, for a batch of R rows."""
    dt = cfg.compute_dtype
    B, T, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv_proj(x, layer, sin, cos, cfg)

    chunk["k"][li, :, col:col + T] = k
    chunk["v"][li, :, col:col + T] = v
    g = {name: (t[li] if grid_rows is None
                else t[li].index_select(0, grid_rows))
         for name, t in grid.items()}
    ek, ev = chunk["k"][li], chunk["v"][li]
    if "ks" in g:
        attn = _cached_attn_merged_q(q, g["k"], g["v"], g["ks"], g["vs"],
                                     ek, ev, gmask, emask, cfg)
    else:
        attn = _cached_attn_merged(q, g["k"], g["v"], ek, ev, gmask, emask,
                                   cfg)
    x = x + _proj(attn.reshape(B, T, H * D), layer, "wo", dt)
    return x + _mlp(x, layer, cfg)


def forward_cached(
    params: Params,
    tokens: torch.Tensor,      # [B, T] int (prefill: padded prompt; decode: 1)
    positions: torch.Tensor,   # [B, T] RoPE positions per token
    cache: Dict[str, torch.Tensor],
    write_at,                  # cache slot of tokens[:, 0]: int, or [B] tensor
    mask: torch.Tensor,        # [B, T, max_len] bool attention mask
    cfg: LlamaConfig,
    unembed_positions: Optional[torch.Tensor] = None,  # [B]: logits only there
    chunk: Optional[Dict[str, torch.Tensor]] = None,  # [L, B, K, Hkv, D]
    chunk_col: Optional[int] = None,                  # uniform chunk column
    chunk_mask: Optional[torch.Tensor] = None,        # [B, T, K] bool
    grid_rows: Optional[torch.Tensor] = None,         # [B]: grid rows read
):
    """Forward with KV cache → (logits [B, T, V] float32, cache).

    The cache is updated in place and returned. ``unembed_positions``
    restricts the unembedding to one position per sequence (logits
    [B, 1, V]): prefill needs only the last real token's logits.

    ``chunk`` mode (rolling decode, chunked prefill): ``cache`` is the
    read-only grid (``write_at`` unused) and this call's K/V land at the
    uniform ``chunk_col`` of the stacked chunk cache; attention spans the
    grid under ``mask`` plus the chunk under ``chunk_mask``. The updated
    CHUNK is returned, not the grid: the caller merges it
    (:func:`merge_chunk_into_grid`). ``grid_rows`` runs the batch over
    those grid rows only (row ``b`` of ``tokens`` reads grid row
    ``grid_rows[b]``).
    """
    dt = cfg.compute_dtype
    x = params["embedding"][tokens].to(dt)
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    n_layers = cache["k"].shape[0]
    layers = _layer_slices(params["layers"], n_layers)
    if chunk is not None:
        for li, layer in enumerate(layers):
            x = _block_cached_chunk(x, layer, li, sin, cos, cache, chunk,
                                    chunk_col, mask, chunk_mask, cfg,
                                    grid_rows)
    else:
        block = _block_cached_q if "ks" in cache else _block_cached
        for li, layer in enumerate(layers):
            x = block(x, layer, li, sin, cos, cache, write_at, mask, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if unembed_positions is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              unembed_positions][:, None]
    logits = x @ unembedding(params, cfg)
    return logits.float(), (cache if chunk is None else chunk)


def num_params(cfg: LlamaConfig) -> int:
    """Analytic parameter count (dense layers)."""
    E, H, Hkv, D, M, V, L = (cfg.embed_dim, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, cfg.mlp_dim, cfg.vocab_size,
                             cfg.n_layers)
    attn = E * H * D + 2 * E * Hkv * D + H * D * E
    per_layer = attn + 3 * E * M + 2 * E
    total = L * per_layer + V * E + E
    if not cfg.tie_embeddings:
        total += E * V
    return total
