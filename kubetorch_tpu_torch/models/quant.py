"""Weight-only int8 quantization for serving (port of the serving half of
``kubetorch_tpu/models/quant.py``).

Matmul weights are quantized per output channel to int8 with a scale in the
weight's dtype; :func:`kubetorch_tpu_torch.models.llama._proj` sends decode
through the W8A16 kernel and prefill through a dequantized matmul. Norms,
embeddings and the unembedding stay in their original dtype.

The stochastic-rounding path (``key``) and the block quantizers serve the
training and collectives code, and come with those slices.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch

from kubetorch_tpu_torch._device import resolve_device

QUANT_KEYS: Sequence[str] = (
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "we_gate", "we_up", "we_down",
)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), ±127)`` as int8; ``torch.round`` rounds half
    to even, as ``jnp.round`` does, so the bytes match the JAX package."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize_leaf(w: torch.Tensor):
    """→ (int8 weights, per-output-channel scale in w.dtype)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    return quantize_with_scale(w32, scale), scale.to(w.dtype)


FUSE_GROUPS = (("wqkv", ("wq", "wk", "wv")),
               ("wgu", ("w_gate", "w_up")))


def fuse_decode_layers(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Pack same-input quantized projections into single weights:
    ``wq+wk+wv → wqkv`` and ``w_gate+w_up → wgu`` (scales concatenated the
    same way), so decode launches one weight-streaming kernel where it
    launched three (QKV) or two (gate·up). Serving-only layout."""
    layers = dict(layers)
    for fused, parts in FUSE_GROUPS:
        if not all(p in layers and p + "_scale" in layers for p in parts):
            continue
        layers[fused] = torch.cat([layers[p] for p in parts], dim=-1)
        layers[fused + "_scale"] = torch.cat(
            [layers[p + "_scale"] for p in parts], dim=-1)
        for p in parts:
            del layers[p], layers[p + "_scale"]
    return layers


def quantize_params(params: Dict[str, Any],
                    keys: Sequence[str] = QUANT_KEYS,
                    quantize_unembed: bool = False) -> Dict[str, Any]:
    """A params tree with the matmul weights int8-quantized in place and a
    ``<name>_scale`` sibling added; other leaves pass through.
    ``quantize_unembed`` also quantizes the [E, V] output projection
    (untied ``lm_head`` in place; tied embeddings get an ``unembed_q``
    copy so lookups keep full precision)."""
    layers = dict(params["layers"])
    for name in keys:
        if name not in layers:
            continue
        q, scale = _quantize_leaf(layers[name])
        layers[name] = q
        layers[name + "_scale"] = scale
    out = dict(params)
    out["layers"] = layers
    if quantize_unembed:
        if "lm_head" in out:
            q, scale = _quantize_leaf(out["lm_head"])
            out["lm_head"] = q
            out["lm_head_scale"] = scale
        else:
            q, scale = _quantize_leaf(out["embedding"].T)
            out["unembed_q"] = q
            out["unembed_scale"] = scale
    return out


def dequantize_params(params: Dict[str, Any],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Materialize full-precision weights back (debug / quality checks)."""
    layers = dict(params["layers"])
    if "wqkv" in layers or "wgu" in layers:
        raise ValueError(
            "fused decode layout (wqkv/wgu) cannot be dequantized — keep "
            "the unfused tree for debugging; fusion is serving-only")
    for name in list(layers):
        if name.endswith("_scale"):
            base = name[: -len("_scale")]
            layers[base] = layers[base].to(dtype) * layers[name].to(dtype)
            del layers[name]
    out = dict(params)
    out["layers"] = layers
    out.pop("unembed_q", None)
    out.pop("unembed_scale", None)
    if "lm_head_scale" in out:
        out["lm_head"] = (out["lm_head"].to(dtype)
                          * out.pop("lm_head_scale").to(dtype))
    return out


def init_quantized(seed: Union[int, torch.Generator], cfg,
                   keys: Sequence[str] = QUANT_KEYS, fuse: bool = False,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, Any]:
    """Random params made directly in int8-quantized form, on ``device``.

    For serving-scale smoke runs and benchmarks: the int8 Llama-3-8B tree
    (about 7 GB of matmul weights plus 2.1 GB of bf16 embedding and head)
    is made on the card without a bf16 tree ever existing. Weight values
    are random; scales mimic a trained model's magnitude (absmax ≈ 4σ of a
    1/√in_dim dense init) so logits land in a realistic range. ``seed`` is
    an int or a ``torch.Generator`` on ``device``; values differ from the
    JAX package's for the same seed.
    """
    dev = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    pdt = cfg.storage_dtype
    L, E, H, Hkv, D, M, V = (cfg.n_layers, cfg.embed_dim, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.mlp_dim,
                             cfg.vocab_size)
    shapes = {
        "wq": (L, E, H * D), "wk": (L, E, Hkv * D), "wv": (L, E, Hkv * D),
        "wo": (L, H * D, E),
        "w_gate": (L, E, M), "w_up": (L, E, M), "w_down": (L, M, E),
    }
    layers: Dict[str, Any] = {
        "attn_norm": torch.ones((L, E), dtype=pdt, device=dev),
        "mlp_norm": torch.ones((L, E), dtype=pdt, device=dev),
    }
    for name, shape in shapes.items():
        in_dim = shape[-2]
        if name in keys:
            layers[name] = torch.randint(-127, 128, shape, generator=gen,
                                         dtype=torch.int8, device=dev)
            layers[name + "_scale"] = torch.full(
                shape[:-2] + (1, shape[-1]), 4.0 / (in_dim ** 0.5) / 127.0,
                dtype=pdt, device=dev)
        else:
            # not selected for quantization: full precision, matching
            # quantize_params' behaviour on a keys subset
            layers[name] = torch.randn(shape, generator=gen, dtype=pdt,
                                       device=dev) * (in_dim ** -0.5)
    out: Dict[str, Any] = {
        "embedding": torch.randn((V, E), generator=gen, dtype=pdt,
                                 device=dev) * (E ** -0.5),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = torch.randn((E, V), generator=gen, dtype=pdt,
                                     device=dev) * (E ** -0.5)
    if fuse:
        out["layers"] = fuse_decode_layers(out["layers"])
    return out
