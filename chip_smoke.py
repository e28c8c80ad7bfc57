#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kubetorch_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device and build: the card's name and power limit, then every CUDA
   kernel built from ``kubetorch_tpu_torch/csrc`` with nvcc for sm_90a (one
   nvcc per source, all started together); ptxas's registers and spills,
   and, where the toolkit has ``cuobjdump``, the Hopper instructions in the
   SASS (the flash forward, dq and dk/dv kernels must hold wgmma and TMA
   loads, the int8 kernel TMA loads);
2. each kernel against its plain PyTorch version at the main path's
   shapes, timed beside its bound and one PyTorch library call: int8
   matmul (with each projection's GB/s and share of its bound), flash
   forward, and the two flash backward kernels (dq, dk/dv; dq's TFLOP/s)
   at the training shape, incl. a strided layout;
3. ``Generator`` on Llama-3-8B at full width and depth (int8 weights in the
   fused serving layout, random from a seed): 8 ragged prompts of up to 128
   tokens, 32 greedy tokens, with the bf16 and the int8 KV cache; every
   decode projection must go through the int8 kernel;
4. ``RollingGenerator`` on the same weights at the JAX serving bench's
   B = 64 rung (64 rows of 2048 slots, 8 steps a decode chunk, prefill
   chunks of 256), with the bf16 and the int8 grid: waves of ragged prompts
   of 16-512 tokens (64 new tokens each, eight rows at temperature 0.8)
   admitted while other rows decode, a shared 256-token prefix, a
   1500-token prompt through chunked prefill beside the decoding rows, an
   evict and readmit. Every decode chunk launches the int8 kernel exactly
   n_layers × 4 × 8 times and every prefill chunk n_layers × 4 times when
   rows × chunk ≤ 256, else none; a chunk-mode block and the merge are held
   against the grid-written block, a one-row prefill chunk against that
   row inside a full-width one, the readmitted row against its first
   admission, and the sampled rows reproduce under one seed inside
   ``filter_logits``' support. Each chunk is timed (host, device, idle
   share) under a kernel-only trace;
5. ``DecodeEngine`` over ``RollingGenerator`` at the same rung, with the
   bf16 and the int8 grid: 40 programs of 128 greedy tokens in two waves
   of 20 (the second admitted while the first decodes), each a shared
   256-token system prefix (the engine's ``len:256`` split shares it) plus
   a user turn of 16-64 tokens; 8 sessions parked through a local store
   under a temp dir after >= 32 tokens and resumed. Every forward the
   engine dispatches is logged and the int8 launches must equal what that
   log implies; parks == restores == 8; every parked blob reads back byte
   for byte; every program ends with its 128 tokens; one session parked
   and resumed alone gives the tokens of the same program unparked.
   Tokens/s, TTFT median and p90, park and restore ms, blob bytes and peak
   memory go to ``chip_smoke.json``;
6. ``Embedder`` on the same weights: 2 prompts of 1500 and 2048 tokens,
   which pad to S = 2048 and take the flash kernel in all 32 layers;
7. ``Trainer`` on Llama-3 1B at full width (the JAX package's largest
   single-chip training fit: remat "dots_no_mlp", cross-entropy chunks of
   4096, AdamW), B = 4, S = 2048 batches from ``lm_batches`` over a random
   corpus: 2 warm-up and 5 timed steps, then 3 steps on fresh batches;
   exactly 16 dq and 16 dk/dv launches per step, finite losses, every
   block's gradients held against the plain-attention block, and one
   profiled step.

The line before the last holds the kernels' numbers as JSON; the last line
is ``{"ok": true, "device": {...}}``. Details go to ``chip_smoke.json``,
``decode_profile.txt`` and ``train_profile.txt`` in ``--out`` (default
``smoke_out/`` beside this script). Needs one CUDA card; exits non-zero and
prints no result without one. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20
SEED = 0

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events. The card first spins for longer than the host takes to enqueue
    the calls, so a kernel shorter than its Python dispatch is timed on
    the card and not at the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1000)   # > 2x enqueue time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotating(make, nbytes: int):
    """Enough copies of an input that cycling through them overflows L2:
    a decode step streams every layer's weights from device memory cold."""
    n = max(1, -(-3 * L2_BYTES // max(nbytes, 1)))
    return [make() for _ in range(n)]


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# SASS instructions that show a kernel runs on Hopper's own pipeline:
# warpgroup MMA and TMA tensor loads
HOPPER_SASS = ("HGMMA", "UTMALDG")
# kernels (a substring of the mangled name, in the library of that source)
# and the instructions each must hold
HOPPER_KERNELS = {("flash_fwd", "flash_fwd_kernel"): ("HGMMA", "UTMALDG"),
                  ("flash_bwd", "dkv6kernel"): ("HGMMA", "UTMALDG"),
                  ("flash_bwd", "2dq6kernel"): ("HGMMA", "UTMALDG"),
                  ("int8_matmul", "w8a16_kernel"): ("UTMALDG",)}


def sass_counts(build):
    """{source: {kernel: {instruction: count}}} from ``cuobjdump -sass`` of
    each built library, or None where the toolkit has no cuobjdump. Raises
    if a kernel of HOPPER_KERNELS lacks one of its instructions."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log(f"no {cuobjdump}: SASS not inspected")
        return None
    counts = {}
    for name in build.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts[name] = {}
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            fn = block.split("\n", 1)[0].strip()
            counts[name][fn] = {i: block.count(i) for i in HOPPER_SASS}
            log(f"  sass {name}: {fn[-40:]} " + " ".join(
                f"{i} {n}" for i, n in counts[name][fn].items()))
    for (name, part), need in HOPPER_KERNELS.items():
        found = [c for fn, c in counts[name].items() if part in fn]
        if not found or not all(c[i] for c in found for i in need):
            raise AssertionError(f"{name}: kernel *{part}* lacks "
                                 f"{'/'.join(need)} in its SASS: "
                                 f"{counts[name]}")
    return counts


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_int8_matmul(dev, cfg):
    from kubetorch_tpu_torch.ops import quant_matmul as qm

    E, M = cfg.embed_dim, cfg.mlp_dim
    HD, KVD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wqkv": (E, HD + 2 * KVD), "wo": (HD, E),
              "wgu": (E, 2 * M), "w_down": (M, E)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, (K, N) in shapes.items():
        ws = rotating(lambda: torch.randint(-127, 128, (K, N), generator=gen,
                                            dtype=torch.int8, device=dev),
                      K * N)
        scale = ((torch.rand(N, generator=gen, device=dev) + 0.5)
                 * (4.0 / K ** 0.5 / 127.0)).to(torch.bfloat16)
        wdq = [(w.to(torch.bfloat16) * scale) for w in ws[:2]]
        for B in (8, 64):
            x = torch.randn(B, K, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            got = qm.int8_matmul(x, ws[0], scale)
            want = qm.int8_matmul_plain(x, ws[0], scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # both sum exact bf16×int8 products in f32 (in another order)
            # and round once to bf16: at most about one bf16 ulp apart
            tol_abs = 1e-3 * want.float().abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=tol_abs)
            it = iter(range(10 ** 9))
            k_ms = time_ms(lambda: qm.int8_matmul(
                x, ws[next(it) % len(ws)], scale))
            p_ms = time_ms(lambda: qm.int8_matmul_plain(
                x, ws[next(it) % len(ws)], scale), reps=5)
            l_ms = time_ms(lambda: x @ wdq[next(it) % len(wdq)])
            nbytes = B * K * 2 + K * N + N * 2 + B * N * 2
            b_ms, b_by = bound_ms(nbytes, 2.0 * B * K * N)
            rows.append({"proj": name, "B": B, "K": K, "N": N,
                         "bytes": nbytes, "flops": 2.0 * B * K * N,
                         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "gb_per_s": nbytes / k_ms / 1e6,
                         "share_of_bound": b_ms / k_ms,
                         "splits": qm.pick_splits(B, K, N, sms)[0]})
            log(f"int8_matmul {name:6s} B={B:3d} K={K:5d} N={N:5d}: "
                f"err {err:.3g} kernel {k_ms:.4f} ms "
                f"({nbytes / k_ms / 1e6:.0f} GB/s, {b_ms / k_ms:.1%} of "
                f"bound) plain {p_ms:.4f} ms library {l_ms:.4f} ms bound "
                f"{b_ms:.4f} ms ({b_by})")
        if name == "wqkv":
            # f32 activations take the kernel's hi/lo bf16 split: about
            # 2^-16 relative per x element instead of f32's 2^-24
            xf = torch.randn(8, K, generator=gen, device=dev)
            got = qm.int8_matmul(xf, ws[0], scale.float())
            want = qm.int8_matmul_plain(xf, ws[0], scale.float())
            torch.testing.assert_close(
                got, want, rtol=1e-4,
                atol=1e-4 * want.abs().max().item())
        del ws, wdq
    return rows


def check_flash(dev):
    from kubetorch_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    B, S, Hq, Hkv, D = 2, 2048, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scale = D ** -0.5
    rows = []
    for causal in (True, False):
        out, lse = fa.flash_forward(q, k, v, scale=scale, causal=causal)
        pout, plse = fa.flash_forward_plain(q, k, v, scale=scale,
                                            causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - pout.float()).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        # the kernel rounds p to bf16 before P·V and writes bf16; the plain
        # version keeps p in f32: a few bf16 ulps of |out| <= ~3
        torch.testing.assert_close(out.float(), pout.float(), rtol=2e-2,
                                   atol=2e-2)
        # scores are exact bf16 products summed in f32 on both sides
        torch.testing.assert_close(lse, plse, rtol=0, atol=2e-3)
        del pout, plse
        k_ms = time_ms(lambda: fa.flash_forward(
            q, k, v, scale=scale, causal=causal, with_lse=False))
        p_ms = time_ms(lambda: fa.flash_forward_plain(
            q, k, v, scale=scale, causal=causal), reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        del qt, kt, vt
        pairs = S * (S + 1) // 2 if causal else S * S
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        b_ms, b_by = bound_ms(nbytes, 4.0 * B * Hq * D * pairs)
        rows.append({"causal": causal, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                     "D": D, "max_abs_err": err, "lse_max_abs_err": lse_err,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"flash_forward causal={causal}: err {err:.3g} lse err "
            f"{lse_err:.3g} kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
            f"library {l_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    return rows


def flash_bwd_flops(B, S, Hq, D, causal):
    """(dq, dk/dv) tensor-core flops: 3 and 4 products of 2·D flops per
    (query head, query, live key)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    per = 2.0 * B * Hq * D * pairs
    return 3 * per, 4 * per


def bwd_close(got, want):
    """The kernels round p and ds to bf16 before their products and write
    bf16; the plain version keeps f32 until its one final rounding: held to
    2e-2 of the gradient's norm and 5e-2 of its largest element."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    err = (got - want).abs().max().item()
    if not (rel < 2e-2 and err <= 5e-2 * want.abs().max().item()):
        raise AssertionError(f"flash backward kernel vs plain: relative "
                             f"L2 {rel}, max abs {err}")
    return err, rel


def check_flash_backward(dev, B=4, S=2048, Hq=16, Hkv=8):
    """dq and dk/dv against the plain backward at the training shape (B = 4,
    S = 2048, 16/8 heads, D = 128), causal and not, plus a strided case."""
    from kubetorch_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    D = 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, g = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D), \
        rnd(B, S, Hq, D)
    scale = D ** -0.5
    rows = []
    for causal in (True, False):
        out, lse = fa.flash_forward(q, k, v, scale=scale, causal=causal)
        delta = fa.flash_bwd_delta(g, out)
        got = fa.flash_backward(q, k, v, out, lse, g, scale=scale,
                                causal=causal)
        want = fa.flash_backward_plain(q, k, v, out, lse, g, scale=scale,
                                       causal=causal)
        torch.cuda.synchronize()
        errs = [bwd_close(a, b) for a, b in zip(got, want)]
        if errs[0][1] > 5e-3:
            raise AssertionError(f"dq kernel vs plain: relative L2 "
                                 f"{errs[0][1]} > 5e-3")
        del got, want
        dq_ms = time_ms(lambda: fa._bwd_dq(q, k, v, g, lse, delta, scale,
                                           causal))
        dkv_ms = time_ms(lambda: fa._bwd_dkv(q, k, v, g, lse, delta, scale,
                                             causal))
        p_ms = time_ms(lambda: fa.flash_backward_plain(
            q, k, v, out, lse, g, scale=scale, causal=causal), reps=3,
            warmup=1)
        # library yardstick: SDPA's backward yields dq, dk and dv together
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True)
        gt = g.transpose(1, 2).contiguous()
        l_ms = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True))
        del qt, kt, vt, ot, gt
        f_dq, f_dkv = flash_bwd_flops(B, S, Hq, D, causal)
        io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * 4 * lse.numel()
        b_dq = bound_ms(io + 2 * q.numel(), f_dq)
        b_dkv = bound_ms(io + 2 * (k.numel() + v.numel()), f_dkv)
        row = {"causal": causal, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
               "D": D, "max_abs_err": max(e for e, _ in errs),
               "rel_l2_err": {n: r for n, (_, r) in
                              zip(("dq", "dk", "dv"), errs)},
               "dq_ms": dq_ms, "dq_tflop_per_s": f_dq / dq_ms / 1e9,
               "dkv_ms": dkv_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "dq_bound_ms": b_dq[0],
               "dq_bound_by": b_dq[1], "dkv_bound_ms": b_dkv[0],
               "dkv_bound_by": b_dkv[1]}
        rows.append(row)
        log(f"flash_backward causal={causal}: err {row['max_abs_err']:.3g} "
            f"(rel L2 dq {errs[0][1]:.3g} dk {errs[1][1]:.3g} dv "
            f"{errs[2][1]:.3g}); dq {dq_ms:.4f} ms ({f_dq / dq_ms / 1e9:.0f} "
            f"TFLOP/s, bound {b_dq[0]:.4f}), "
            f"dk/dv {dkv_ms:.4f} ms (bound {b_dkv[0]:.4f}), plain "
            f"{p_ms:.3f} ms, library (SDPA backward) {l_ms:.4f} ms")
    # q/k/v as column slices of one fused projection, dO a slice of a wider
    # tensor: the kernels read them through their strides
    qkv = rnd(2, min(S, 512), Hq + 2 * Hkv, D)
    sq, sk, sv = qkv.split([Hq, Hkv, Hkv], dim=2)
    sg = rnd(2, min(S, 512), Hq + 2, D)[:, :, 1:Hq + 1]
    out, lse = fa.flash_forward(sq, sk, sv, scale=scale, causal=True)
    got = fa.flash_backward(sq, sk, sv, out, lse, sg, scale=scale,
                            causal=True)
    want = fa.flash_backward_plain(sq, sk, sv, out, lse, sg, scale=scale,
                                   causal=True)
    strided = [bwd_close(a, b)[1] for a, b in zip(got, want)]
    if strided[0] > 5e-3:
        raise AssertionError(f"dq kernel vs plain, strided: relative L2 "
                             f"{strided[0]} > 5e-3")
    log(f"flash_backward strided layout: rel L2 {max(strided):.3g}")
    return rows, {"strided_rel_l2_max": max(strided)}


# --------------------------------------------------------------------------
# phase 3: Generator, phase 6: Embedder
# --------------------------------------------------------------------------

@contextlib.contextmanager
def dequantized_projections():
    """Send every projection through ``_wload`` (dequantize + matmul): the
    reference the kernel path is held against."""
    from kubetorch_tpu_torch.models import llama

    saved = llama.quant_matmul.decode_matmul_viable
    llama.quant_matmul.decode_matmul_viable = lambda x, w, s: False
    try:
        yield
    finally:
        llama.quant_matmul.decode_matmul_viable = saved


def check_step0(params, cfg, cache, tok, lens, Pmax, mask):
    """The first decode step through the int8 kernel, held against the same
    step with every projection dequantized into a plain matmul.

    Block by block, on the same input: the kernel scales an exact f32 sum,
    the reference multiplies bf16-rounded dequantized weights (2^-9
    relative each), and the random weights make attention scores large, so
    small score differences move the softmax: a block's update differs by
    about 1.3e-2 (seed 0, H100); 3e-2 is the bound. End to end the step
    compounds those differences through 32 layers: the logits are held to
    0.25 relative, which still catches a wrong scale or a dropped
    projection (either gives an error of order 1).
    """
    from kubetorch_tpu_torch.models import llama

    dt = cfg.compute_dtype
    x = params["embedding"][tok[:, None]].to(dt)
    sin, cos = llama.rope_angles(lens[:, None], cfg.head_dim, cfg.rope_theta)
    block = llama._block_cached_q if "ks" in cache else llama._block_cached
    ref_cache = {k: v.clone() for k, v in cache.items()}
    worst = 0.0
    for li, layer in enumerate(llama._layer_slices(params["layers"],
                                                   cfg.n_layers)):
        one = {k: v.clone() for k, v in cache.items()}
        got = block(x, layer, li, sin, cos, one, Pmax, mask, cfg)
        with dequantized_projections():
            want = block(x, layer, li, sin, cos, one, Pmax, mask, cfg)
        rel = ((got - want).float().norm()
               / (want - x).float().norm()).item()
        worst = max(worst, rel)
        if not np.isfinite(rel) or rel > 3e-2:
            raise AssertionError(f"layer {li}: kernel block vs dequantized "
                                 f"block relative error {rel} > 3e-2")
        x = got
    got, _ = llama.forward_cached(params, tok[:, None], lens[:, None],
                                  cache, Pmax, mask, cfg)
    with dequantized_projections():
        want, _ = llama.forward_cached(params, tok[:, None], lens[:, None],
                                       ref_cache, Pmax, mask, cfg)
    rel = ((got - want).norm() / want.norm()).item()
    if not np.isfinite(rel) or rel > 0.25:
        raise AssertionError(f"first decode step logits: kernel vs "
                             f"dequantized matmul relative error {rel}")
    return {"block_rel_err_max": worst, "logits_rel_err": rel,
            "logits_max_abs_err": (got - want).abs().max().item(),
            "logits_max_abs": want.abs().max().item(),
            "argmax_agree": (got.argmax(-1) == want.argmax(-1)
                             ).float().mean().item()}


def run_generator(params, cfg, dev, prompts, kv_dtype, n_new):
    from kubetorch_tpu_torch.models import Generator, llama
    from kubetorch_tpu_torch.ops import quant_matmul as qm

    gen = Generator(params, cfg, kv_dtype=kv_dtype)
    gen.generate(prompts, max_new_tokens=2, temperature=0.0)   # warm-up
    B = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    Pmax = int(lens.max())
    toks = torch.zeros((B, Pmax), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    max_len = Pmax + n_new

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, cache = gen.prefill(toks, lens, max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3

        # first decode step: kernel path vs dequantize + matmul
        tok = logits0.argmax(-1)
        slot = torch.arange(max_len, device=dev)[None, :]
        mask = ((slot < lens[:, None])
                | ((slot >= Pmax) & (slot <= Pmax)))[:, None]
        step0 = check_step0(params, cfg, cache, tok, lens, Pmax, mask)
        del cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    qm.int8_matmul.launches = 0
    t0 = time.perf_counter()
    out = gen.generate(prompts, max_new_tokens=n_new, temperature=0.0)
    torch.cuda.synchronize()
    totals = [time.perf_counter() - t0]
    launches = qm.int8_matmul.launches
    peak = torch.cuda.max_memory_allocated(dev)
    for _ in range(2):          # host time varies: report the median of 3
        t0 = time.perf_counter()
        gen.generate(prompts, max_new_tokens=n_new, temperature=0.0)
        torch.cuda.synchronize()
        totals.append(time.perf_counter() - t0)
    total_s = sorted(totals)[1]

    want_launches = n_new * cfg.n_layers * 4
    if launches != want_launches:
        raise AssertionError(f"int8 kernel launched {launches} times in "
                             f"generate, expected {want_launches}")
    if [len(o) for o in out] != [n_new] * B or not all(
            0 <= t < cfg.vocab_size for o in out for t in o):
        raise AssertionError(f"bad generate output {out}")
    decode_s = total_s - prefill_ms / 1e3
    res = {"kv_dtype": kv_dtype, "batch": B, "prompt_max": Pmax,
           "new_tokens": n_new, "prefill_ms": prefill_ms,
           "generate_s": total_s, "generate_s_runs": totals,
           "decode_tokens_per_s": B * n_new / decode_s,
           "decode_step_ms": decode_s / n_new * 1e3,
           "peak_mem_gib": peak / 2 ** 30, "int8_launches": launches,
           "first_tokens": out[0][:8], **step0}
    log(f"Generator kv={kv_dtype}: prefill {prefill_ms:.1f} ms, generate "
        f"{total_s:.3f} s, decode {res['decode_tokens_per_s']:.1f} tok/s "
        f"({res['decode_step_ms']:.2f} ms/step), peak "
        f"{res['peak_mem_gib']:.2f} GiB, int8 launches {launches}; step 0 vs "
        f"dequantized matmul: worst block {step0['block_rel_err_max']:.3g}, "
        f"logits {step0['logits_rel_err']:.3g} (argmax agree "
        f"{step0['argmax_agree']:.2f})")
    return res


def unfused_view(params, cfg):
    """The fused serving tree seen with separate wq/wk/wv and w_gate/w_up
    (views, no copies): the full-sequence blocks read those keys, as in
    the JAX package."""
    HD, KVD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layers = dict(params["layers"])
    for suffix in ("", "_scale"):
        q, k, v = layers.pop("wqkv" + suffix).split([HD, KVD, KVD], dim=-1)
        layers["wq" + suffix], layers["wk" + suffix] = q, k
        layers["wv" + suffix] = v
        gate, up = layers.pop("wgu" + suffix).chunk(2, dim=-1)
        layers["w_gate" + suffix], layers["w_up" + suffix] = gate, up
    return dict(params, layers=layers)


def check_embed_blocks(params, cfg, dev, prompts):
    """The Embedder's forward with the flash kernel, held against plain
    attention on the same input, block by block: the kernel rounds p to
    bf16 before P·V, the plain path keeps it in f32, and the random
    weights' large scores make the softmax sensitive, so a block's update
    may differ by about 1e-2; 3e-2 is the bound. The pooled embeddings of
    the two full runs are held to a cosine of 0.9 (the differences compound
    through 32 layers)."""
    from kubetorch_tpu_torch.models import Embedder, llama

    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), 2048), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    worst = 0.0
    with torch.no_grad():
        x = params["embedding"][toks].to(cfg.compute_dtype)
        pos = torch.arange(toks.shape[1], device=dev)[None, :]
        sin, cos = llama.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        for li, layer in enumerate(llama._layer_slices(params["layers"],
                                                       cfg.n_layers)):
            got = llama._block(x, layer, sin, cos, cfg)
            want = llama._block(x, layer, sin, cos, plain_cfg)
            # rows past each prompt's end are padding the pooling drops
            valid = [(got[i, :n] - want[i, :n], want[i, :n] - x[i, :n])
                     for i, n in enumerate(lens)]
            rel = (torch.cat([d.flatten() for d, _ in valid]).float().norm()
                   / torch.cat([u.flatten() for _, u in valid]).float()
                   .norm()).item()
            worst = max(worst, rel)
            if not np.isfinite(rel) or rel > 3e-2:
                raise AssertionError(f"layer {li}: flash block vs plain "
                                     f"attention block relative error {rel}")
            x = got
    vecs = Embedder(params, cfg).embed(prompts)
    ref = Embedder(params, plain_cfg).embed(prompts)
    cos_sim = (vecs * ref).sum(-1)
    if not np.isfinite(cos_sim).all() or cos_sim.min() < 0.9:
        raise AssertionError(f"flash vs plain attention embeddings: cosine "
                             f"{cos_sim}")
    return {"block_rel_err_max": worst, "cos_vs_plain": cos_sim.tolist()}


def device_kernels(ka):
    """(name, device ms, count) of every kernel in a profile, longest first.
    GPU user annotations (``Optimizer.step#...``) span kernels that are
    listed on their own, so they are left out of the sum."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in ka if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])


def profile_decode(params, cfg, dev, prompts, out_dir, n_steps=8):
    """One profiled window of greedy decode steps (bf16 cache): wall time,
    the device's busy and idle share, and where host and device time go."""
    from torch.profiler import ProfilerActivity, profile
    from kubetorch_tpu_torch.models import Generator

    gen = Generator(params, cfg)
    B = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    Pmax = int(lens.max())
    toks = torch.zeros((B, Pmax), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    win = torch.full((B, 64), -1, dtype=torch.long, device=dev)
    kw = dict(n_steps=n_steps, temperature=0.0, top_k=None, top_p=None,
              eos_id=None, repetition_penalty=1.0)
    with torch.no_grad():
        for attempt in range(2):              # the first is a warm-up
            logits, cache = gen.prefill(toks, lens, Pmax + n_steps)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                gen._decode(cache, logits, lens, None, win, **kw)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    kernels = device_kernels(ka)
    cuda = torch.autograd.DeviceType.CUDA
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in ka if e.device_type != cuda),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    with open(os.path.join(out_dir, "decode_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
    res = {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
           "device_busy_ms_per_step": busy_ms / n_steps,
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "top_kernels_ms_per_step": [(k, t / n_steps, c // n_steps)
                                       for k, t, c in kernels[:8]],
           "top_host_ops_ms_per_step": [(k, t / n_steps, c // n_steps)
                                        for k, t, c in host[:8]]}
    log(f"decode profile: {res['wall_ms_per_step']:.2f} ms/step wall, device "
        f"busy {res['device_busy_ms_per_step']:.2f} ms/step, idle share "
        f"{res['device_idle_share']}")
    for k, t, c in res["top_kernels_ms_per_step"]:
        log(f"  device {t:8.3f} ms/step x{c:<5d} {k[:90]}")
    for k, t, c in res["top_host_ops_ms_per_step"]:
        log(f"  host   {t:8.3f} ms/step x{c:<5d} {k[:90]}")
    return res


def run_embedder(params, cfg, dev, prompts):
    from kubetorch_tpu_torch.models import Embedder
    from kubetorch_tpu_torch.ops import flash_attention as fa

    emb = Embedder(params, cfg)
    emb.embed(prompts)                                        # warm-up
    fa.flash_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = emb.embed(prompts)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.flash_forward.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"embed, expected {cfg.n_layers}")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        emb.embed(prompts)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    norms = np.linalg.norm(vecs, axis=-1)
    if vecs.shape != (len(prompts), cfg.embed_dim) or not np.isfinite(
            vecs).all() or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"bad embeddings: shape {vecs.shape}, norms "
                             f"{norms}")
    blocks = check_embed_blocks(params, cfg, dev, prompts)
    res = {"batch": len(prompts), "lens": [len(p) for p in prompts],
           "padded_len": 2048, "ms_per_call": ms, "first_call_ms": first_ms,
           "flash_launches": launches, **blocks}
    log(f"Embedder: {ms:.1f} ms/call, flash launches {launches}; flash vs "
        f"plain attention: worst block {blocks['block_rel_err_max']:.3g}, "
        f"embedding cosine {min(blocks['cos_vs_plain']):.4f}")
    return res


# --------------------------------------------------------------------------
# phase 4: RollingGenerator (continuous batching)
# --------------------------------------------------------------------------

# the JAX serving bench's B = 64 rung (kubetorch_tpu/bench_serving.py:127)
ROLLING = dict(max_slots=64, max_len=2048, steps_per_call=8,
               prefill_chunk=256)
ROLLING_SAMPLING = dict(top_k=50, top_p=0.9)   # for the temperature-0.8 rows


def traced(fn):
    """Run ``fn()`` under a kernel-only trace (``torch.profiler``, CUDA
    activity) → (its result, {host_ms: host clock to a synchronise,
    device_span_ms: CUDA events around it, device_busy_ms: the kernels'
    summed time, idle_share: 1 − busy/host, kernels: by name})."""
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.key_averages())
    busy = sum(k[1] for k in kernels)
    return out, {"host_ms": host_ms,
                 "device_span_ms": start.elapsed_time(end),
                 "device_busy_ms": busy,
                 "idle_share": (1 - busy / host_ms) if busy else None,
                 "kernels": kernels}


def counted(fn):
    """``fn()`` with the int8 kernel's counter set to 0 just before it and
    read just after → (result, launches)."""
    from kubetorch_tpu_torch.ops import quant_matmul as qm

    qm.int8_matmul.launches = 0
    out = fn()
    return out, qm.int8_matmul.launches


def update_rel(got, want, x):
    """||got − want|| / ||want − x||: a block's disagreement relative to
    its update of the residual stream ``x``."""
    return ((got - want).float().norm() / (want - x).float().norm()).item()


def check_rolling_block(eng, cfg, layers=(0, -1)):
    """One chunk-mode block, then the merge, against ``_block_cached`` on
    the grid with this step's K/V written in, on the live rows' pending
    greedy tokens. The merge is held exactly (bf16 values as written; int8
    bytes and scales as ``_kv_quantize`` gives them); the blocks to
    3e-2 of their update (the int8 grid's ``_block_cached_q`` attends this
    step's K/V quantized, the chunk block attends them in bf16)."""
    from kubetorch_tpu_torch.models import llama

    dev = eng.device
    B, M = eng.max_slots, eng.max_len
    live = torch.from_numpy(eng._active).to(dev)
    pos = torch.from_numpy(eng._pos).to(dev)
    tok = eng._logits.argmax(-1)
    x = eng.params["embedding"][tok[:, None]].to(cfg.compute_dtype)
    sin, cos = llama.rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    m = torch.arange(M, device=dev)[None, None, :]
    gmask = (m < pos[:, None, None]) & live[:, None, None]
    emask = live[:, None, None].clone()
    full_mask = (m <= pos[:, None, None]) & live[:, None, None]
    slices = llama._layer_slices(eng.params["layers"], cfg.n_layers)
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    cdt = torch.bfloat16 if eng.kv_quantized else eng.cache["k"].dtype
    worst = 0.0
    with torch.no_grad():
        for li in layers:
            li = li % cfg.n_layers
            chunk = {n: torch.zeros((cfg.n_layers, B, 1, Hkv, D), dtype=cdt,
                                    device=dev) for n in ("k", "v")}
            got = llama._block_cached_chunk(x, slices[li], li, sin, cos,
                                            eng.cache, chunk, 0, gmask,
                                            emask, cfg)
            one = {n: t[li:li + 1].clone() for n, t in eng.cache.items()}
            counts = eng._active.astype(np.int64)
            llama.merge_chunk_into_grid(
                one, {n: c[li:li + 1] for n, c in chunk.items()}, eng._pos,
                counts)
            rows = np.flatnonzero(eng._active)
            r_t = torch.from_numpy(rows).to(dev)
            p_t = pos[r_t]
            written = {n: t[0, r_t, p_t] for n, t in one.items()}
            if eng.kv_quantized:
                for n in ("k", "v"):
                    q, s = llama._kv_quantize(chunk[n][li, r_t, 0])
                    if not (torch.equal(written[n], q)
                            and torch.equal(written[n + "s"], s)):
                        raise AssertionError(f"layer {li}: int8 grid merge "
                                             f"differs from _kv_quantize")
            elif not all(torch.equal(written[n], chunk[n][li, r_t, 0])
                         for n in ("k", "v")):
                raise AssertionError(f"layer {li}: bf16 grid merge differs "
                                     f"from the chunk")
            block = (llama._block_cached_q if eng.kv_quantized
                     else llama._block_cached)
            want = block(x, slices[li], 0, sin, cos, one, pos, full_mask,
                         cfg)
            rel = update_rel(got[r_t], want[r_t], x[r_t])
            worst = max(worst, rel)
            if not np.isfinite(rel) or rel > 3e-2:
                raise AssertionError(f"layer {li}: chunk-mode block vs "
                                     f"_block_cached relative error {rel}")
            del one, chunk
    return {"rows": int(live.sum()), "layers": list(layers),
            "block_rel_err_max": worst}


def check_prefill_subset(eng, cfg, slot, feed):
    """The next prefill chunk of row ``slot`` run over that row alone
    (``grid_rows``, the int8 kernel) against the same chunk with the row
    inside a full-width batch (dequantized matmuls), block by block on the
    same input: the row's block updates agree to 3e-2 (the kernel against
    the dequantized matmul, as phase 3 holds them)."""
    from kubetorch_tpu_torch.models import llama

    dev = eng.device
    B, M, C = eng.max_slots, eng.max_len, len(feed)
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    cdt = torch.bfloat16 if eng.kv_quantized else eng.cache["k"].dtype
    start = int(eng._pos[slot])
    ar = torch.arange(C, device=dev)
    m = torch.arange(M, device=dev)[None, None, :]
    emask = ar[None, None, :] <= ar[None, :, None]
    pos_all = torch.from_numpy(eng._pos).to(dev)
    toks = torch.zeros((B, C), dtype=torch.long, device=dev)
    toks[slot] = torch.tensor(feed, device=dev)
    counts = torch.zeros(B, dtype=torch.long, device=dev)
    counts[slot] = C
    full = {"positions": pos_all[:, None] + ar[None, :],
            "gmask": ((m < pos_all[:, None, None])
                      & (counts > 0)[:, None, None]).expand(B, C, M),
            "emask": emask & (ar[None, None, :] < counts[:, None, None])}
    one = {"positions": (start + ar)[None, :],
           "gmask": (m < start).expand(1, C, M), "emask": emask}
    for d in (full, one):
        d["sin"], d["cos"] = llama.rope_angles(d["positions"], cfg.head_dim,
                                               cfg.rope_theta)
        d["chunk"] = {n: torch.zeros((cfg.n_layers, d["gmask"].shape[0], C,
                                      Hkv, D), dtype=cdt, device=dev)
                      for n in ("k", "v")}
    rows = torch.tensor([slot], device=dev)
    worst = 0.0
    with torch.no_grad():
        x_full = eng.params["embedding"][toks].to(cfg.compute_dtype)
        x_one = x_full[slot:slot + 1].clone()
        for li, layer in enumerate(llama._layer_slices(
                eng.params["layers"], cfg.n_layers)):
            x_full[slot] = x_one[0]
            y_one, launches = counted(lambda: llama._block_cached_chunk(
                x_one, layer, li, one["sin"], one["cos"], eng.cache,
                one["chunk"], 0, one["gmask"], one["emask"], cfg, rows))
            if launches != 4:
                raise AssertionError(f"one-row chunk block launched the "
                                     f"int8 kernel {launches} times, not 4")
            y_full = llama._block_cached_chunk(
                x_full, layer, li, full["sin"], full["cos"], eng.cache,
                full["chunk"], 0, full["gmask"], full["emask"], cfg)
            rel = update_rel(y_one[0], y_full[slot], x_one[0])
            worst = max(worst, rel)
            if not np.isfinite(rel) or rel > 3e-2:
                raise AssertionError(f"layer {li}: one-row prefill chunk vs "
                                     f"full-width row, relative error {rel}")
            x_one, x_full = y_one, y_full
    del full, one
    return {"slot": slot, "start": start, "chunk": C,
            "block_rel_err_max": worst}


def rolling_request(rng, cfg, n_lo, n_hi):
    return rng.integers(1, cfg.vocab_size,
                        size=int(rng.integers(n_lo, n_hi + 1))).tolist()


def run_rolling(params, cfg, dev, kv_dtype, out_dir):
    """8B rolling decode at the serving bench's B = 64 rung: waves of ragged
    prompts (16-512 tokens, 64 new tokens each; eight rows at temperature
    0.8) admitted while other rows decode, a registered 256-token prefix
    that several requests hit, one 1500-token prompt through chunked
    prefill while other rows decode, and one evict and readmit. Every
    admission, prefill chunk and decode chunk has its int8 launches
    counted and is timed under a kernel-only trace."""
    from kubetorch_tpu_torch.models import RollingGenerator

    L4 = cfg.n_layers * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = RollingGenerator(params, cfg, kv_dtype=kv_dtype, seed=SEED,
                           **ROLLING, **ROLLING_SAMPLING)
    C, K = eng.prefill_chunk, eng.steps_per_call
    rng = np.random.default_rng(SEED + 10)
    prefix = rng.integers(1, cfg.vocab_size, size=256).tolist()
    pid, prefix_launches = counted(lambda: eng.register_prefix(prefix))
    if prefix_launches != L4:
        raise AssertionError(f"prefix fill launched {prefix_launches}, "
                             f"want {L4}")
    probe = rolling_request(rng, cfg, 100, 100)
    long_prompt = rolling_request(rng, cfg, 1500, 1500)

    def wave(n, n_prefixed=0, n_sampled=0, hi=512):
        reqs = []
        for i in range(n):
            if i < n_prefixed:
                reqs.append(dict(prompt=rolling_request(rng, cfg, 16, 64),
                                 prefix_id=pid))
            else:
                reqs.append(dict(prompt=rolling_request(rng, cfg, 16, hi)))
            if n_prefixed <= i < n_prefixed + n_sampled:
                reqs[-1]["temperature"] = 0.8
        return reqs

    schedule = {0: wave(24, n_prefixed=4, n_sampled=8), 1: "probe",
                3: wave(24, n_prefixed=3), 4: "evict", 6: "long",
                8: wave(12, hi=256)}
    rid_of = {}
    tokens = {}
    admissions, prefills, decodes = [], [], []
    checks = {}
    tick = 0
    while eng.pending or any(t >= tick for t in schedule):
        todo = schedule.get(tick)
        if todo == "probe":
            rid_of["probe"] = eng.submit(probe, max_new_tokens=64)
        elif todo == "evict":
            first = list(tokens[rid_of["probe"]])
            if not eng.evict(rid_of["probe"]):
                raise AssertionError("probe not found for evict")
            rid_of["probe_first"] = (rid_of["probe"], first)
            rid_of["probe"] = eng.submit(probe, max_new_tokens=64)
        elif todo == "long":
            if eng.prefilling_rows:
                raise AssertionError("rows still prefilling at tick 6")
            rid_of["long"] = eng.submit(long_prompt, max_new_tokens=64)
        elif todo:
            for r in todo:
                rid = eng.submit(r["prompt"], max_new_tokens=64,
                                 temperature=r.get("temperature", 0.0),
                                 prefix_id=r.get("prefix_id"))
                if r.get("temperature"):
                    rid_of.setdefault("sampled", []).append(rid)
        groups = []
        orig_group = eng._admit_group

        def admit_group(group, p_pad, prefix_id=None):
            groups.append((len(group), p_pad, prefix_id))
            return orig_group(group, p_pad, prefix_id)

        eng._admit_group = admit_group
        waiting = eng.active_rows
        (n_adm, launches), tr = traced(lambda: counted(eng.admit))
        del eng._admit_group
        if n_adm:
            want = sum(L4 for n, p, _ in groups if n * p <= 256)
            if launches != want:
                raise AssertionError(f"admission {groups} launched "
                                     f"{launches}, want {want}")
            admissions.append({"tick": tick, "rows": n_adm,
                               "groups": groups, "launches": launches,
                               "ms": tr["host_ms"],
                               "live_rows_waiting": waiting})
        if eng.prefilling_rows:
            if tick == 8 and "long" in rid_of:
                slot = next(s for s, r in eng._prefilling.items()
                            if r.rid == rid_of["long"])
                req = eng._prefilling[slot]
                checks["prefill_subset"] = check_prefill_subset(
                    eng, cfg, slot, req.prompt[req.consumed:
                                               req.consumed + C])
            rows = eng.prefilling_rows
            waiting = eng.active_rows
            holds_long = any(r.rid == rid_of.get("long")
                             for r in eng._prefilling.values())
            (_, launches), tr = traced(lambda: counted(eng.prefill_step))
            want = L4 if rows * C <= 256 else 0
            if launches != want:
                raise AssertionError(f"prefill chunk over {rows} rows "
                                     f"launched {launches}, want {want}")
            if holds_long and launches != L4:
                raise AssertionError("the long prompt's chunk did not take "
                                     "the int8 kernel")
            prefills.append({"tick": tick, "rows": rows, "long": holds_long,
                             "launches": launches,
                             "live_rows_waiting": waiting, **tr})
        if tick == 5:
            checks["block"] = check_rolling_block(eng, cfg)
        live = eng.active_rows
        if live:
            (events, launches), tr = traced(lambda: counted(eng.decode_step))
            if launches != L4 * K:
                raise AssertionError(f"decode chunk launched {launches}, "
                                     f"want {L4 * K}")
            emitted = 0
            for rid, new, _ in events:
                tokens.setdefault(rid, []).extend(new)
                emitted += len(new)
            decodes.append({"tick": tick, "rows": live, "emitted": emitted,
                            "launches": launches,
                            "tokens_per_s": live * K / tr["host_ms"] * 1e3,
                            **tr})
        tick += 1
        if tick > 200:
            raise AssertionError("rolling traffic did not drain")
    # steady state: all rows live; decode chunks alternately traced and
    # not, to show what the trace costs the host
    steady = []
    for _ in range(eng.max_slots):
        eng.submit(rolling_request(rng, cfg, 128, 128), max_new_tokens=4 * K)
    n_adm, launches = counted(eng.admit)
    if n_adm != eng.max_slots or launches != 0:
        raise AssertionError(f"steady admission: {n_adm} rows, {launches} "
                             f"launches")
    for i in range(4):
        rows = eng.active_rows
        if i % 2 == 0:
            (events, launches), tr = traced(lambda: counted(eng.decode_step))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events, launches = counted(eng.decode_step)
            torch.cuda.synchronize()
            tr = {"host_ms": (time.perf_counter() - t0) * 1e3}
        if launches != L4 * K or sum(len(n) for _, n, _ in events) != rows * K:
            raise AssertionError(f"steady decode chunk: {launches} launches")
        steady.append({"traced": i % 2 == 0, "rows": rows,
                       "launches": launches,
                       "tokens_per_s": rows * K / tr["host_ms"] * 1e3,
                       **{k: v for k, v in tr.items() if k != "kernels"}})
    if eng.pending:
        raise AssertionError("steady requests did not finish")
    peak = torch.cuda.max_memory_allocated(dev)

    # the readmitted probe: admitted alone both times, it must emit what the
    # first admission emitted before its eviction
    old_rid, first = rid_of["probe_first"]
    again = tokens[rid_of["probe"]]
    if not first or again[:len(first)] != first:
        raise AssertionError(f"readmitted probe {again[:len(first)]} vs "
                             f"first admission {first}")
    done = [t for rid, t in tokens.items() if rid != old_rid]
    if any(len(t) != 64 for t in done) or not all(
            0 <= x < cfg.vocab_size for t in tokens.values() for x in t):
        raise AssertionError("rolling outputs: wrong lengths or ids")

    def top(rows):
        return [(k, t, c) for k, t, c in rows[:8]]

    prof_decode = max(decodes, key=lambda d: d["rows"])
    prof_prefill = next((p for p in prefills if p["long"]), prefills[0])
    total = {"prefix_fill": prefix_launches,
             "admit": sum(a["launches"] for a in admissions),
             "prefill": sum(p["launches"] for p in prefills),
             "decode": sum(d["launches"] for d in decodes + steady)}
    res = {"kv_dtype": kv_dtype, **ROLLING, "requests": len(tokens),
           "ticks": tick, "int8_launches": total,
           "int8_launches_total": sum(total.values()),
           "peak_mem_gib": peak / 2 ** 30, "checks": checks,
           "readmit": {"tokens_compared": len(first)},
           "admissions": admissions,
           "prefill_chunks": [{k: v for k, v in p.items() if k != "kernels"}
                              for p in prefills],
           "decode_chunks": [{k: v for k, v in d.items() if k != "kernels"}
                             for d in decodes],
           "steady_decode_chunks": steady,
           "top_kernels_decode_chunk": {"tick": prof_decode["tick"],
                                        "kernels": top(prof_decode[
                                            "kernels"])},
           "top_kernels_prefill_chunk": {"tick": prof_prefill["tick"],
                                         "kernels": top(prof_prefill[
                                             "kernels"])},
           "sampled_rows": len(rid_of.get("sampled", []))}
    return eng, res


def rolling_sampling_check(params, cfg, dev, kv_dtype):
    """Eight temperature-0.8 rows beside eight greedy rows, run twice on
    fresh engines with the same seed and traffic: the same tokens both
    times, and every sampled token inside ``filter_logits``' support at its
    step (recorded from the engine's own filter call)."""
    from kubetorch_tpu_torch.models import RollingGenerator, rolling

    def run(record):
        eng = RollingGenerator(params, cfg, kv_dtype=kv_dtype, seed=SEED,
                               **ROLLING, **ROLLING_SAMPLING)
        rng = np.random.default_rng(SEED + 20)
        rids = [eng.submit(rolling_request(rng, cfg, 16, 128),
                           max_new_tokens=32,
                           temperature=0.8 if i % 2 else 0.0)
                for i in range(16)]
        draws = []
        if record:
            plain_filter, plain_sample = rolling.filter_logits, eng._sample
            filtered = []

            def recording_filter(logits, top_k=None, top_p=None):
                filtered.append(plain_filter(logits, top_k, top_p))
                return filtered[-1]

            def recording_sample(logits, temps):
                tok = plain_sample(logits, temps)
                draws.append((torch.isfinite(
                    filtered[-1][torch.arange(len(tok), device=dev), tok])
                    | (temps <= 0)).all().item())
                filtered.clear()
                return tok

            rolling.filter_logits = recording_filter
            eng._sample = recording_sample
        try:
            out = eng.run()
        finally:
            if record:
                rolling.filter_logits = plain_filter
                del eng._sample
        del eng
        torch.cuda.empty_cache()
        return [out[r] for r in rids], draws

    first, _ = run(False)
    again, draws = run(True)
    if again != first:
        raise AssertionError("sampled rolling run did not reproduce under "
                             "one seed")
    if not draws or not all(draws):
        raise AssertionError(f"sampled tokens outside filter_logits' "
                             f"support at {draws.count(False)} of "
                             f"{len(draws)} steps")
    if not all(0 <= t < cfg.vocab_size for toks in first for t in toks):
        raise AssertionError("sampled token ids out of range")
    return {"rows": 16, "sampled_rows": 8, "steps_checked": len(draws),
            "reproduced": True}


def share(x):
    return "not measured" if x is None else f"{x:.3f}"


def report_rolling(res, smi):
    """The rolling phase's lines, each tagged with the card's name and
    power limit."""
    tag = f"[{smi}]"
    log(f"RollingGenerator kv={res['kv_dtype']} B={res['max_slots']} "
        f"max_len={res['max_len']}: {res['requests']} requests in "
        f"{res['ticks']} ticks, int8 launches {res['int8_launches']}, peak "
        f"{res['peak_mem_gib']:.2f} GiB; checks {json.dumps(res['checks'])};"
        f" sampling {json.dumps(res['sampling'])} {tag}")
    for d in res["decode_chunks"]:
        log(f"  decode  tick {d['tick']:3d}: {d['rows']:2d} rows, "
            f"{d['emitted']:3d} tokens, host {d['host_ms']:8.2f} ms, device "
            f"span {d['device_span_ms']:8.2f} ms, busy "
            f"{d['device_busy_ms']:8.2f} ms, idle share "
            f"{share(d['idle_share'])}, {d['tokens_per_s']:.1f} tok/s {tag}")
    for d in res["steady_decode_chunks"]:
        busy = (f"busy {d['device_busy_ms']:8.2f} ms, idle share "
                f"{share(d['idle_share'])}" if d["traced"] else "untraced")
        log(f"  steady decode, {d['rows']} rows: host {d['host_ms']:8.2f} "
            f"ms, {busy}, {d['tokens_per_s']:.1f} tok/s {tag}")
    for p in res["prefill_chunks"]:
        log(f"  prefill tick {p['tick']:3d}: {p['rows']:2d} rows"
            f"{' (long prompt)' if p['long'] else ''}, host "
            f"{p['host_ms']:8.2f} ms, device span "
            f"{p['device_span_ms']:8.2f} ms, busy "
            f"{p['device_busy_ms']:8.2f} ms, idle share "
            f"{share(p['idle_share'])}, int8 launches {p['launches']}; "
            f"{p['live_rows_waiting']} live rows waited {tag}")
    for a in res["admissions"]:
        log(f"  admit   tick {a['tick']:3d}: {a['rows']:2d} rows "
            f"{a['groups']}, {a['ms']:.1f} ms, int8 launches "
            f"{a['launches']}; {a['live_rows_waiting']} live rows waited "
            f"{tag}")
    for what in ("decode", "prefill"):
        top = res[f"top_kernels_{what}_chunk"]
        log(f"  top device kernels, {what} chunk at tick {top['tick']} {tag}:")
        for k, t, c in top["kernels"]:
            log(f"    {t:9.3f} ms x{c:<5d} {k[:90]}")


# --------------------------------------------------------------------------
# phase 5: DecodeEngine (server-side serving over the rolling engine)
# --------------------------------------------------------------------------

ENGINE_PROGRAMS = 40      # in two waves of 20
ENGINE_NEW = 128          # new tokens a program
ENGINE_SESSIONS = 8       # programs parked after >= 32 tokens and resumed
ENGINE_PREFIX = 256       # shared system prefix, split by "len:256"


def record_dispatches(inner):
    """Log every forward dispatch the rolling engine makes (kind, rows,
    tokens a forward, forwards): the engine's own tick record, from which
    the int8 launches follow (n_layers × 4 a forward of ≤ 256 tokens)."""
    log = []

    def wrap(name, shape_of, forwards=lambda *a: 1):
        plain = getattr(inner, name)

        def recorded(*args):
            rows, tokens = shape_of(*args)
            log.append((name, rows, tokens, forwards(*args)))
            return plain(*args)

        setattr(inner, name, recorded)

    wrap("_prefill_impl", lambda toks, lens, slots: toks.shape)
    wrap("_prefix_fill_impl", lambda toks, n: toks.shape)
    wrap("_prefill_px_impl", lambda planes, n, toks, lens, slots: toks.shape)
    wrap("_prefill_extend_impl", lambda rows, feed, c, f: feed.shape)
    wrap("_decode_impl", lambda n: (inner.max_slots, 1), lambda n: n)
    return log


def expected_int8_launches(log, L4):
    return sum(L4 * fwd for _, rows, tokens, fwd in log
               if rows * tokens <= 256)


def leaves_equal(a, b):
    """Byte equality of two exported trees (CPU tensors)."""
    from kubetorch_tpu_torch.data_store.device_transfer import tree_flatten

    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    if sa != sb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.numel() and not torch.equal(x.view(torch.uint8),
                                         y.view(torch.uint8)):
            return False
    return True


def run_engine(params, cfg, dev, kv_dtype, store_dir):
    """8B serving through ``DecodeEngine`` over ``RollingGenerator`` (the
    rolling phase's B = 64 rung): 40 programs of 128 greedy tokens in two
    waves of 20 (the second admitted while the first decodes), every prompt
    a shared 256-token system prefix (split by ``len:256``, so the engine
    shares it) plus a 16-64-token user turn; 8 of them are sessions parked
    through the local store after >= 32 tokens and resumed. Then one
    session parked and resumed alone against the same program unparked.
    Every forward the engine dispatches is logged, and the int8 launches
    are held to that log."""
    from kubetorch_tpu_torch.data_store import device_transfer
    from kubetorch_tpu_torch.models import RollingGenerator
    from kubetorch_tpu_torch.ops import quant_matmul as qm
    from kubetorch_tpu_torch.serving import kvpool
    from kubetorch_tpu_torch.serving.engine import DecodeEngine

    L4 = cfg.n_layers * 4
    os.environ["KT_LOCAL_STORE"] = store_dir
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    inner = RollingGenerator(params, cfg, kv_dtype=kv_dtype, seed=SEED,
                             **ROLLING)
    log = record_dispatches(inner)
    rng = np.random.default_rng(SEED + 30)
    system = rng.integers(1, cfg.vocab_size, size=ENGINE_PREFIX).tolist()
    prompts = [system + rolling_request(rng, cfg, 16, 64)
               for _ in range(ENGINE_PROGRAMS)]
    sessions = set(range(0, ENGINE_PROGRAMS, ENGINE_PROGRAMS
                         // ENGINE_SESSIONS))
    parks, blobs, restores = [], [], []
    plain_offload, plain_restore = (kvpool.offload_session,
                                    kvpool.restore_session)

    def offload(session_id, state, quantized=False):
        # the blob as it landed is kept and compared with the export after
        # the traffic (the engine drops it when the session completes)
        t0, wall0 = time.perf_counter(), time.time()
        key = plain_offload(session_id, state, quantized)
        publish_ms = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(store_dir, key), "rb") as f:
            blob = f.read()
        blobs.append({"session": session_id, "publish_ms": publish_ms,
                      "wall": (wall0, time.time()), "blob": blob,
                      "state": state})
        return key

    def restore(session_id):
        t0 = time.perf_counter()
        state = plain_restore(session_id)
        if state is not None:
            restores.append({"session": session_id, "fetch_ms":
                             (time.perf_counter() - t0) * 1e3})
        return state

    plain_import = inner.import_row
    imports = []

    def import_row(state, block_tokens=None):
        t0 = time.perf_counter()
        rid = plain_import(state, block_tokens)
        torch.cuda.synchronize()
        imports.append((time.perf_counter() - t0) * 1e3)
        return rid

    inner.import_row = import_row
    kvpool.offload_session, kvpool.restore_session = offload, restore
    eng = DecodeEngine(inner, prefix_split=f"len:{ENGINE_PREFIX}")
    results = {}

    errors = []
    first_wave = threading.Event()
    first_wave_tokens = []      # one entry a token, appended by clients

    def client(i):
        try:
            run_program(i)
        except BaseException as exc:  # surfaced after the join
            errors.append((i, exc))
            first_wave.set()

    def run_program(i):
        sid = f"smoke-{kv_dtype}-{i}" if i in sessions else None
        prog = {"prompt": prompts[i], "max_new_tokens": ENGINE_NEW}
        if sid:
            prog["session_id"] = sid
        t0 = time.perf_counter()
        toks, ttft, parked = [], None, False
        for frame in eng.generate(prog):
            if frame["tokens"] and ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            toks += frame["tokens"]
            if i < ENGINE_PROGRAMS // 2:
                first_wave_tokens.extend(frame["tokens"])
                if len(first_wave_tokens) >= ENGINE_PROGRAMS // 2 * 32:
                    first_wave.set()
            if sid and not parked and len(toks) >= 32:
                p0 = time.perf_counter()
                n = eng.park(sid)
                parks.append({"session": sid, "rows": n, "at_tokens":
                              len(toks), "ms": (time.perf_counter() - p0)
                              * 1e3})
                parked = True
        resume_ms = None
        if sid:
            r0 = time.perf_counter()
            for frame in eng.generate(prog):
                if frame["tokens"] and resume_ms is None:
                    resume_ms = (time.perf_counter() - r0) * 1e3
                toks += frame["tokens"]
        results[i] = {"tokens": toks, "ttft_ms": ttft,
                      "resume_first_token_ms": resume_ms,
                      "done_s": time.perf_counter()}

    seq0 = eng._flight.seq if eng._flight is not None else 0
    qm.int8_matmul.launches = 0
    t_start = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(ENGINE_PROGRAMS)]
        for t in threads[:ENGINE_PROGRAMS // 2]:
            t.start()
        # the second wave arrives while the first decodes: once the first
        # has 32 tokens a program on average
        first_wave.wait(timeout=600)
        for t in threads[ENGINE_PROGRAMS // 2:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t_start
        if errors:
            raise AssertionError(f"program {errors[0][0]} failed") \
                from errors[0][1]
        if len(results) != ENGINE_PROGRAMS:
            raise AssertionError(f"{ENGINE_PROGRAMS - len(results)} "
                                 f"programs did not finish")
        with eng._wake:
            stats = eng.stats()
        launches = qm.int8_matmul.launches
        traffic_log = list(log)
        flight_recs = (eng._flight.snapshot(since_seq=seq0 - 1)
                       if eng._flight is not None else [])

        # one session parked and resumed alone vs. the program unparked
        alone = system + rolling_request(rng, cfg, 40, 40)
        ref = [t for f in eng.generate({"prompt": alone,
                                        "max_new_tokens": ENGINE_NEW})
               for t in f["tokens"]]
        sid = f"smoke-{kv_dtype}-alone"
        got, parked = [], 0
        for frame in eng.generate({"prompt": alone, "session_id": sid,
                                   "max_new_tokens": ENGINE_NEW}):
            got += frame["tokens"]
            if len(got) >= 32 and not parked:
                parked = eng.park(sid)
        if parked != 1:
            raise AssertionError("lone session did not park")
        got += [t for f in eng.generate({"prompt": alone,
                                         "session_id": sid,
                                         "max_new_tokens": ENGINE_NEW})
                for t in f["tokens"]]
        if got != ref:
            raise AssertionError("parked+resumed session differs from the "
                                 "same program unparked")
        total_launches = qm.int8_matmul.launches
    finally:
        eng.close()
        kvpool.offload_session, kvpool.restore_session = (plain_offload,
                                                          plain_restore)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)

    # hard checks
    want = expected_int8_launches(traffic_log, L4)
    if launches != want:
        raise AssertionError(f"engine traffic launched the int8 kernel "
                             f"{launches} times, its dispatch record "
                             f"implies {want}")
    if total_launches != expected_int8_launches(log, L4):
        raise AssertionError("the lone-session check's int8 launches "
                             "disagree with its dispatch record")
    decodes = sum(1 for r in traffic_log if r[0] == "_decode_impl")
    chunks = sum(1 for r in traffic_log if r[0] == "_prefill_extend_impl")
    if decodes != stats["steps"] or chunks != stats["prefill_chunks"]:
        raise AssertionError(f"dispatch record ({decodes} decode, {chunks} "
                             f"prefill chunks) vs engine stats {stats}")
    if not (stats["parks"] == stats["restores"] == ENGINE_SESSIONS):
        raise AssertionError(f"parks {stats['parks']}, restores "
                             f"{stats['restores']}, want {ENGINE_SESSIONS}")
    for b in blobs:
        back = device_transfer.unpack_arrays(b["blob"], template=b["state"])
        if not leaves_equal(b["state"], back):
            raise AssertionError(f"the parked blob of {b['session']} did "
                                 f"not read back byte for byte")
    if any(len(r["tokens"]) != ENGINE_NEW or not all(
            0 <= t < cfg.vocab_size for t in r["tokens"])
            for r in results.values()):
        raise AssertionError("a program did not end with its full token "
                             "count")
    if stats["prefix_cache_hits"] < 1:
        raise AssertionError("no program hit the shared prefix")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs, np.float64), q))

    ttft = [r["ttft_ms"] for r in results.values()]
    tokens = sum(len(r["tokens"]) for r in results.values())
    ticks = [r["tick_s"] * 1e3 for r in flight_recs]

    def during_publish(rec):
        end = rec["t_wall"]
        return any(a < end and b > end - rec["tick_s"]
                   for a, b in (x["wall"] for x in blobs))

    busy = [r["tick_s"] * 1e3 for r in flight_recs
            if r["decode_tokens"] and during_publish(r)]
    quiet = [r["tick_s"] * 1e3 for r in flight_recs
             if r["decode_tokens"] and not during_publish(r)]
    return {
        "kv_dtype": kv_dtype, **ROLLING, "programs": ENGINE_PROGRAMS,
        "new_tokens": ENGINE_NEW, "sessions": ENGINE_SESSIONS,
        "tokens": tokens, "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "ttft_ms_median": pct(ttft, 50), "ttft_ms_p90": pct(ttft, 90),
        "park_ms": [p["ms"] for p in parks],
        "parked_at_tokens": [p["at_tokens"] for p in parks],
        "park_publish_ms": [b["publish_ms"] for b in blobs],
        "restore_fetch_ms": [r["fetch_ms"] for r in restores],
        "restore_import_ms": imports,
        "resume_first_token_ms": [r["resume_first_token_ms"]
                                  for r in results.values()
                                  if r["resume_first_token_ms"]],
        "blob_bytes": [len(b["blob"]) for b in blobs],
        "export_bytes": [sum(t.numel() * t.element_size() for t in
                             device_transfer.tree_flatten(b["state"])[0])
                         for b in blobs],
        "blobs_read_back_equal": len(blobs),
        "peak_mem_gib": peak / 2 ** 30,
        "int8_launches": launches, "int8_launches_total": total_launches,
        "dispatches": len(traffic_log),
        "decode_chunks": stats["steps"],
        "prefill_chunks": stats["prefill_chunks"],
        "tick_ms_median": pct(ticks, 50) if ticks else None,
        # decode ticks that overlapped a park's publish, and the others
        "tick_ms_median_during_publish": pct(busy, 50) if busy else None,
        "tick_ms_median_otherwise": pct(quiet, 50) if quiet else None,
        "ticks_during_publish": len(busy),
        # where the wall goes: the driver's ticks (flight records) split
        # into dispatch walls (prefill and decode chunks) and the rest
        "ticks": len(flight_recs),
        "tick_s_sum": sum(r["tick_s"] for r in flight_recs),
        "dispatch_s_sum": sum(r["device_s"] for r in flight_recs),
        "decode_s": stats["device_s"],
        # the engine's analytic MFU/MBU over its last tick, and the
        # allocator's bytes at the end of the traffic
        "last_tick_mfu_mbu": (stats.get("mfu"), stats.get("mbu")),
        "hbm_used_bytes": stats.get("hbm_used_bytes"),
        "counters": {k: stats[k] for k in (
            "parks", "restores", "prefix_cache_hits", "prefixes",
            "admitted_rows", "prefill_tokens_executed",
            "prefill_tokens_naive", "prefill_tokens_saved_ratio")},
        "lone_session_tokens_compared": len(ref),
    }


def report_engine(res, smi):
    tag = f"[{smi}]"
    log(f"DecodeEngine kv={res['kv_dtype']} B={res['max_slots']}: "
        f"{res['programs']} programs x {res['new_tokens']} tokens "
        f"({res['sessions']} parked and resumed) in {res['wall_s']:.2f} s, "
        f"{res['tokens_per_s']:.1f} tok/s, TTFT median "
        f"{res['ttft_ms_median']:.1f} ms p90 {res['ttft_ms_p90']:.1f} ms, "
        f"{res['decode_chunks']} decode / {res['prefill_chunks']} prefill "
        f"chunks, int8 launches {res['int8_launches']} (= the dispatch "
        f"record), peak {res['peak_mem_gib']:.2f} GiB {tag}")
    def ms(xs):
        return [round(x, 1) for x in xs]

    log(f"  park ms (park() wall) {ms(res['park_ms'])}, of which publish "
        f"{ms(res['park_publish_ms'])}; restore fetch ms "
        f"{ms(res['restore_fetch_ms'])}, import ms "
        f"{ms(res['restore_import_ms'])}, resume first token ms "
        f"{ms(res['resume_first_token_ms'])}; blob bytes "
        f"{res['blob_bytes']} ({res['blobs_read_back_equal']} read back "
        f"byte for byte) {tag}")
    log(f"  {res['ticks']} driver ticks: {res['tick_s_sum']:.2f} s, of "
        f"which dispatch {res['dispatch_s_sum']:.2f} s (decode "
        f"{res['decode_s']:.2f} s), median tick "
        f"{res['tick_ms_median']:.1f} ms ({res['ticks_during_publish']} "
        f"decode ticks beside a park's publish: median "
        f"{share(res['tick_ms_median_during_publish'])} ms, the others "
        f"{share(res['tick_ms_median_otherwise'])} ms); counters "
        f"{res['counters']} {tag}")


# --------------------------------------------------------------------------
# phase 7: Trainer
# --------------------------------------------------------------------------

def train_flops_per_token(cfg, seq: int) -> float:
    """Matmul model-flops per token, forward and backward (the JAX package's
    bench.py count): 6·N over the non-embedding-lookup params plus causal
    attention's 6·L·S·H·D."""
    from kubetorch_tpu_torch.models import llama

    n = llama.num_params(cfg)
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.embed_dim
    return 6 * n + 6 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim


def check_train_blocks(params, cfg, dev, tokens):
    """Every block's gradients (its input's and its weights') with the flash
    kernels held against the same block with plain f32 attention, on the
    kernel path's activations (layer 0 takes the embedded batch) and one
    seeded output cotangent. The kernels round p and ds to bf16, the plain
    path keeps them in f32: a few 1e-3 of each gradient's norm; the bound
    is 5e-2 relative L2."""
    from kubetorch_tpu_torch.models import llama

    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        x = params["embedding"][tokens].to(cfg.compute_dtype)
        pos = torch.arange(tokens.shape[1], device=dev)[None, :]
        sin, cos = llama.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    worst = {}
    for li, layer in enumerate(llama._layer_slices(params["layers"],
                                                   cfg.n_layers)):
        gy = torch.randn(x.shape, generator=gen, device=dev,
                         dtype=x.dtype)
        grads = []
        for c in (cfg, plain_cfg):
            w = {k: t.detach().requires_grad_() for k, t in layer.items()}
            xin = x.detach().requires_grad_()
            y = llama._block(xin, w, sin, cos, c)
            names = ["x"] + sorted(w)
            gs = torch.autograd.grad(y, [xin] + [w[n] for n in names[1:]],
                                     gy)
            grads.append((y.detach(), dict(zip(names, gs))))
        (y, got), (_, want) = grads
        for name in want:
            rel = ((got[name].float() - want[name].float()).norm()
                   / want[name].float().norm()).item()
            worst[name] = max(worst.get(name, 0.0), rel)
            if not np.isfinite(rel) or rel > 5e-2:
                raise AssertionError(f"layer {li}: d{name} with the flash "
                                     f"kernels vs plain attention: relative "
                                     f"L2 {rel} > 5e-2")
        x = y
        del grads, got, want
    return worst


def profile_train_step(trainer, batch, out_dir):
    """One profiled training step: wall time, the device's busy and idle
    share, and where device time goes."""
    from torch.profiler import ProfilerActivity, profile

    trainer.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step(batch)["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    kernels = device_kernels(ka)
    busy_ms = sum(r[1] for r in kernels)
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=50))
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "top_kernels_ms": [(k, t, c) for k, t, c in kernels[:10]]}
    log(f"train step profile: {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms, idle share {res['device_idle_share']}")
    for k, t, c in res["top_kernels_ms"]:
        log(f"  device {t:9.3f} ms x{c:<5d} {k[:90]}")
    return res


def run_training(dev, out_dir, cfg=None, B=4, S=2048):
    from kubetorch_tpu_torch.models import LlamaConfig
    from kubetorch_tpu_torch.ops import flash_attention as fa
    from kubetorch_tpu_torch.training import Trainer, lm_batches

    cfg = cfg or LlamaConfig.llama3_1b(remat=True, remat_policy="dots_no_mlp",
                                       xent_chunk=4096)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, optimizer=functools.partial(
        torch.optim.AdamW, lr=1e-4, weight_decay=1e-4), seed=SEED,
        device=dev)
    torch.cuda.synchronize()
    log(f"trainer ({cfg.embed_dim} wide, {cfg.n_layers} layers) made in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB")
    corpus = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, 4_000_000).astype(np.int32)
    batches = lm_batches(corpus, B, S, seed=SEED)
    batch = next(batches)

    # "dots_no_mlp" checkpoints the attention, so its backward re-runs the
    # flash forward: 2 forward launches per layer per step
    per_step = {"dq": cfg.n_layers, "dkv": cfg.n_layers,
                "fwd": 2 * cfg.n_layers}
    n_warm, n_timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_forward.launches = 0
    fa.flash_backward.dq_launches = fa.flash_backward.dkv_launches = 0
    bench = trainer.benchmark(batch, n_steps=n_timed, warmup=n_warm)
    launches = {"dq": fa.flash_backward.dq_launches,
                "dkv": fa.flash_backward.dkv_launches,
                "fwd": fa.flash_forward.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = n_warm + n_timed
    if launches != {k: n * n_steps for k, n in per_step.items()}:
        raise AssertionError(f"{n_steps} training steps launched {launches},"
                             f" expected {per_step} per step")
    losses = [bench["loss"]]
    for _ in range(3):
        losses.append(float(trainer.step(next(batches))["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    step_s = bench["step_time_s"]
    flops_tok = train_flops_per_token(cfg, S)
    mfu = bench["tokens_per_sec"] * flops_tok / BF16_FLOPS
    blocks = check_train_blocks(trainer.state["params"], cfg, dev,
                                torch.as_tensor(batch["inputs"], device=dev))
    prof = profile_train_step(trainer, batch, out_dir)
    res = {"config": (f"d{cfg.embed_dim} L{cfg.n_layers} remat="
                      f"{cfg.remat_policy} xent_chunk={cfg.xent_chunk}"),
           "batch": B, "seq": S, "optimizer": "AdamW(lr=1e-4, wd=1e-4)",
           "step_ms": step_s * 1e3, "tokens_per_s": bench["tokens_per_sec"],
           "flops_per_token": flops_tok, "mfu": mfu,
           "peak_mem_gib": peak / 2 ** 30, "losses": losses,
           "launches": launches, "launches_per_step": per_step,
           "block_grad_rel_l2_max": blocks, "profile": prof}
    log(f"Trainer {res['config']} B={B} S={S}: {res['step_ms']:.1f} ms/step, "
        f"{res['tokens_per_s']:.0f} tok/s, MFU {mfu:.3f} (989 TFLOP/s), "
        f"peak {res['peak_mem_gib']:.2f} GiB, losses "
        f"{[round(x, 4) for x in losses]}, launches {launches}; block grads "
        f"vs plain attention: worst {max(blocks.values()):.3g}")
    return res


# --------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                        help="directory for the detailed results")
    out_dir = parser.parse_args().out
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kubetorch_tpu_torch.models import LlamaConfig, quant
    from kubetorch_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    build_s = _build.build_all()
    log(f"kernels built in {build_s:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"  ptxas {name}: {line.strip()}")
    sass = sass_counts(_build)

    cfg = LlamaConfig.llama3_8b()
    # 2. kernels against plain versions
    int8_rows = check_int8_matmul(dev, cfg)
    flash_rows = check_flash(dev)
    bwd_rows, bwd_strided = check_flash_backward(dev)
    torch.cuda.empty_cache()

    # 3. Generator at full width and depth
    t0 = time.perf_counter()
    params = quant.init_quantized(SEED, cfg, fuse=True)
    torch.cuda.synchronize()
    log(f"Llama-3-8B int8 params made in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(SEED)
    lens = [128] + rng.integers(16, 129, size=7).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    gen_rows = [run_generator(params, cfg, dev, prompts, kv, 32)
                for kv in ("bf16", "int8")]
    os.makedirs(out_dir, exist_ok=True)
    decode_prof = profile_decode(params, cfg, dev, prompts, out_dir)

    # 4. RollingGenerator at full width and depth, on both grids
    rolling_rows = []
    for kv in ("bf16", "int8"):
        eng, res = run_rolling(params, cfg, dev, kv, out_dir)
        del eng
        torch.cuda.empty_cache()
        res["sampling"] = rolling_sampling_check(params, cfg, dev, kv)
        gc.collect()
        torch.cuda.empty_cache()
        report_rolling(res, smi)
        rolling_rows.append(res)

    # 5. DecodeEngine over the rolling engine, on both grids
    engine_rows = []
    store_dir = tempfile.mkdtemp(prefix="kt-smoke-store-")
    try:
        for kv in ("bf16", "int8"):
            res = run_engine(params, cfg, dev, kv, store_dir)
            gc.collect()
            torch.cuda.empty_cache()
            report_engine(res, smi)
            engine_rows.append(res)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    # 6. Embedder on the same weights
    eprompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                for n in (1500, 2048)]
    emb_row = run_embedder(unfused_view(params, cfg), cfg, dev, eprompts)
    del params
    torch.cuda.empty_cache()

    # 7. Trainer on Llama-3 1B at full width
    train_row = run_training(dev, out_dir)

    decode_rows = [r for r in int8_rows if r["B"] == 8]

    def decode_layer(key):
        return sum(r[key] for r in decode_rows)

    layer_bound_ms, layer_bound_by = bound_ms(decode_layer("bytes"),
                                              decode_layer("flops"))

    causal = next(r for r in flash_rows if r["causal"])
    kernels = [
        {"name": "int8_matmul", "route": "cuda",
         "source": "kubetorch_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "kubetorch_tpu/ops/quant_matmul.py:45",
         "launches": gen_rows[0]["int8_launches"] + sum(
             r["int8_launches_total"] for r in rolling_rows + engine_rows),
         "launches_by_path": {
             "generate_bf16_kv": gen_rows[0]["int8_launches"],
             **{f"rolling_{r['kv_dtype']}_kv": r["int8_launches_total"]
                for r in rolling_rows},
             **{f"decode_engine_{r['kv_dtype']}": r["int8_launches_total"]
                for r in engine_rows}},
         "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
         "ms": decode_layer("ms"), "plain_ms": decode_layer("plain_ms"),
         "bound_ms": layer_bound_ms, "bound_by": layer_bound_by,
         "library_ms": decode_layer("library_ms")},
        {"name": "flash_forward", "route": "cuda",
         "source": "kubetorch_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "kubetorch_tpu/ops/flash_attention.py:47",
         "launches": emb_row["flash_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
         "ms": causal["ms"], "plain_ms": causal["plain_ms"],
         "bound_ms": causal["bound_ms"], "bound_by": causal["bound_by"],
         "library_ms": causal["library_ms"]},
    ]
    bwd = next(r for r in bwd_rows if r["causal"])
    for name, key, line in (("flash_backward_dq", "dq", 173),
                            ("flash_backward_dkv", "dkv", 218)):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "kubetorch_tpu_torch/csrc/flash_bwd.cu",
             "replaces": f"kubetorch_tpu/ops/flash_attention.py:{line}",
             "launches": train_row["launches"][key],
             "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
             "ms": bwd[f"{key}_ms"], "plain_ms": bwd["plain_ms"],
             "bound_ms": bwd[f"{key}_bound_ms"],
             "bound_by": bwd[f"{key}_bound_by"],
             "library_ms": bwd["library_ms"]})
    detail = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": _build.build_logs, "sass": sass,
              "int8_matmul": int8_rows, "flash_forward": flash_rows,
              "generator": gen_rows, "decode_profile": decode_prof,
              "rolling": rolling_rows, "decode_engine": engine_rows,
              "embedder": emb_row,
              "flash_backward": bwd_rows,
              "flash_backward_strided": bwd_strided, "trainer": train_row,
              "kernels": kernels,
              "note": ("int8_matmul ms/plain_ms/library_ms/bound_ms: sum "
                       "over one decode layer's four fused projections at "
                       "B=8; flash_forward: causal, B=2 S=2048 Hq=32 Hkv=8 "
                       "D=128; int8_matmul launches: one generate (bf16 "
                       "KV) plus both rolling runs and both DecodeEngine "
                       "runs (launches_by_path); "
                       "flash_backward_dq/dkv: causal, B=4 S=2048 "
                       "Hq=16 Hkv=8 D=128, plain_ms is the plain backward "
                       "(dq, dk and dv together) and library_ms SDPA's "
                       "backward, which also yields all three; launches "
                       "are over the 7 benchmarked training steps")}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
