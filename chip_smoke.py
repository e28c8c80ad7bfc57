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
4. ``Embedder`` on the same weights: 2 prompts of 1500 and 2048 tokens,
   which pad to S = 2048 and take the flash kernel in all 32 layers;
5. ``Trainer`` on Llama-3 1B at full width (the JAX package's largest
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
import json
import os
import re
import subprocess
import sys
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
# phase 3: Generator, phase 4: Embedder
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
# phase 5: Trainer
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

    # 4. Embedder on the same weights
    eprompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                for n in (1500, 2048)]
    emb_row = run_embedder(unfused_view(params, cfg), cfg, dev, eprompts)
    del params
    torch.cuda.empty_cache()

    # 5. Trainer on Llama-3 1B at full width
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
         "launches": gen_rows[0]["int8_launches"],
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
              "embedder": emb_row,
              "flash_backward": bwd_rows,
              "flash_backward_strided": bwd_strided, "trainer": train_row,
              "kernels": kernels,
              "note": ("int8_matmul ms/plain_ms/library_ms/bound_ms: sum "
                       "over one decode layer's four fused projections at "
                       "B=8; flash_forward: causal, B=2 S=2048 Hq=32 Hkv=8 "
                       "D=128; flash_backward_dq/dkv: causal, B=4 S=2048 "
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
