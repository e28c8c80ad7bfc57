#!/usr/bin/env python3
"""Time the port's flash forward and dk/dv kernels against another build of
the same C interface, in turns on one NVIDIA GPU.

    python3 flash_ab.py --other DIR

``DIR`` holds a ``flash_fwd.cu`` and a ``flash_bwd.cu`` that export
``kt_flash_fwd`` and ``kt_flash_bwd_dkv`` with the signatures of
``kubetorch_tpu_torch/csrc`` (for example an earlier commit's sources:
``git show <commit>:kubetorch_tpu_torch/csrc/flash_fwd.cu > DIR/flash_fwd.cu``).
Both builds use the package's nvcc flags. At the main path's shapes (the
forward at the Embedder's B = 2, S = 2048, 32/8 heads; dk/dv at the
training step's B = 4, S = 2048, 16/8 heads; D = 128, causal and not) each
kernel is checked against the other build, then timed in the order other,
this, this, other with ``chip_smoke.time_ms``; SDPA's forward is timed
beside them. Prints one JSON line with every time, the card's name and power
limit. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_other(src_dir: str, build_dir: str):
    """{name: CDLL} of the other build, with the launchers' argtypes."""
    from kubetorch_tpu_torch.ops import _build

    os.makedirs(build_dir, exist_ok=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(build_dir, f"{n}.so"), os.path.join(src_dir, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in ("flash_fwd", "flash_bwd")}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_dir}/{n}.cu:\n{log}")
        libs[n] = ctypes.CDLL(os.path.join(build_dir, f"{n}.so"))
    libs["flash_fwd"].kt_flash_fwd.argtypes = (
        [p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, p])
    libs["flash_bwd"].kt_flash_bwd_dkv.argtypes = (
        [p] * 8 + [i] * 6 + [ll] * 12 + [ctypes.c_float, i, p])
    return libs


def launch_fwd(lib, q, k, v, out, causal):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    err = lib.kt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], D ** -0.5, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kt_flash_fwd returned {err}")


def launch_dkv(lib, q, k, v, g, lse, delta, dk, dv, causal):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    err = lib.kt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *g.stride()[:3], D ** -0.5, int(causal),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"kt_flash_bwd_dkv returned {err}")


def in_turns(time_ms, fns):
    """{"other": [ms, ms], "this": [ms, ms]} timed other, this, this, other."""
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(time_ms(fns[tag], reps=50))
    return times


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True,
                        help="directory with the other flash_fwd.cu and "
                             "flash_bwd.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from kubetorch_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    other = build_other(args.other, os.path.join(ROOT, "kubetorch_tpu_torch",
                                                 "_build", "other"))
    this = {"flash_fwd": fa._lib(), "flash_bwd": fa._bwd_lib()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    res = {"card": card, "other": os.path.abspath(args.other), "rows": []}
    for causal in (True, False):
        B, S, Hq, Hkv = 2, 2048, 32, 8
        q, k, v = rnd(B, S, Hq, 128), rnd(B, S, Hkv, 128), rnd(B, S, Hkv, 128)
        outs = {t: torch.empty_like(q) for t in ("other", "this")}
        fns = {"other": lambda: launch_fwd(other["flash_fwd"], q, k, v,
                                           outs["other"], causal),
               "this": lambda: launch_fwd(this["flash_fwd"], q, k, v,
                                          outs["this"], causal)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        err = rel_err(outs["this"], outs["other"])
        times = in_turns(time_ms, fns)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=50)
        pairs = S * (S + 1) // 2 if causal else S * S
        res["rows"].append({"kernel": "flash_forward", "causal": causal,
                            "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                            "rel_l2_vs_other": err, "ms": times,
                            "sdpa_ms": sdpa,
                            "flops": 4.0 * B * Hq * 128 * pairs})
        del q, k, v, qt, kt, vt, outs

        B, S, Hq, Hkv = 4, 2048, 16, 8
        q, k, v, g = (rnd(B, S, Hq, 128), rnd(B, S, Hkv, 128),
                      rnd(B, S, Hkv, 128), rnd(B, S, Hq, 128))
        out, lse = fa.flash_forward(q, k, v, scale=128 ** -0.5, causal=causal)
        delta = fa.flash_bwd_delta(g, out)
        grads = {t: (torch.empty_like(k), torch.empty_like(v))
                 for t in ("other", "this")}

        def dkv_fn(lib, d):
            return lambda: launch_dkv(lib, q, k, v, g, lse, delta, *d, causal)

        fns = {"other": dkv_fn(other["flash_bwd"], grads["other"]),
               "this": dkv_fn(this["flash_bwd"], grads["this"])}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(grads["this"],
                                                 grads["other"]))
        times = in_turns(time_ms, fns)
        pairs = S * (S + 1) // 2 if causal else S * S
        res["rows"].append({"kernel": "flash_backward_dkv", "causal": causal,
                            "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                            "rel_l2_vs_other": err, "ms": times,
                            "flops": 4 * 2.0 * B * Hq * 128 * pairs})
        del q, k, v, g, out, lse, delta, grads
    for r in res["rows"]:
        best = min(r["ms"]["this"])
        print(f"{r['kernel']} causal={r['causal']}: other {r['ms']['other']} "
              f"this {r['ms']['this']} ms ({r['flops'] / best / 1e9:.1f} "
              f"TFLOP/s), rel L2 vs other {r['rel_l2_vs_other']:.3g}",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
