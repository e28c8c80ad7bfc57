#!/usr/bin/env python3
"""Time the port's kernels against another build of the same C interfaces,
in turns on one NVIDIA GPU.

    python3 kernel_ab.py --other DIR [--other-partition cluster16|same]

``DIR`` holds a ``flash_fwd.cu``, a ``flash_bwd.cu`` and an
``int8_matmul.cu`` (with the ``hopper.cuh`` they include) that export
``kt_flash_fwd``, ``kt_flash_bwd_dq``, ``kt_flash_bwd_dkv`` and
``kt_int8_matmul`` with the signatures of ``kubetorch_tpu_torch/csrc``, for
example an earlier commit's sources::

    for f in flash_fwd.cu flash_bwd.cu int8_matmul.cu hopper.cuh; do
      git show <commit>:kubetorch_tpu_torch/csrc/$f > DIR/$f; done

Both builds use the package's nvcc flags. At the main path's shapes (the
forward at the Embedder's B = 2, S = 2048, 32/8 heads; dq and dk/dv at the
training step's B = 4, S = 2048, 16/8 heads; D = 128, causal and not; the
int8 matmul on the four fused Llama-3-8B decode projections at B = 8 and
64, weights rotated past L2) each kernel is checked against the other
build, then timed in the order other, this, this, other with
``chip_smoke.time_ms``. The other int8 build gets its K splits from
``--other-partition``: ``cluster16`` (default) is the partition of the
earlier cluster-of-16 design, ``same`` this build's. Prints one line per
kernel and one JSON line with every time, the card's name and power limit.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("flash_fwd", "flash_bwd", "int8_matmul")


def build_other(src_dir: str, build_dir: str):
    """{name: CDLL} of the other build, with the launchers' argtypes."""
    from kubetorch_tpu_torch.ops import _build

    os.makedirs(build_dir, exist_ok=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(build_dir, f"{n}.so"), os.path.join(src_dir, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in SOURCES}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_dir}/{n}.cu:\n{log}")
        libs[n] = ctypes.CDLL(os.path.join(build_dir, f"{n}.so"))
    libs["flash_fwd"].kt_flash_fwd.argtypes = (
        [p] * 5 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, p])
    tail = [i] * 6 + [ll] * 12 + [ctypes.c_float, i, p]
    libs["flash_bwd"].kt_flash_bwd_dq.argtypes = [p] * 7 + tail
    libs["flash_bwd"].kt_flash_bwd_dkv.argtypes = [p] * 8 + tail
    libs["int8_matmul"].kt_int8_matmul.argtypes = [p] * 4 + [i] * 7 + [p]
    return libs


def cluster16_splits(b: int, k: int, n: int, sms: int):
    """The K partition of the earlier int8 design (about four blocks per SM,
    up to 16 splits in one non-portable cluster, 64-row multiples)."""
    rows = 8 if b <= 8 else 16 if b <= 16 else 32
    base = -(-b // rows) * -(-n // 128)
    want = max(1, min(-(-4 * sms // base), k // 64, 16))
    per = -(-(-(-k // want)) // 64) * 64
    return -(-k // per), per


def check(err, what):
    if err:
        raise RuntimeError(f"{what} returned {err}")


def stream():
    return torch.cuda.current_stream().cuda_stream


def launch_fwd(lib, q, k, v, out, causal):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    check(lib.kt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], D ** -0.5, int(causal), stream()), "kt_flash_fwd")


def bwd_args(q, k, v, g, lse, delta):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (B, S, T, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *g.stride()[:3]))


def launch_dq(lib, q, k, v, g, lse, delta, dq, causal):
    ins, shape = bwd_args(q, k, v, g, lse, delta)
    check(lib.kt_flash_bwd_dq(*ins, dq.data_ptr(), *shape, 128 ** -0.5,
                              int(causal), stream()), "kt_flash_bwd_dq")


def launch_dkv(lib, q, k, v, g, lse, delta, dk, dv, causal):
    ins, shape = bwd_args(q, k, v, g, lse, delta)
    check(lib.kt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *shape,
                               128 ** -0.5, int(causal), stream()),
          "kt_flash_bwd_dkv")


def launch_int8(lib, x, w, scale, out, splits):
    B, K = x.shape
    check(lib.kt_int8_matmul(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                             out.data_ptr(), B, K, w.shape[1], *splits, 1, 1,
                             stream()), "kt_int8_matmul")


def in_turns(time_ms, fns):
    """{"other": [ms, ms], "this": [ms, ms]} timed other, this, this, other."""
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(time_ms(fns[tag], reps=50))
    return times


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def ab(time_ms, fns, outs):
    """Run both once, compare this build's outputs with the other's, time."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    err = max(rel_err(a, b) for a, b in zip(outs["this"], outs["other"]))
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
    return err, same, in_turns(time_ms, fns)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True,
                        help="directory with the other build's sources")
    parser.add_argument("--other-partition", default="cluster16",
                        choices=("cluster16", "same"),
                        help="K splits the other int8 build is given")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import L2_BYTES, time_ms
    from kubetorch_tpu_torch.ops import flash_attention as fa
    from kubetorch_tpu_torch.ops import quant_matmul as qm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    other = build_other(args.other, os.path.join(ROOT, "kubetorch_tpu_torch",
                                                 "_build", "other"))
    this = {"flash_fwd": fa._lib(), "flash_bwd": fa._bwd_lib(),
            "int8_matmul": qm._lib()}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    res = {"card": card, "other": os.path.abspath(args.other),
           "other_partition": args.other_partition, "rows": []}

    def add(kernel, err, same, times, **info):
        r = {"kernel": kernel, "rel_l2_vs_other": err,
             "identical_to_other": same, "ms": times, **info}
        res["rows"].append(r)
        best = min(r["ms"]["this"])
        rate = (f"{r['bytes'] / best / 1e6:.0f} GB/s" if "bytes" in r
                else f"{r['flops'] / best / 1e9:.1f} TFLOP/s")
        where = (f"{r['proj']} B={r['B']}" if "proj" in r
                 else f"causal={r['causal']}")
        print(f"{kernel} {where}: other {r['ms']['other']} this "
              f"{r['ms']['this']} ms ({rate}), rel L2 vs other {err:.3g}"
              f"{' (identical)' if same else ''}", flush=True)

    for causal in (True, False):
        B, S, Hq, Hkv = 2, 2048, 32, 8
        q, k, v = rnd(B, S, Hq, 128), rnd(B, S, Hkv, 128), rnd(B, S, Hkv, 128)
        outs = {t: (torch.empty_like(q),) for t in ("other", "this")}
        fns = {t: (lambda lib, o: lambda: launch_fwd(lib, q, k, v, o, causal))(
            libs["flash_fwd"], outs[t][0])
            for t, libs in (("other", other), ("this", this))}
        pairs = S * (S + 1) // 2 if causal else S * S
        add("flash_forward", *ab(time_ms, fns, outs), causal=causal, B=B,
            S=S, Hq=Hq, Hkv=Hkv, flops=4.0 * B * Hq * 128 * pairs)
        del q, k, v, outs, fns

        B, S, Hq, Hkv = 4, 2048, 16, 8
        q, k, v, g = (rnd(B, S, Hq, 128), rnd(B, S, Hkv, 128),
                      rnd(B, S, Hkv, 128), rnd(B, S, Hq, 128))
        out, lse = fa.flash_forward(q, k, v, scale=128 ** -0.5, causal=causal)
        delta = fa.flash_bwd_delta(g, out)
        pairs = S * (S + 1) // 2 if causal else S * S
        outs = {t: (torch.empty_like(q),) for t in ("other", "this")}
        fns = {t: (lambda lib, o: lambda: launch_dq(
            lib, q, k, v, g, lse, delta, o, causal))(
            libs["flash_bwd"], outs[t][0])
            for t, libs in (("other", other), ("this", this))}
        add("flash_backward_dq", *ab(time_ms, fns, outs), causal=causal,
            B=B, S=S, Hq=Hq, Hkv=Hkv, flops=3 * 2.0 * B * Hq * 128 * pairs)
        outs = {t: (torch.empty_like(k), torch.empty_like(v))
                for t in ("other", "this")}
        fns = {t: (lambda lib, o: lambda: launch_dkv(
            lib, q, k, v, g, lse, delta, *o, causal))(
            libs["flash_bwd"], outs[t])
            for t, libs in (("other", other), ("this", this))}
        add("flash_backward_dkv", *ab(time_ms, fns, outs), causal=causal,
            B=B, S=S, Hq=Hq, Hkv=Hkv, flops=4 * 2.0 * B * Hq * 128 * pairs)
        del q, k, v, g, out, lse, delta, outs, fns

    # the four fused Llama-3-8B decode projections
    projs = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
             "w_down": (14336, 4096)}
    for proj, (K, N) in projs.items():
        n_w = max(1, -(-3 * L2_BYTES // (K * N)))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_w)]
        scale = ((torch.rand(N, generator=gen, device=dev) + 0.5)
                 * (4.0 / K ** 0.5 / 127.0)).to(torch.bfloat16)
        for B in (8, 64):
            x = rnd(B, K)
            mine = qm.pick_splits(B, K, N, sms)
            theirs = (cluster16_splits(B, K, N, sms)
                      if args.other_partition == "cluster16" else mine)
            outs = {t: (torch.empty(B, N, device=dev, dtype=torch.bfloat16),)
                    for t in ("other", "this")}
            turn = iter(range(10 ** 9))
            fns = {t: (lambda lib, o, sp: lambda: launch_int8(
                lib, x, ws[next(turn) % n_w], scale, o, sp))(
                libs["int8_matmul"], outs[t][0], sp)
                for t, libs, sp in (("other", other, theirs),
                                    ("this", this, mine))}
            # compared on the same weights
            launch_int8(other["int8_matmul"], x, ws[0], scale,
                        outs["other"][0], theirs)
            launch_int8(this["int8_matmul"], x, ws[0], scale,
                        outs["this"][0], mine)
            torch.cuda.synchronize()
            err = rel_err(outs["this"][0], outs["other"][0])
            same = torch.equal(outs["this"][0], outs["other"][0])
            add("int8_matmul", err, same, in_turns(time_ms, fns), proj=proj,
                B=B, K=K, N=N, bytes=K * N + 2 * B * (K + N) + 2 * N,
                splits={"other": theirs[0], "this": mine[0]})
        del ws
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
