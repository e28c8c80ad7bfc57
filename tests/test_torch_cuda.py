"""The torch port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so on a machine with a card and no
JAX it runs without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from kubetorch_tpu_torch.ops import flash_attention as t_fa
from kubetorch_tpu_torch.ops import quant_matmul as t_qm

pytestmark = [pytest.mark.cuda, pytest.mark.level("unit")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# The four fused Llama-3-8B decode projections, and a K that ends in a part
# of the kernel's 64-row stage; the batch chunk is 8, 16 or 32 rows (B = 9
# and 256 cross them); f32 x takes the hi/lo split.
_INT8_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                (4112, 256)]
_INT8_CASES = ([(b, k, n, torch.bfloat16) for b in (1, 8, 9, 64, 256)
                for k, n in _INT8_SHAPES]
               + [(3, 4096, 6144, torch.float32), (1, 14336, 4096, torch.float32),
                  (8, 4096, 6144, torch.float32), (64, 4112, 256, torch.float32),
                  (256, 4096, 4096, torch.float32)])


def _int8_inputs(device, b, k, n, xdtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, k, generator=gen, device=device, dtype=xdtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    scale = ((torch.rand(n, generator=gen, device=device) + 0.5)
             * (4.0 / k ** 0.5 / 127.0)).to(xdtype)
    return x, w, scale


@pytest.mark.parametrize("b,k,n,xdtype", _INT8_CASES)
def test_int8_kernel_matches_plain(cuda_device, b, k, n, xdtype):
    x, w, scale = _int8_inputs(cuda_device, b, k, n, xdtype, b + k + n)
    before = t_qm.int8_matmul.launches
    got = t_qm.int8_matmul(x, w, scale)
    want = t_qm.int8_matmul_plain(x, w, scale)
    assert t_qm.int8_matmul.launches == before + 1
    assert got.dtype == xdtype
    # bf16 x: f32 sums in another order, one bf16 rounding each (one ulp);
    # f32 x: the kernel's hi/lo bf16 split keeps ~16 bits of x (2^-16)
    rtol = 2 ** -7 if xdtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 * want.float().abs().max().item()
                               if xdtype == torch.bfloat16
                               else 1e-4 * want.abs().max().item())


@pytest.mark.parametrize("b,k,n", [(8, 4096, 28672), (64, 14336, 4096)])
def test_int8_kernel_deterministic(cuda_device, b, k, n):
    x, w, scale = _int8_inputs(cuda_device, b, k, n, torch.bfloat16, 40 + b)
    assert torch.equal(t_qm.int8_matmul(x, w, scale),
                       t_qm.int8_matmul(x, w, scale))


def test_int8_kernel_refuses_untiled_shapes(cuda_device):
    x = torch.zeros(2, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, 100, device=cuda_device, dtype=torch.int8)
    with pytest.raises(ValueError, match="N %"):
        t_qm.int8_matmul(x, w, torch.ones(100, device=cuda_device))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(1, 512, h, 128, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16) for h in (8, 2, 2))
    before = t_fa.flash_forward.launches
    out, lse = t_fa.flash_forward(q, k, v, scale=128 ** -0.5, causal=causal)
    assert t_fa.flash_forward.launches == before + 1
    pout, plse = t_fa.flash_forward_plain(q, k, v, scale=128 ** -0.5,
                                          causal=causal)
    # p rounded to bf16 before P·V in the kernel, f32 in the plain version
    torch.testing.assert_close(out.float(), pout.float(), rtol=2e-2,
                               atol=2e-2)
    # scores: exact bf16 products summed in f32 on both sides
    torch.testing.assert_close(lse, plse, rtol=0, atol=2e-3)


def test_flash_kernel_reads_strided_layout(cuda_device):
    """q/k/v as column slices of one fused projection (the model's layout
    before any copy): the kernel reads them through their strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(2, 256, 12, 128, generator=gen, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split([8, 2, 2], dim=2)
    assert not q.is_contiguous()
    out, _ = t_fa.flash_forward(q, k, v, scale=0.1, causal=True,
                                with_lse=False)
    pout, _ = t_fa.flash_forward_plain(q, k, v, scale=0.1, causal=True)
    torch.testing.assert_close(out.float(), pout.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_kernel_refuses_other_head_dims(cuda_device):
    q = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D =="):
        t_fa.flash_forward(q, q, q, scale=1.0, causal=True)


# ------------------------------------------------------------ flash backward

def _bwd_inputs(device, B=2, S=512, Hq=8, Hkv=2, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, S, Hq, 128, generator=gen, device=device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, 128, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    g = torch.randn(B, S, Hq, 128, generator=gen, device=device,
                    dtype=torch.bfloat16)
    return q, k, v, g


def _close(got, want, name):
    """The kernels round p and ds to bf16 before their products and write
    bf16; the plain version keeps f32 until its one final rounding: about a
    percent of the gradient's norm at these shapes."""
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 2e-2, (name, rel)
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(cuda_device, causal):
    q, k, v, g = _bwd_inputs(cuda_device)
    scale = 128 ** -0.5
    out, lse = t_fa.flash_forward(q, k, v, scale=scale, causal=causal)
    before = (t_fa.flash_backward.dq_launches,
              t_fa.flash_backward.dkv_launches)
    got = t_fa.flash_backward(q, k, v, out, lse, g, scale=scale,
                              causal=causal)
    assert (t_fa.flash_backward.dq_launches,
            t_fa.flash_backward.dkv_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = t_fa.flash_backward_plain(q, k, v, out, lse, g, scale=scale,
                                     causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        _close(a, b, name)


def test_flash_backward_kernels_take_external_delta(cuda_device):
    q, k, v, g = _bwd_inputs(cuda_device, B=1, S=256, seed=4)
    out, lse = t_fa.flash_forward(q, k, v, scale=0.1, causal=True)
    delta = t_fa.flash_bwd_delta(g, out) * 0.5
    got = t_fa.flash_backward(q, k, v, out, lse, g, scale=0.1, causal=True,
                              delta=delta)
    want = t_fa.flash_backward_plain(q, k, v, out, lse, g, scale=0.1,
                                     causal=True, delta=delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


def test_flash_backward_kernels_read_strided_layout(cuda_device):
    """q/k/v as column slices of one fused projection and dO as a slice of a
    wider tensor: the kernels read them through their strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(2, 256, 12, 128, generator=gen, device=cuda_device,
                      dtype=torch.bfloat16)
    q, k, v = qkv.split([8, 2, 2], dim=2)
    g = torch.randn(2, 256, 10, 128, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)[:, :, 1:9]
    assert not q.is_contiguous() and not g.is_contiguous()
    out, lse = t_fa.flash_forward(q, k, v, scale=0.1, causal=True)
    got = t_fa.flash_backward(q, k, v, out, lse, g, scale=0.1, causal=True)
    want = t_fa.flash_backward_plain(q, k, v, out, lse, g, scale=0.1,
                                     causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


def test_flash_backward_kernels_deterministic(cuda_device):
    q, k, v, g = _bwd_inputs(cuda_device, B=1, S=1024, Hq=16, Hkv=8, seed=6)
    out, lse = t_fa.flash_forward(q, k, v, scale=128 ** -0.5, causal=True)
    first = t_fa.flash_backward(q, k, v, out, lse, g, scale=128 ** -0.5,
                                causal=True)
    again = t_fa.flash_backward(q, k, v, out, lse, g, scale=128 ** -0.5,
                                causal=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_backward_kernels_refuse_other_shapes(cuda_device):
    q, k, v, g = _bwd_inputs(cuda_device, B=1, S=128, seed=7)
    out, lse = t_fa.flash_forward(q, k, v, scale=0.1, causal=True)
    with pytest.raises(TypeError, match="bf16"):
        t_fa.flash_backward(q, k, v, out, lse, g.float(), scale=0.1,
                            causal=True)
    with pytest.raises(ValueError, match="D =="):
        t_fa.flash_backward(q[..., :64], k[..., :64], v[..., :64],
                            out[..., :64], lse, g[..., :64], scale=0.1,
                            causal=True)
    with pytest.raises(ValueError, match="multiples"):
        t_fa.flash_backward(q[:, :96], k[:, :96], v[:, :96], out[:, :96],
                            lse[:, :, :96].contiguous(), g[:, :96],
                            scale=0.1, causal=True)


def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    q, k, v, g = _bwd_inputs(cuda_device, B=1, S=2048, Hq=4, Hkv=2, seed=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = t_fa.flash_backward.dq_launches
    out = t_fa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, g)
    assert t_fa.flash_backward.dq_launches == before + 1
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        t_fa.dot_product_attention(*ref, causal=True), ref, g.float())
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


# ------------------------------------------- shapes of the Hopper tiling
# The forward tiles 128 query rows by 128 keys, dk/dv 128 keys by 64
# queries and dq 128 query rows by 64 keys: S = T = 64 or 192 ends in a
# half tile (zero-filled by TMA, masked, or left to an idle warpgroup), the
# GQA group sets how many query heads one dk/dv block sums and which KV
# head a dq block reads, and column slices of a fused projection reach the
# kernels through their 4-D tensor maps' strides.

@pytest.mark.parametrize("S,group,causal,strided", [
    (192, 2, True, False), (192, 2, False, False),
    (192, 1, True, False), (192, 4, False, False),
    (320, 1, True, True), (320, 4, False, True),
    (64, 1, True, False), (64, 2, False, True), (64, 8, True, True),
    (192, 1, False, True), (192, 2, True, True), (192, 8, True, False),
    (2048, 1, True, True), (2048, 2, False, False), (2048, 8, True, False),
    (2048, 8, False, True),
])
def test_flash_kernels_hopper_tiling_shapes(cuda_device, S, group, causal,
                                            strided):
    gen = torch.Generator(device=cuda_device).manual_seed(10 + S + group)
    B, Hkv = 2, 2
    Hq = Hkv * group

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16)

    if strided:
        q, k, v = rnd(B, S, Hq + 2 * Hkv, 128).split([Hq, Hkv, Hkv], dim=2)
        g = rnd(B, S, Hq + 2, 128)[:, :, 1:Hq + 1]
        assert not q.is_contiguous() and not g.is_contiguous()
    else:
        q, k, v, g = rnd(B, S, Hq, 128), rnd(B, S, Hkv, 128), \
            rnd(B, S, Hkv, 128), rnd(B, S, Hq, 128)
    scale = 128 ** -0.5
    out, lse = t_fa.flash_forward(q, k, v, scale=scale, causal=causal)
    pout, plse = t_fa.flash_forward_plain(q, k, v, scale=scale,
                                          causal=causal)
    # the same tolerances as test_flash_kernel_matches_plain
    torch.testing.assert_close(out.float(), pout.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=2e-3)
    before = t_fa.flash_backward.dq_launches
    got = t_fa.flash_backward(q, k, v, out, lse, g, scale=scale,
                              causal=causal)
    assert t_fa.flash_backward.dq_launches == before + 1
    want = t_fa.flash_backward_plain(q, k, v, out, lse, g, scale=scale,
                                     causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        _close(a, b, name)



def test_dq_kernel_takes_external_delta_and_is_deterministic(cuda_device):
    q, k, v, g = _bwd_inputs(cuda_device, B=2, S=2048, Hq=8, Hkv=4, seed=30)
    out, lse = t_fa.flash_forward(q, k, v, scale=0.1, causal=True)
    delta = t_fa.flash_bwd_delta(g, out) * 0.5
    first = t_fa._bwd_dq(q, k, v, g, lse, delta, 0.1, True)
    again = t_fa._bwd_dq(q, k, v, g, lse, delta, 0.1, True)
    assert torch.equal(first, again)
    want = t_fa.flash_backward_plain(q, k, v, out, lse, g, scale=0.1,
                                     causal=True, delta=delta)[0]
    _close(first, want, "dq")


# ------------------------------------------ flash coverage owed (ROADMAP)
# flash_tileable admits these shapes and the kernels do not take them yet:
# on the card they raise the kernel's error through flash_attention (never
# the plain path), and no kernel launches.

@pytest.mark.parametrize("dtype,S,D,err,match", [
    (torch.float32, 2048, 128, TypeError, "bf16"),
    (torch.bfloat16, 256, 256, ValueError, "D =="),
    (torch.bfloat16, 32, 128, ValueError, "multiples"),
], ids=["f32-S2048", "D256", "S32"])
def test_flash_attention_raises_on_shapes_owed(cuda_device, dtype, S, D,
                                               err, match):
    assert t_fa.flash_tileable((1, S, 4, D), (1, S, 2, D))
    q = torch.zeros(1, S, 4, D, device=cuda_device, dtype=dtype)
    k = torch.zeros(1, S, 2, D, device=cuda_device, dtype=dtype)
    before = t_fa.flash_forward.launches
    with pytest.raises(err, match=match):
        t_fa.flash_attention(q, k, k, causal=True)
    assert t_fa.flash_forward.launches == before


# ------------------------------------------------- rolling decode (slice 5)

def _small_serving(device):
    """A small bf16 config whose projections all fit the int8 kernel
    (N % 128 == 0), int8 weights in the fused serving layout."""
    from kubetorch_tpu_torch.models import LlamaConfig, quant

    cfg = LlamaConfig.tiny(embed_dim=256, n_heads=4, n_kv_heads=2,
                           head_dim=64, mlp_dim=512, dtype="bfloat16",
                           param_dtype="bfloat16")
    return cfg, quant.init_quantized(0, cfg, fuse=True, device=device)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_rolling_chunks_launch_the_int8_kernel(cuda_device, kv):
    """A one-row 32-token prefill chunk runs every projection through the
    int8 kernel (n_layers × 4 launches), and so does every step of a decode
    chunk (n_layers × 4 × steps_per_call)."""
    from kubetorch_tpu_torch.models import RollingGenerator

    cfg, params = _small_serving(cuda_device)
    eng = RollingGenerator(params, cfg, max_slots=4, max_len=128,
                           steps_per_call=4, prefill_chunk=32, kv_dtype=kv,
                           device=cuda_device)
    long = list(range(1, 71))                  # 3 chunks of <= 32 tokens
    eng.submit(long, max_new_tokens=8)
    eng.admit()
    per_chunk = []
    while eng.prefilling_rows:
        t_qm.int8_matmul.launches = 0
        eng.prefill_step()
        per_chunk.append(t_qm.int8_matmul.launches)
    assert per_chunk == [cfg.n_layers * 4] * 3
    t_qm.int8_matmul.launches = 0
    events = eng.decode_step()
    assert t_qm.int8_matmul.launches == cfg.n_layers * 4 * 4
    (rid, toks, done), = events
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)


def test_int8_grid_merge_on_card_matches_cpu(cuda_device):
    from kubetorch_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(5)
    L, B, M, K, Hkv, D = 2, 3, 32, 8, 2, 64
    grid = {"k": torch.randint(-127, 128, (L, B, M, Hkv, D), generator=gen,
                               dtype=torch.int8),
            "v": torch.randint(-127, 128, (L, B, M, Hkv, D), generator=gen,
                               dtype=torch.int8),
            "ks": torch.rand(L, B, M, Hkv, generator=gen),
            "vs": torch.rand(L, B, M, Hkv, generator=gen)}
    chunk = {n: torch.randn(L, B, K, Hkv, D, generator=gen).to(
        torch.bfloat16) for n in ("k", "v")}
    start, count = torch.tensor([3, 20, 9]), torch.tensor([8, 0, 5])
    on_card = llama.merge_chunk_into_grid(
        {n: t.to(cuda_device) for n, t in grid.items()},
        {n: t.to(cuda_device) for n, t in chunk.items()}, start, count)
    on_cpu = llama.merge_chunk_into_grid(grid, chunk, start, count)
    for name, t in on_cpu.items():
        assert torch.equal(on_card[name].cpu(), t), name


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_merged_attention_bf16_products_match_f32_path(cuda_device,
                                                       quantized):
    """On the card the grid contractions take bf16 operands into f32
    products (``torch.bmm(..., out_dtype=torch.float32)``); the CPU upcasts
    both operands. The same products summed in another order: f32 scores
    to 1e-5 relative, the bf16 attention output to one bf16 rounding."""
    from kubetorch_tpu_torch.models import LlamaConfig, llama

    cfg = LlamaConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(6)
    Bq, T, H, Hkv, D, M, K = 3, 2, 8, 2, 64, 96, 8
    q = torch.randn(Bq, T, H, D, generator=gen).to(torch.bfloat16)
    gk, gv = (torch.randn(Bq, M, Hkv, D, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    ek, ev = (torch.randn(Bq, K, Hkv, D, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    gmask = (torch.arange(M)[None, None] < torch.tensor([50, 96, 7])[
        :, None, None]).expand(Bq, T, M)
    emask = torch.arange(K)[None, None] <= torch.arange(T)[None, :, None]
    emask = emask.expand(Bq, T, K)
    qg = q.reshape(Bq, T, Hkv, H // Hkv, D)
    torch.testing.assert_close(
        llama._scores_f32(qg.to(cuda_device), gk.to(cuda_device)).cpu(),
        llama._scores_f32(qg, gk), rtol=1e-5, atol=1e-5)
    if quantized:
        (gk, gks), (gv, gvs) = llama._kv_quantize(gk), llama._kv_quantize(gv)
        args = (q, gk, gv, gks, gvs, ek, ev, gmask, emask)
        fn = llama._cached_attn_merged_q
    else:
        args = (q, gk, gv, ek, ev, gmask, emask)
        fn = llama._cached_attn_merged
    got = fn(*(a.to(cuda_device) for a in args), cfg)
    want = fn(*args, cfg)
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=2 ** -8, atol=2 ** -8)


# ------------------------------------- serving engine and store (slice 6)

@pytest.fixture
def local_store(tmp_path, monkeypatch):
    from kubetorch_tpu_torch.data_store import client

    monkeypatch.setenv("KT_LOCAL_STORE", str(tmp_path / "store"))
    monkeypatch.delenv("KT_STORE_URL", raising=False)
    monkeypatch.setattr(client.DataStoreClient, "_default", None)
    return tmp_path / "store"


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_program_launches_the_int8_kernel_exactly(cuda_device, kv):
    """A DecodeEngine program of 12 new tokens at 4 a chunk: its admission
    (one row of 16 padded tokens) launches the int8 kernel n_layers × 4
    times and each of its three decode chunks n_layers × 4 × 4 times;
    nothing else launches it."""
    from kubetorch_tpu_torch.models import RollingGenerator
    from kubetorch_tpu_torch.serving.engine import DecodeEngine

    cfg, params = _small_serving(cuda_device)
    inner = RollingGenerator(params, cfg, max_slots=4, max_len=128,
                             steps_per_call=4, prefill_chunk=32,
                             kv_dtype=kv, device=cuda_device)
    eng = DecodeEngine(inner, poll_s=0.002)
    try:
        t_qm.int8_matmul.launches = 0
        frames = list(eng.generate({"prompt": list(range(1, 11)),
                                    "max_new_tokens": 12}))
        launches = t_qm.int8_matmul.launches
    finally:
        eng.close()
    assert [len(f["tokens"]) for f in frames] == [4, 4, 4]
    assert frames[-1]["done"]
    L4 = cfg.n_layers * 4
    assert launches == L4 + 3 * L4 * 4


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_store_round_trip_of_a_card_row_is_byte_exact(cuda_device, kv,
                                                      local_store):
    """A row exported from a card engine, parked through the store and
    restored (to the host, and to the card through the pinned placement
    pipeline) comes back byte for byte; imported into a fresh card engine
    it continues with the tokens of the uninterrupted run."""
    from kubetorch_tpu_torch.data_store import device_transfer as dt
    from kubetorch_tpu_torch.models import RollingGenerator
    from kubetorch_tpu_torch.serving import kvpool

    cfg, params = _small_serving(cuda_device)

    def engine():
        return RollingGenerator(params, cfg, max_slots=2, max_len=128,
                                steps_per_call=4, kv_dtype=kv,
                                device=cuda_device)

    ref = engine()
    rid = ref.submit(list(range(3, 30)), max_new_tokens=20)
    expected = ref.run()[rid]
    eng = engine()
    rid = eng.submit(list(range(3, 30)), max_new_tokens=20)
    first = [t for _ in range(2) for _, toks, _ in eng.step() for t in toks]
    state = eng.export_row(rid)
    kvpool.offload_session("card-row", state, quantized=kv == "int8")
    host = kvpool.restore_session("card-row")
    key = kvpool.session_key("card-row")
    on_card = dt.get_arrays(key, template=state, device=cuda_device)
    want, _ = dt.tree_flatten(state)
    for got in (dt.tree_flatten(host)[0], dt.tree_flatten(on_card)[0]):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.cpu().view(torch.uint8) if g.numel()
                               else g.cpu(), w.view(torch.uint8)
                               if w.numel() else w)
    assert all(t.device.type == cuda_device.type
               for t in dt.tree_flatten(on_card)[0])
    fresh = engine()
    rid = fresh.import_row(host)
    rest = [t for t in fresh.run()[rid]]
    assert first + rest == expected


def test_on_card_dequant_matches_host_dequant(cuda_device, local_store):
    """int8-coded leaves restored onto the card cross as (q, scale) and
    dequantize there; the result equals the host dequant bit for bit."""
    from kubetorch_tpu_torch.data_store import codec
    from kubetorch_tpu_torch.data_store import device_transfer as dt

    gen = torch.Generator().manual_seed(9)
    q = torch.randint(-127, 128, (48, 96), generator=gen, dtype=torch.int8)
    scale = torch.rand(48, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            codec.dequant(q.to(cuda_device), scale.to(cuda_device),
                          dtype).cpu(),
            codec.dequant(q, scale, dtype))
    tree = {"w": torch.randn(64, 96, generator=gen).to(torch.bfloat16),
            "f": torch.randn(32, 40, generator=gen)}
    dt.put_arrays("deq", tree, codec="int8")
    host = dt.get_arrays("deq", template=tree)
    card = dt.get_arrays("deq", template=tree, device=cuda_device)
    assert dt.last_restore_stats()["leaves_placed"] == 2
    for name in tree:
        assert card[name].device.type == "cuda"
        assert torch.equal(card[name].cpu(), host[name])
