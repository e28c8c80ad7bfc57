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
