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


@pytest.mark.parametrize("b,xdtype", [(8, torch.bfloat16), (64, torch.bfloat16),
                                      (3, torch.float32)])
def test_int8_kernel_matches_plain(cuda_device, b, xdtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    k, n = 4096, 6144
    x = torch.randn(b, k, generator=gen, device=cuda_device, dtype=xdtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    scale = torch.full((1, n), 1e-3, device=cuda_device, dtype=xdtype)
    before = t_qm.int8_matmul.launches
    got = t_qm.int8_matmul(x, w, scale)
    want = t_qm.int8_matmul_plain(x, w, scale)
    assert t_qm.int8_matmul.launches == before + 1
    assert got.dtype == xdtype
    # bf16 x: f32 sums in another order, one bf16 rounding each (one ulp);
    # f32 x: the kernel's hi/lo bf16 split keeps ~16 bits of x (2^-16)
    rtol = 2 ** -7 if xdtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-3 * want.float().abs().max().item())


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
