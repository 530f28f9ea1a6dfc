"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one: a CUDA kernel has no
CPU mode.  They import neither JAX nor the JAX package, so on the GPU
machine they run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-4, atol 1e-5 (float32 on both sides, sums taken in
another order); rtol 5e-4 for the flash backward, whose sums are longer.
"""

import numpy as np
import pytest
import torch

from tagrec_tpu_torch.ops import flash_attention as fa
from tagrec_tpu_torch.ops import flash_routing as fr

RTOL, ATOL = 1e-4, 1e-5

# (F, n, m, r, dx, base, all-zero q and k): ragged sizes (not multiples of
# the 32-row tiles), ranks that are no power of two, DGCF's all-zero first
# iteration, and its widths (F=4, dx=16, r=80)
CASES = [(3, 70, 50, 8, 5, 0.0, False), (3, 70, 50, 48, 15, 1.0, False),
         (3, 70, 50, 8, 5, 1.0, True), (4, 301, 277, 80, 16, 1.0, False),
         (1, 33, 31, 16, 8, 1.0, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(f, n, m, r, dx, zero, device):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((f, n, r)).astype(np.float32)
    k = rng.standard_normal((f, m, r)).astype(np.float32)
    x = rng.standard_normal((f, m, dx)).astype(np.float32)
    mask = rng.random((n, m)) < 0.2
    mask[5, :] = False  # empty row
    if zero:
        q[:], k[:] = 0.0, 0.0
    return [torch.from_numpy(a).to(device) for a in (q, k, mask, x)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,n,m,r,dx,base,zero", CASES)
def test_kernels_match_plain(cuda, f, n, m, r, dx, base, zero):
    q, k, mask, x = _inputs(f, n, m, r, dx, zero, cuda)
    before = (fr.routed_rowsum.launches, fr.routed_mm.launches)
    with torch.no_grad():
        d = fr.routed_rowsum(q, k, mask, base)
        out = fr.routed_mm(q, k, mask, x, base)
        d8 = fr.routed_rowsum(q, k, mask.to(torch.int8), base)
    torch.cuda.synchronize()
    assert (fr.routed_rowsum.launches, fr.routed_mm.launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(d, fr.routed_rowsum_plain(q, k, mask, base),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(d8, d, rtol=0, atol=0)
    torch.testing.assert_close(out, fr.routed_mm_plain(q, k, mask, x, base),
                               rtol=RTOL, atol=ATOL)
    assert torch.all(d[:, 5] == 0) and torch.all(out[:, 5] == 0)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    q, k, mask, x = _inputs(4, 40, 40, 16, 16, False, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            fr.routed_mm(q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, mask, x)
        with pytest.raises(TypeError, match="float32"):
            fr.routed_rowsum(q.double(), k.double(), mask)
        with pytest.raises(ValueError, match="too wide"):
            fr.routed_mm(q, k, mask, torch.cat([x, x], dim=2))
        with pytest.raises(ValueError, match="one device"):
            fr.routed_rowsum(q, k.cpu(), mask)


# --------------------------------------- two-segment flash attention (KGAT)
# (Ns, Nd, split, dq, dx): ragged sizes (not multiples of the 64 x 64
# tiles), a split inside the columns, at 0 and at Nd, KGAT's widths (dq 64,
# dx 64 and 32), and narrow ones.  Gradients: rtol 5e-4 (longer sums).
FLASH_CASES = [(70, 200, 128, 64, 16), (301, 333, 64, 64, 32),
               (256, 512, 256, 64, 64), (129, 100, 0, 16, 7),
               (65, 192, 192, 33, 64)]
GRAD_RTOL = 5e-4


def _flash_inputs(ns, nd, dq, dx, device):
    rng = np.random.default_rng(41)
    q2 = np.tanh(rng.standard_normal((2, ns, dq))).astype(np.float32)
    k = (0.3 * rng.standard_normal((nd, dq))).astype(np.float32)
    x = rng.standard_normal((nd, dx)).astype(np.float32)
    g = rng.standard_normal((ns, dx)).astype(np.float32)
    mask = (rng.random((ns, nd)) < 0.1).astype(np.int8)
    mask[[3, ns - 1], :] = 0  # empty rows
    return [torch.from_numpy(a).to(device) for a in (q2, k, mask, x, g)]


def _flash_counts():
    return [f.launches for f in (fa.dot_flash_stats, fa.dot_flash_apply,
                                 fa.dot_bwd_row, fa.dot_bwd_col)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,split,dq,dx", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, ns, nd, split, dq, dx):
    q2, k, mask, x, g = _flash_inputs(ns, nd, dq, dx, cuda)
    before = _flash_counts()
    m, z = fa.dot_flash_stats(q2, k, mask, split)
    out = fa.dot_flash_apply(q2, k, mask, m, z, x, split)
    delta = torch.sum(g * out, dim=1)
    dq2 = fa.dot_bwd_row(q2, k, mask, m, z, x, g, delta, split)
    dk, dx_ = fa.dot_bwd_col(q2, k, mask, m, z, x, g, delta, split)
    torch.cuda.synchronize()
    assert _flash_counts() == [before[0] + 1, before[1] + 1, before[2] + 1,
                               before[3] + 1]
    want_m, want_z = fa.dot_flash_stats_plain(q2, k, mask, split)
    torch.testing.assert_close(m, want_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(z, want_z, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        out, fa.dot_flash_apply_plain(q2, k, mask, m, z, x, split),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        dq2, fa.dot_bwd_row_plain(q2, k, mask, m, z, x, g, delta, split),
        rtol=GRAD_RTOL, atol=ATOL)
    want_dk, want_dx = fa.dot_bwd_col_plain(q2, k, mask, m, z, x, g, delta,
                                            split)
    torch.testing.assert_close(dk, want_dk, rtol=GRAD_RTOL, atol=ATOL)
    torch.testing.assert_close(dx_, want_dx, rtol=GRAD_RTOL, atol=ATOL)
    for rows in (out[[3, ns - 1]], dq2[:, [3, ns - 1]]):
        assert torch.all(rows == 0)
    assert torch.all(m[[3, ns - 1]] == fa.NEG) and torch.all(z[[3, ns - 1]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,split,dq,dx", FLASH_CASES[:3])
def test_flash_apply_gradients_match_plain(cuda, ns, nd, split, dq, dx):
    """Autograd through dot_flash_apply on the card (the two backward
    kernels) against PyTorch's own autograd through the plain stats and
    apply (the stats differentiated too, so that it is the softmax's
    gradient)."""
    q2, k, mask, x, g = _flash_inputs(ns, nd, dq, dx, cuda)

    def kernel(q2_, k_, x_):
        m, z = fa.dot_flash_stats(q2_.detach(), k_.detach(), mask, split)
        return fa.dot_flash_apply(q2_, k_, mask, m, z, x_, split)

    def plain(q2_, k_, x_):
        m, z = fa.dot_flash_stats_plain(q2_, k_, mask, split)
        return fa.dot_flash_apply_plain(q2_, k_, mask, m, z, x_, split)

    grads = []
    for fn in (kernel, plain):
        leaves = [t.clone().requires_grad_() for t in (q2, k, x)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=ATOL)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q2, k, mask, x, g = _flash_inputs(70, 200, 64, 16, cuda)
    m, z = fa.dot_flash_stats(q2, k, mask, 128)
    with pytest.raises(TypeError, match="float32"):
        fa.dot_flash_stats(q2.double(), k.double(), mask, 128)
    with pytest.raises(TypeError, match="mask dtype"):
        fa.dot_flash_stats(q2, k, mask.bool(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        fa.dot_flash_stats(q2, k.T.contiguous().T, mask, 128)
    with pytest.raises(ValueError, match="one device"):
        fa.dot_flash_apply(q2, k, mask, m, z, x.cpu(), 128)
    with pytest.raises(ValueError, match="64-column tile"):
        fa.dot_flash_apply(q2, k, mask, m, z, x, 100)
    with pytest.raises(ValueError, match="widths"):
        fa.dot_flash_apply(q2, k, mask, m, z, torch.cat([x] * 5, dim=1), 128)
    with pytest.raises(ValueError, match="widths"):
        wide = torch.cat([q2, q2], dim=2)
        fa.dot_flash_stats(wide, torch.cat([k, k], dim=1), mask, 128)
