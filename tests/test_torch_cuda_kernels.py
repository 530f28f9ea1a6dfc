"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one: a CUDA kernel has no
CPU mode.  They import neither JAX nor the JAX package, so on the GPU
machine they run without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: rtol 1e-4, atol 1e-5 (float32 on both sides, sums taken in
another order); rtol 5e-4 for the flash backward, whose sums are longer,
and for LightGCN's gradients; the row gather must match bit for bit.  The
routing kernels take the mask's edge list (``fr.mask_edges``, ``_edges``
here), built once a mask.
"""

import numpy as np
import pytest
import torch

from tagrec_tpu_torch.ops import dma_gather as dg
from tagrec_tpu_torch.ops import flash_attention as fa
from tagrec_tpu_torch.ops import flash_routing as fr

RTOL, ATOL = 1e-4, 1e-5

# (F, n, m, r, dx, base, all-zero q and k): ragged sizes (not multiples of
# the 32-row tiles), ranks that are no power of two, DGCF's all-zero first
# iteration, and its widths (F=4, dx=16, r=80)
CASES = [(3, 70, 50, 8, 5, 0.0, False), (3, 70, 50, 48, 15, 1.0, False),
         (3, 70, 50, 8, 5, 1.0, True), (4, 301, 277, 80, 16, 1.0, False),
         (1, 33, 31, 16, 8, 1.0, False)]


def _edges(mask, row0=0):
    """The routing kernels' edge list of a mask on the card."""
    return fr.mask_edges(mask, row0)


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
    e, mask8 = _edges(mask), mask.to(torch.int8)
    with torch.no_grad():
        d = fr.routed_rowsum(q, k, mask, base, edges=e)
        out = fr.routed_mm(q, k, mask, x, base, edges=e)
        d8 = fr.routed_rowsum(q, k, mask8, base, edges=_edges(mask8))
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
    e = _edges(mask)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            fr.routed_mm(q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, mask, x, edges=e)
        with pytest.raises(TypeError, match="float32"):
            fr.routed_rowsum(q.double(), k.double(), mask, edges=e)
        with pytest.raises(ValueError, match="too wide"):
            fr.routed_mm(q, k, mask, torch.cat([x, x], dim=2), edges=e)
        with pytest.raises(ValueError, match="factors"):
            fr.routed_mm(torch.cat([q, q[:1]]), torch.cat([k, k[:1]]), mask,
                         torch.cat([x, x[:1]]), edges=e)
        with pytest.raises(ValueError, match="out of range"):
            wide = torch.zeros((4, 40, 129), device=cuda)
            fr.routed_mm(wide, wide, mask, x, edges=e)
        with pytest.raises(ValueError, match="one device"):
            fr.routed_rowsum(q, k.cpu(), mask, edges=e)
        # routed_rowsum has routed_mm's limits: the same edge sweep
        with pytest.raises(ValueError, match="factors"):
            fr.routed_rowsum(torch.cat([q, q[:1]]), torch.cat([k, k[:1]]),
                             mask, edges=e)
        with pytest.raises(ValueError, match="out of range"):
            fr.routed_rowsum(wide, wide, mask, edges=e)
        # the list must be on q's device and of the rows swept
        with pytest.raises(ValueError, match="lies on"):
            fr.routed_rowsum(q, k, mask, edges=_edges(mask.cpu()))
        with pytest.raises(ValueError, match="not the mask's"):
            fr.routed_mm_rows(q, k, mask[1:], x, row0=1, edges=e)


# (F, n, m, r, dx, row0, rows): a block of rows past row 0 at DGCF's widths
# (F = 4, r = 80, dx = 16), and one whose mask rows start off the 16-byte
# words (m = 301), each inside the transpose's rows too
ROW_RANGE_CASES = [(4, 301, 277, 80, 16, 37, 200),
                   (3, 70, 301, 48, 15, 35, 35)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,n,m,r,dx,row0,rows", ROW_RANGE_CASES)
def test_routing_sweeps_over_a_row_range(cuda, f, n, m, r, dx, row0, rows):
    """routed_rowsum, routed_mm_rows and routed_mm_bwd over rows row0 ..
    row0 + rows of the mask (of its transpose): their plain versions over
    the same rows, and the whole launch's rows bit for bit, also written
    into a view of a larger buffer (a rank's part of a send buffer)."""
    q, k, mask, x = _inputs(f, n, m, r, dx, False, cuda)
    g = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (f, n, dx)).astype(np.float32)).to(cuda)
    mask_t = mask.T.contiguous()
    s = slice(row0, row0 + rows)
    sweeps = (fr.routed_rowsum, fr.routed_mm, fr.routed_mm_bwd)
    before = [fn.launches for fn in sweeps]
    e, et = _edges(mask), _edges(mask_t)
    es = fr.mask_edges(mask[s], row0, e.seg_len)  # rows cut as the whole's
    ets = fr.mask_edges(mask_t[s], row0, et.seg_len)
    d = fr.routed_rowsum(q, k, mask[s], 1.0, row0=row0, edges=es)
    buf = torch.full((2, f, rows, dx), float("nan"), device=cuda)
    out = fr.routed_mm_rows(q, k, mask[s], x, 1.0, row0=row0, out=buf[1],
                            edges=es)
    dxr = fr.routed_mm_bwd(q, k, mask_t[s], g, 1.0, row0=row0, edges=ets)
    torch.cuda.synchronize()
    assert out is buf[1] or out.data_ptr() == buf[1].data_ptr()
    assert [fn.launches for fn in sweeps] == [b + 1 for b in before]
    torch.testing.assert_close(
        d, fr.routed_rowsum_plain(q, k, mask[s], 1.0, row0=row0),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        out, fr.routed_mm_plain(q, k, mask[s], x, 1.0, row0=row0),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        dxr, fr.routed_mm_plain(k, q, mask_t[s], g, 1.0, row0=row0),
        rtol=RTOL, atol=ATOL)
    # each row's sums are its own segments', whoever else shares the launch
    assert torch.equal(d, fr.routed_rowsum(q, k, mask, 1.0, edges=e)[:, s])
    assert torch.equal(buf[1], fr.routed_mm_rows(q, k, mask, x, 1.0,
                                                 edges=e)[:, s])
    assert torch.equal(dxr, fr.routed_mm_bwd(q, k, mask_t, g, 1.0,
                                             edges=et)[:, s])
    assert torch.isnan(buf[0]).all()  # nothing written outside the view
    with pytest.raises(ValueError, match="shape mismatch"):
        fr.routed_rowsum(q, k, mask[s], 1.0, row0=n - rows + 1)


def _edge_rows_mask(n, m, seed):
    """A 0/1 mask with the rows an edge sweep must get right: empty first
    and last rows, a row that is all edges, a row whose one edge is the
    last column, and sparse random rows."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, m)) < 0.05
    mask[:, m - 1] |= rng.random(n) < 0.5
    mask[[0, n - 1], :] = False
    mask[1, :] = True
    mask[2, :] = False
    mask[2, m - 1] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("m", [301, 15000])
def test_routed_mm_edge_rows(cuda, m):
    """routed_mm's edge sweep at row lengths off the 16-byte words (every
    row start has another alignment), on full, empty and last-column rows,
    at DGCF's widths; a bool and an int8 mask give the same output."""
    rng = np.random.default_rng(m)
    f, n, r, dx = 4, 9, 80, 16
    q, k, x = (torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[2]))
                                .astype(np.float32)).to(cuda)
               for shape in ((f, n, r), (f, m, r), (f, m, dx)))
    mask = torch.from_numpy(_edge_rows_mask(n, m, seed=m)).to(cuda)
    before = fr.routed_mm.launches
    mask8 = mask.to(torch.int8)
    with torch.no_grad():
        out = fr.routed_mm(q, k, mask, x, 1.0, edges=_edges(mask))
        out8 = fr.routed_mm(q, k, mask8, x, 1.0, edges=_edges(mask8))
    torch.cuda.synchronize()
    assert fr.routed_mm.launches == before + 2
    # the plain version in float64: row 1 sums 15,000 terms, and a float32
    # sum that long drifts past atol near zero whatever its order
    want = fr.routed_mm_plain(q.double(), k.double(), mask, x.double(), 1.0)
    torch.testing.assert_close(out, want.float(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(out8, out, rtol=0, atol=0)
    assert torch.all(out[:, [0, n - 1]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [301, 15000])
def test_routed_rowsum_edge_rows(cuda, m):
    """routed_rowsum's edge sweep on the same rows as routed_mm's, at DGCF's
    widths; a bool and an int8 mask give the same output, and an empty row
    gets 0."""
    rng = np.random.default_rng(m + 1)
    f, n, r = 4, 9, 80
    q, k = (torch.from_numpy((rng.standard_normal(shape) / np.sqrt(r))
                             .astype(np.float32)).to(cuda)
            for shape in ((f, n, r), (f, m, r)))
    mask = torch.from_numpy(_edge_rows_mask(n, m, seed=m)).to(cuda)
    before = fr.routed_rowsum.launches
    mask8 = mask.to(torch.int8)
    d = fr.routed_rowsum(q, k, mask, 1.0, edges=_edges(mask))
    d8 = fr.routed_rowsum(q, k, mask8, 1.0, edges=_edges(mask8))
    torch.cuda.synchronize()
    assert fr.routed_rowsum.launches == before + 2
    want = fr.routed_rowsum_plain(q.double(), k.double(), mask, 1.0)
    torch.testing.assert_close(d, want.float(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(d8, d, rtol=0, atol=0)
    assert torch.all(d[:, [0, n - 1]] == 0)


def _segment_mask(n, m, seed):
    """Sparse rows (3%), empty rows, and two rows of every column: each of
    those is cut into several segments of the list (many at seg_edges'
    floor of 32), the row past the split rows' block an empty one."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, m)) < 0.03
    mask[[0, 7, n - 1]] = False
    mask[[5, n // 2 + 3]] = True
    return torch.from_numpy(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 16, 32, 48, 64, 80])
def test_segment_sweeps_match_plain_at_dgcf_ranks(cuda, r):
    """The three sweeps over the edge list at DGCF's ranks (r = 8 all
    zeros, as its first iteration), F = 4, dx = 16, against their plain
    versions in float64, over the whole mask and a rank's rows (the second
    half): rows split over 3 or more segments, empty rows; two launches
    give the same bits; bytes of the dense mask overwritten once the lists
    are built change no result (the kernels read none)."""
    f, n, m, dx = 4, 600, 700, 16
    rng = np.random.default_rng(r)
    q, k, x, g = (torch.from_numpy((rng.standard_normal(shape) / np.sqrt(
        shape[2])).astype(np.float32)).to(cuda) for shape in (
        (f, n, r), (f, m, r), (f, m, dx), (f, n, dx)))
    if r == 8:
        q.zero_()
        k.zero_()
    mask = _segment_mask(n, m, seed=r).to(cuda)
    mask_t = mask.T.contiguous()
    s0 = n // 2
    e, et, es = _edges(mask), _edges(mask_t), _edges(mask[s0:], s0)
    assert int(e.splits[:, 2].max()) >= 3 and int(es.splits[:, 2].max()) >= 3

    def sweeps(mk, mk_t, mk_s):
        with torch.no_grad():
            return (fr.routed_rowsum(q, k, mk, 1.0, edges=e),
                    fr.routed_mm_rows(q, k, mk, x, 1.0, edges=e),
                    fr.routed_mm_bwd(q, k, mk_t, g, 1.0, edges=et),
                    fr.routed_rowsum(q, k, mk_s, 1.0, row0=s0, edges=es),
                    fr.routed_mm_rows(q, k, mk_s, x, 1.0, row0=s0, edges=es))

    got = sweeps(mask, mask_t, mask[s0:])
    q64, k64, x64 = q.double(), k.double(), x.double()
    x0 = torch.zeros_like(x64, requires_grad=True)
    (dx64,) = torch.autograd.grad(fr.routed_mm_plain(q64, k64, mask, x0, 1.0),
                                  x0, g.double())
    want = (fr.routed_rowsum_plain(q64, k64, mask, 1.0),
            fr.routed_mm_plain(q64, k64, mask, x64, 1.0), dx64,
            fr.routed_rowsum_plain(q64, k64, mask[s0:], 1.0, row0=s0),
            fr.routed_mm_plain(q64, k64, mask[s0:], x64, 1.0, row0=s0))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.float(), rtol=RTOL, atol=ATOL)
    for rows in (got[0][:, [0, 7, n - 1]], got[1][:, [0, 7, n - 1]]):
        assert torch.all(rows == 0)
    for a, b in zip(got, sweeps(mask, mask_t, mask[s0:])):
        assert torch.equal(a, b)  # no atomics: the same bits
    junk = torch.ones_like(mask)
    for a, b in zip(got, sweeps(junk, junk.T.contiguous(), junk[s0:])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_routing_kernels_need_the_edge_list_on_the_card(cuda):
    q, k, mask, x = _inputs(4, 40, 40, 16, 16, False, cuda)
    counters = (fr.routed_rowsum, fr.routed_mm, fr.routed_mm_bwd)
    before = [c.launches for c in counters]
    with torch.no_grad():
        with pytest.raises(ValueError, match="routed_rowsum on the card "
                                             "needs edges="):
            fr.routed_rowsum(q, k, mask, 1.0)
        with pytest.raises(ValueError, match="needs edges="):
            fr.routed_mm(q, k, mask, x, 1.0, mask_t=mask)
        with pytest.raises(ValueError, match="needs edges="):
            fr.routed_mm_rows(q, k, mask[10:], x, 1.0, row0=10)
        with pytest.raises(ValueError, match="routed_mm_bwd on the card "
                                             "needs edges="):
            fr.routed_mm_bwd(q, k, mask, x, 1.0)
    assert [c.launches for c in counters] == before


# --------------------------------------- two-segment flash attention (KGAT)
# (Ns, Nd, split, dq, dx): ragged sizes (not multiples of 64), a split inside
# the columns, at 0 and at Nd, KGAT's widths (dq 64, dx 64 and 32), and
# narrow ones.  Gradients: rtol 5e-4 (longer sums).
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
    dk, dx_ = fa.dot_bwd_col(q2, k, mask.T.contiguous(), m, z, x, g, delta,
                             split)
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
    kernels, the column sweep over the mask's transpose) against PyTorch's
    own autograd through the plain stats and apply (the stats differentiated
    too, so that it is the softmax's gradient)."""
    q2, k, mask, x, g = _flash_inputs(ns, nd, dq, dx, cuda)
    mask_t = mask.T.contiguous()

    def kernel(q2_, k_, x_):
        m, z = fa.dot_flash_stats(q2_.detach(), k_.detach(), mask, split)
        return fa.dot_flash_apply(q2_, k_, mask, m, z, x_, split, mask_t)

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
    delta = torch.sum(g * fa.dot_flash_apply(q2, k, mask, m, z, x, 128), 1)
    # every kernel takes a split off the 64-column tile
    m100, z100 = fa.dot_flash_stats(q2, k, mask, 100)
    want_m, want_z = fa.dot_flash_stats_plain(q2, k, mask, 100)
    torch.testing.assert_close(m100, want_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(z100, want_z, rtol=RTOL, atol=ATOL)
    fa.dot_flash_apply(q2, k, mask, m, z, x, 100)
    fa.dot_bwd_row(q2, k, mask, m, z, x, g, delta, 100)
    fa.dot_bwd_col(q2, k, mask.T.contiguous(), m, z, x, g, delta, 100)
    torch.cuda.synchronize()
    # the column sweep reads the mask's transpose, which the card's backward
    # does not build per step
    leaf = x.clone().requires_grad_()
    with pytest.raises(ValueError, match="mask_t"):
        fa.dot_flash_apply(q2, k, mask, m, z, leaf, 128).backward(g)
    with pytest.raises(ValueError, match="contiguous"):
        fa.dot_bwd_col(q2, k, mask.T, m, z, x, g, delta, 128)
    with pytest.raises(ValueError, match="widths"):
        fa.dot_flash_apply(q2, k, mask, m, z, torch.cat([x] * 5, dim=1), 128)
    with pytest.raises(ValueError, match="widths"):
        wide = torch.cat([q2, q2], dim=2)
        fa.dot_flash_stats(wide, torch.cat([k, k], dim=1), mask, 128)
    # an edge keeps 24 bits of column (csrc/mask_rows.cuh)
    long_k = torch.zeros((1 << 24, 1), device=cuda)
    long_mask = torch.zeros((1, 1 << 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="fewer than"):
        fa.dot_flash_stats(torch.zeros((2, 1, 1), device=cuda), long_k,
                           long_mask, 0)


# (Ns, Nd, split, row0, rows, col0, cols): a block of mask rows past row 0,
# and a block of the transpose's rows (the attention's columns) across the
# split, at a ragged size and at KGAT's padded one
FLASH_RANGE_CASES = [(301, 333, 100, 64, 150, 37, 200),
                     (256, 512, 256, 128, 128, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,split,row0,rows,col0,cols", FLASH_RANGE_CASES)
def test_flash_sweeps_over_a_row_range(cuda, ns, nd, split, row0, rows, col0,
                                       cols):
    """The stats, apply and row-backward sweeps over rows row0 .. row0 +
    rows of the mask, and the column sweep over rows col0 .. col0 + cols
    of its transpose, which straddle the split: their plain versions over
    the same rows, and the whole launches' rows bit for bit."""
    q2, k, mask, x, g = _flash_inputs(ns, nd, 64, 64, cuda)
    mask_t = mask.T.contiguous()
    r, c = slice(row0, row0 + rows), slice(col0, col0 + cols)
    assert col0 < split < col0 + cols
    m, z = fa.dot_flash_stats(q2, k, mask, split)
    out = fa.dot_flash_apply_rows(q2, k, mask, m, z, x, split)
    delta = torch.sum(g * out, dim=1)
    args = (m, z, x, g, delta, split)
    mr, zr = fa.dot_flash_stats(q2, k, mask[r], split, row0=row0)
    outr = fa.dot_flash_apply_rows(q2, k, mask[r], m, z, x, split, row0=row0)
    dq2r = fa.dot_bwd_row(q2, k, mask[r], *args, row0=row0)
    dkc, dxc = fa.dot_bwd_col(q2, k, mask_t[c], *args, row0=col0)
    torch.cuda.synchronize()
    want_m, want_z = fa.dot_flash_stats_plain(q2, k, mask[r], split,
                                              row0=row0)
    torch.testing.assert_close(mr, want_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(zr, want_z, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        outr, fa.dot_flash_apply_plain(q2, k, mask[r], m, z, x, split,
                                       row0=row0), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        dq2r, fa.dot_bwd_row_plain(q2, k, mask[r], *args, row0=row0),
        rtol=GRAD_RTOL, atol=ATOL)
    want_dk, want_dx = fa.dot_bwd_col_plain(q2, k, mask_t[c].T, *args,
                                            row0=col0)
    torch.testing.assert_close(dkc, want_dk, rtol=GRAD_RTOL, atol=ATOL)
    torch.testing.assert_close(dxc, want_dx, rtol=GRAD_RTOL, atol=ATOL)
    assert torch.equal(mr, m[r]) and torch.equal(zr, z[r])
    assert torch.equal(outr, out[r])
    assert torch.equal(dq2r, fa.dot_bwd_row(q2, k, mask, *args)[:, r])
    dk, dx = fa.dot_bwd_col(q2, k, mask_t, *args)
    assert torch.equal(dkc, dk[c]) and torch.equal(dxc, dx[c])


# (Nd, split): a row length of 5,000 bytes (four warps a row, row starts off
# the 16-byte words), 301 (one warp a row), splits at 0, at Nd and off every
# 64-column tile (the edge sweeps choose the plane per edge).
APPLY_EDGE_CASES = [(301, 0), (301, 301), (5000, 1000), (5000, 2537)]


@pytest.mark.cuda
@pytest.mark.parametrize("nd,split", APPLY_EDGE_CASES)
def test_dot_flash_stats_edge_rows(cuda, nd, split):
    """dot_flash_stats' edge sweep on full, empty and last-column rows, at
    KGAT's width (dq 64); an empty row gets exactly (NEG, 0)."""
    ns = 11
    q2, k, _, _, _ = _flash_inputs(ns, nd, 64, 64, cuda)
    mask = torch.from_numpy(_edge_rows_mask(ns, nd, seed=nd).astype(np.int8))
    mask = mask.to(cuda)
    before = fa.dot_flash_stats.launches
    m, z = fa.dot_flash_stats(q2, k, mask, split)
    torch.cuda.synchronize()
    assert fa.dot_flash_stats.launches == before + 1
    # the plain version in float64: row 1 sums Nd terms
    want_m, want_z = fa.dot_flash_stats_plain(q2.double(), k.double(), mask,
                                              split)
    torch.testing.assert_close(m, want_m.float(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(z, want_z.float(), rtol=RTOL, atol=ATOL)
    assert torch.all(m[[0, ns - 1]] == fa.NEG)
    assert torch.all(z[[0, ns - 1]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,split", APPLY_EDGE_CASES)
def test_dot_flash_apply_edge_rows(cuda, nd, split):
    """dot_flash_apply's edge sweep on full, empty and last-column rows, at
    KGAT's widths (dq 64, dx 64), with the stats of the plain version."""
    ns = 11
    q2, k, _, x, _ = _flash_inputs(ns, nd, 64, 64, cuda)
    mask = torch.from_numpy(_edge_rows_mask(ns, nd, seed=nd).astype(np.int8))
    mask = mask.to(cuda)
    m, z = fa.dot_flash_stats_plain(q2, k, mask, split)
    before = fa.dot_flash_apply.launches
    out = fa.dot_flash_apply(q2, k, mask, m, z, x, split)
    torch.cuda.synchronize()
    assert fa.dot_flash_apply.launches == before + 1
    torch.testing.assert_close(
        out, fa.dot_flash_apply_plain(q2, k, mask, m, z, x, split),
        rtol=RTOL, atol=ATOL)
    assert torch.all(out[[0, ns - 1]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,split", APPLY_EDGE_CASES)
def test_dot_bwd_row_edge_rows(cuda, nd, split):
    """dot_bwd_row's edge sweep on full, empty and last-column rows, at
    KGAT's widths (dq 64, dx 64), with the stats of the plain version; a
    row whose edges all lie on one side of the split gets exact zeros in
    the other plane."""
    ns = 11
    q2, k, _, x, g = _flash_inputs(ns, nd, 64, 64, cuda)
    mask = _edge_rows_mask(ns, nd, seed=nd).astype(np.int8)
    mask[3, split:] = 0  # left of the split only
    mask[4, :split] = 0  # right of it only
    mask[3, 0] = mask[4, nd - 1] = 1
    mask = torch.from_numpy(mask).to(cuda)
    m, z = fa.dot_flash_stats_plain(q2, k, mask, split)
    delta = torch.sum(g * fa.dot_flash_apply_plain(q2, k, mask, m, z, x,
                                                   split), dim=1)
    before = fa.dot_bwd_row.launches
    dq2 = fa.dot_bwd_row(q2, k, mask, m, z, x, g, delta, split)
    torch.cuda.synchronize()
    assert fa.dot_bwd_row.launches == before + 1
    # the plain version in float64: row 1 sums Nd terms of dS k that cancel
    want = fa.dot_bwd_row_plain(
        *[t.double() for t in (q2, k)], mask,
        *[t.double() for t in (m, z, x, g, delta)], split)
    torch.testing.assert_close(dq2, want.float(), rtol=GRAD_RTOL, atol=ATOL)
    assert torch.all(dq2[:, [0, ns - 1]] == 0)
    if split > 0:
        assert torch.all(dq2[1, 3] == 0) and torch.any(dq2[0, 3] != 0)
    if split < nd:
        assert torch.all(dq2[0, 4] == 0) and torch.any(dq2[1, 4] != 0)


# (Ns, Nd, split) of dot_bwd_col, which sweeps the rows of mask_t [Nd, Ns]:
# rows of 301 bytes (one warp a row) and 5,000 (four warps, row starts off
# the 16-byte words), splits at 0, at Nd and off the 64-column tile (the
# plane is fixed per column).
BWD_COL_EDGE_CASES = [(301, 301, 0), (301, 301, 301), (5000, 301, 100),
                      (5000, 301, 237)]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nd,split", BWD_COL_EDGE_CASES)
def test_dot_bwd_col_edge_columns(cuda, ns, nd, split):
    """dot_bwd_col's edge sweep over the mask's transpose on full, empty and
    last-row columns, at KGAT's widths (dq 64, dx 64), with the stats of the
    plain version; an empty column gets exact zeros."""
    q2, k, _, x, g = _flash_inputs(ns, nd, 64, 64, cuda)
    mask_t = _edge_rows_mask(nd, ns, seed=ns + split).astype(np.int8)
    mask_t = torch.from_numpy(mask_t).to(cuda)
    mask = mask_t.T.contiguous()
    m, z = fa.dot_flash_stats_plain(q2, k, mask, split)
    delta = torch.sum(g * fa.dot_flash_apply_plain(q2, k, mask, m, z, x,
                                                   split), dim=1)
    before = fa.dot_bwd_col.launches
    dk, dx = fa.dot_bwd_col(q2, k, mask_t, m, z, x, g, delta, split)
    torch.cuda.synchronize()
    assert fa.dot_bwd_col.launches == before + 1
    # the plain version in float64: column 1 sums Ns terms that cancel
    want_dk, want_dx = fa.dot_bwd_col_plain(
        *[t.double() for t in (q2, k)], mask,
        *[t.double() for t in (m, z, x, g, delta)], split)
    torch.testing.assert_close(dk, want_dk.float(), rtol=GRAD_RTOL, atol=ATOL)
    torch.testing.assert_close(dx, want_dx.float(), rtol=GRAD_RTOL, atol=ATOL)
    for t in (dk, dx):
        assert torch.all(t[[0, nd - 1]] == 0) and torch.any(t[1] != 0)


@pytest.mark.cuda
def test_edge_sweeps_never_read_columns_off_the_edges(cuda):
    """The edge sweeps read k and x only at a row's edges: a NaN in a column
    that no row has as an edge stays out of every row (the plain versions,
    dense products, carry it through 0 * NaN; stats' masks the score, as
    JAX's kernel does, and agrees)."""
    mask = _edge_rows_mask(9, 301, seed=3)
    mask[:, 100] = False
    q, k, _, x = _inputs(4, 9, 301, 16, 16, False, cuda)
    k[:, 100, 0] = float("nan")
    x[:, 100, 0] = float("nan")
    mask_d = torch.from_numpy(mask).to(cuda)
    with torch.no_grad():
        out = fr.routed_mm(q, k, mask_d, x, edges=_edges(mask_d))
        d = fr.routed_rowsum(q, k, mask_d, edges=_edges(mask_d))
    assert torch.isfinite(out).all() and torch.isfinite(d).all()
    q2, kf, _, xf, g = _flash_inputs(9, 301, 64, 64, cuda)
    mask8 = torch.from_numpy(mask.astype(np.int8)).to(cuda)
    m, z = fa.dot_flash_stats(q2, kf, mask8, 128)
    delta = torch.sum(g * fa.dot_flash_apply(q2, kf, mask8, m, z, xf, 128), 1)
    kf[100, 0] = xf[100, 0] = float("nan")
    m_nan, z_nan = fa.dot_flash_stats(q2, kf, mask8, 128)
    assert torch.isfinite(m_nan).all() and torch.isfinite(z_nan).all()
    torch.testing.assert_close(m_nan, m, rtol=0, atol=0)
    torch.testing.assert_close(z_nan, z, rtol=0, atol=0)
    out = fa.dot_flash_apply(q2, kf, mask8, m, z, xf, 128)
    dq2 = fa.dot_bwd_row(q2, kf, mask8, m, z, xf, g, delta, 128)
    assert torch.isfinite(out).all() and torch.isfinite(dq2).all()
    # the column sweep reads q2 and g only at a column's edges: row 0 has
    # none
    kf[100, 0] = xf[100, 0] = 0.0
    q2[:, 0, 0] = g[0, 0] = float("nan")
    dk, dx = fa.dot_bwd_col(q2, kf, mask8.T.contiguous(), m, z, xf, g, delta,
                            128)
    assert torch.isfinite(dk).all() and torch.isfinite(dx).all()


# ------------------------------------------ ELL gather kernels (LightGCN)
# (M, D, N, K): narrow rows (one warp each; N not a multiple of a block's 8
# rows), rows past WIDE_K (one block each), LightGCN's D = 64, D = 128 (32
# lanes a row), 16, 12 (three float4 lanes: no power of two) and 4.
GATHER_CASES = [(300, 64, 37, 25), (300, 64, 5, 600), (500, 64, 1001, 8),
                (200, 128, 19, 40), (200, 16, 33, 300), (200, 12, 17, 33),
                (50, 4, 9, 70)]
ROWS_CASES = [(300, 64, 150), (300, 64, 7), (80, 4, 33), (1000, 128, 4097)]


def _gather_inputs(m, d, n, k, device):
    rng = np.random.default_rng(m + d + n + k)
    x = rng.standard_normal((m, d)).astype(np.float32)
    idx = rng.integers(0, m, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(np.float32)
    pad = rng.random((n, k)) < 0.2  # pad slots: id 0, value 0
    idx[pad], val[pad] = 0, 0.0
    return [torch.from_numpy(a).to(device) for a in (x, idx, val)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n,k", GATHER_CASES)
def test_gather_reduce_matches_plain(cuda, m, d, n, k):
    x, idx, val = _gather_inputs(m, d, n, k, cuda)
    before = dg.gather_reduce.launches
    out = dg.gather_reduce(x, idx, val)
    torch.cuda.synchronize()
    assert dg.gather_reduce.launches == before + 1
    torch.testing.assert_close(out, dg.gather_reduce_plain(x, idx, val),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,r", ROWS_CASES)
def test_gather_rows_equals_indexing(cuda, m, d, r):
    rng = np.random.default_rng(m + r)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    x[3, 1] = float("nan")
    x = x.to(cuda)
    idx = torch.from_numpy(rng.integers(0, m, r).astype(np.int32)).to(cuda)
    idx[0] = 3
    before = dg.gather_rows.launches
    out = dg.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert dg.gather_rows.launches == before + 1
    torch.testing.assert_close(out, x[idx.long()], rtol=0, atol=0,
                               equal_nan=True)


# (M, D, N, K) with each row's degree: rows of one warp (K <= 256), of one
# block (K <= SPAN), and rows split across 2 and 3 blocks (K > SPAN).
DEG_CASES = [(300, 64, 37, 25), (300, 64, 20, 600), (500, 64, 9, 5000),
             (200, 16, 5, 2100), (200, 12, 17, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n,k", DEG_CASES)
def test_gather_reduce_with_deg_reads_only_the_edges(cuda, m, d, n, k):
    """With deg the kernel sums the slots k < deg[n] only: the values past
    it are NaN and stay out, on rows of degree 0, of degree K and of a
    degree that splits the row across blocks; a split row's partial sums
    add up the same in every run."""
    x, idx, val = _gather_inputs(m, d, n, k, cuda)
    rng = np.random.default_rng(k)
    deg = rng.integers(0, k + 1, n)
    deg[:3] = 0, k, min(k, dg.SPAN + 1)
    deg = torch.from_numpy(deg.astype(np.int32)).to(cuda)
    past = torch.arange(k, device=cuda)[None, :] >= deg[:, None]
    # values of 1 / sqrt(K), so that a row's sum is of unit scale
    val = torch.where(past, float("nan"), val / float(np.sqrt(k)))
    before = dg.gather_reduce.launches
    out = dg.gather_reduce(x, idx, val, deg)
    again = dg.gather_reduce(x, idx, val, deg)
    torch.cuda.synchronize()
    assert dg.gather_reduce.launches == before + 2
    # the plain version in float64: the widest rows sum 5,000 terms
    want = dg.gather_reduce_plain(x.double(), idx, val.double(), deg)
    torch.testing.assert_close(out, want.float(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert torch.all(out[0] == 0)
    # without deg every slot counts (and a row past SPAN is split all the
    # same): the same sums once the values past deg are 0
    every = dg.gather_reduce(x, idx, torch.where(past, 0.0, val))
    torch.testing.assert_close(every, out, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [25, 600])
def test_gather_reduce_computes_pad_slots(cuda, k):
    """Without deg a pad slot multiplies row 0 by 0, as the plain version
    and JAX's kernel do: an infinite row 0 gives NaN in the same places on
    both.  With deg (build_ell's layout: the row's edges, then its pads) the
    pads are not read: row 0 reaches only the rows that have it as a real
    neighbour.  One kernel, both contracts."""
    x, idx, val = _gather_inputs(300, 64, 40, k, cuda)
    x[0, :8] = float("inf")
    out = dg.gather_reduce(x, idx, val)
    want = dg.gather_reduce_plain(x, idx, val)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    assert torch.isnan(out).any()
    deg = torch.from_numpy(np.random.default_rng(k).integers(
        1, k + 1, 40).astype(np.int32)).to(cuda)
    past = torch.arange(k, device=cuda)[None, :] >= deg[:, None]
    # id 0 only in the pads and as the first neighbour of every third row
    idx = torch.where(past, 0, torch.where(idx == 0, 1, idx))
    idx[::3, 0] = 0
    val = torch.where(past, 0.0, val)
    out = dg.gather_reduce(x, idx, val, deg)
    torch.testing.assert_close(out, dg.gather_reduce_plain(x, idx, val, deg),
                               rtol=RTOL, atol=ATOL, equal_nan=True)
    has_0 = ((idx == 0) & ~past).any(dim=1)
    assert (past.any(dim=1) & ~has_0).any()
    assert (~torch.isfinite(out[has_0])).any(dim=1).all()
    assert torch.isfinite(out[~has_0]).all()


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_do_not_take(cuda):
    x, idx, val = _gather_inputs(300, 64, 37, 25, cuda)
    with pytest.raises(TypeError, match="float32"):
        dg.gather_reduce(x.double(), idx, val)
    with pytest.raises(TypeError, match="int32"):
        dg.gather_reduce(x, idx.long(), val)
    with pytest.raises(TypeError, match="int32"):
        dg.gather_rows(x, idx[:, 0].long())
    with pytest.raises(ValueError, match="contiguous"):
        dg.gather_reduce(x, idx.T.contiguous().T, val)
    with pytest.raises(ValueError, match="multiple of 4"):
        dg.gather_reduce(x[:, :6].contiguous(), idx, val)
    with pytest.raises(ValueError, match="one device"):
        dg.gather_reduce(x, idx, val.cpu())
    with pytest.raises(ValueError, match="multiple of 4"):
        dg.gather_rows(x[:, :5].contiguous(), idx[:, 0].contiguous())
    flat = torch.empty(300 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        dg.gather_reduce(flat[1:].view(300, 64), idx, val)
    with pytest.raises(ValueError, match="16-byte"):
        dg.gather_rows(flat[1:].view(300, 64), idx[:, 0].contiguous())
    with pytest.raises(NotImplementedError, match="forward only"):
        dg.gather_rows(x.requires_grad_(), idx[:, 0].contiguous())


@pytest.mark.cuda
def test_lightgcn_hybrid_on_the_card_matches_the_cpu(cuda):
    """LightGCN on the hybrid tier with hub columns: forward and BPR
    gradients on the card against the CPU's plain path, and the launches of
    one BPR step (one gather_reduce per bucket and two gather_rows per SpMM,
    forward and backward)."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import ell

    g = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
    host = ell.build_adj_pair(g.joint_norm_adj("bi_norm", True),
                              symmetric=True, mode="hybrid", hub_min_degree=12)
    batch = np.stack([np.arange(32) % g.n_user, np.arange(32) % g.n_item,
                      (np.arange(32) * 7) % g.n_item], axis=1)
    outs, grads, launches = [], [], []
    for dev in (cuda, torch.device("cpu")):
        model = model_class("lightgcn")(
            g, model_preset("lightgcn", adj_mode="hybrid", reg=1e-4),
            device=dev, generator=torch.Generator().manual_seed(3))
        model.adj = ell.to_device(host, dev)
        with torch.no_grad():
            outs.append([t.cpu() for t in model.forward()])
        before = (dg.gather_reduce.launches, dg.gather_rows.launches)
        sum(model.bpr_loss(torch.as_tensor(batch, device=dev))).backward()
        launches.append((dg.gather_reduce.launches - before[0],
                         dg.gather_rows.launches - before[1]))
        grads.append([p.grad.cpu() for p in model.parameters()])
    n_layer, n_buckets = 3, len(host.fwd.ell.buckets)
    assert launches == [(2 * n_layer * n_buckets, 2 * n_layer * 2), (0, 0)]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=ATOL)


# ------------------------------------------- routed_mm's backward (DGCF family)

@pytest.mark.cuda
@pytest.mark.parametrize("n,m,r,base", [(301, 277, 80, 1.0), (9, 15000, 16, 0.0),
                                        (1537, 1001, 8, 1.0)])
def test_routed_mm_backward_matches_plain_autograd(cuda, n, m, r, base):
    """The backward of routed_mm, the routed_mm kernel over the rows of
    mask_t with q and k swapped, against the plain version's autograd in x
    evaluated in float64, on a non-symmetric mask with rows off the 16-byte
    words (its transpose's rows too); q and k get no gradient."""
    rng = np.random.default_rng(n + m)
    f, dx = 4, 16
    q, k, x, g = (torch.from_numpy((rng.standard_normal(shape)
                                    / np.sqrt(shape[2])).astype(np.float32))
                  .to(cuda) for shape in ((f, n, r), (f, m, r), (f, m, dx),
                                          (f, n, dx)))
    mask_np = _edge_rows_mask(n, m, seed=n)
    mask_np[:, 3] = False  # an empty column: its gradient is 0
    mask = torch.from_numpy(mask_np).to(cuda)
    mask_t = torch.from_numpy(np.ascontiguousarray(mask_np.T)).to(cuda)
    q.requires_grad_()
    x.requires_grad_()
    before = (fr.routed_mm.launches, fr.routed_mm_bwd.launches)
    e, et = _edges(mask), _edges(mask_t)
    fr.routed_mm(q, k, mask, x, base, mask_t=mask_t, edges=e,
                 edges_t=et).backward(g)
    torch.cuda.synchronize()
    assert (fr.routed_mm.launches, fr.routed_mm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert q.grad is None
    x64 = x.detach().double().requires_grad_()
    fr.routed_mm_plain(q.detach().double(), k.double(), mask, x64,
                       base).backward(g.double())
    torch.testing.assert_close(x.grad, x64.grad.float(), rtol=RTOL, atol=ATOL)
    assert torch.all(x.grad[:, 3] == 0)
    # the wrapper called directly gives the same, from an int8 mask_t too
    mask_t8 = mask_t.to(torch.int8)
    direct = fr.routed_mm_bwd(q.detach(), k, mask_t8, g, base,
                              edges=_edges(mask_t8))
    torch.testing.assert_close(direct, x.grad, rtol=0, atol=0)


@pytest.mark.cuda
def test_routed_mm_backward_needs_mask_t_on_the_card(cuda):
    q, k, mask, x = _inputs(4, 40, 30, 16, 16, False, cuda)
    e = _edges(mask)
    out = fr.routed_mm(q, k, mask, x.requires_grad_(), 1.0, edges=e)
    before = fr.routed_mm_bwd.launches
    with pytest.raises(ValueError, match="mask_t"):
        out.sum().backward()
    # and its edge list, whose absence the forward does not catch
    mask_t = mask.T.contiguous()
    out = fr.routed_mm(q, k, mask, x, 1.0, mask_t=mask_t, edges=e)
    with pytest.raises(ValueError, match="edges_t"):
        out.sum().backward()
    assert fr.routed_mm_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,rowsum", [
    ("dgcf", dict(reg=1e-3, cor_reg=0.1), 6), ("disengcn", dict(reg=1e-3), 0)])
def test_routed_models_on_the_card_match_the_cpu(cuda, name, cfg, rowsum):
    """DGCF and DisenGCN at the preset's widths on a small graph: forward,
    loss parts and BPR gradients on the card against the CPU's plain path,
    and the launches of one BPR step (DGCF: 6 routed_rowsum, 6 routed_mm
    and 3 backward; DisenGCN: 6 routed_mm and 3 backward: only each
    layer's last routing iteration reaches the loss other than through q
    and k)."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.models import model_class

    g = synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
    rng = np.random.default_rng(0)
    batch = np.stack([rng.integers(0, g.n_user, 64),
                      rng.integers(0, g.n_item, 64),
                      rng.integers(0, g.n_item, 64)], axis=1)
    cor = {"user": rng.integers(0, g.n_user, 50),
           "item": rng.integers(0, g.n_item, 50),
           "tag": rng.integers(0, g.n_tag, 50)}
    outs, parts, grads, launches = [], [], [], []
    counters = (fr.routed_rowsum, fr.routed_mm, fr.routed_mm_bwd)
    for dev in (cuda, torch.device("cpu")):
        model = model_class(name)(g, model_preset(name, **cfg), device=dev,
                                  generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append([t.cpu() for t in model.forward()])
        before = [c.launches for c in counters]
        p = model.bpr_loss(torch.as_tensor(batch, device=dev),
                           cor={key: torch.as_tensor(v, device=dev)
                                for key, v in cor.items()})
        sum(p).backward()
        launches.append([c.launches - b for c, b in zip(counters, before)])
        parts.append(torch.stack([t.detach().cpu() for t in p]))
        grads.append([t.grad.cpu() for t in model.parameters()])
    assert launches == [[rowsum, 6, 3], [0, 0, 0]]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(parts[0], parts[1], rtol=RTOL, atol=ATOL)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=ATOL)


# --------------------------------------------- NGCF's asymmetric pair, bf16

@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_gather_reduce_on_an_asymmetric_pairs_transpose(cuda, d):
    """gather_reduce at NGCF's widths on every bucket of the forward and
    of the transpose tables of D^-1 A (hub columns forced), each with its
    degrees; and the pair's backward (A^T g, over the transpose tables) on
    the card against the CPU's."""
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.ops import ell, propagate

    g = synthetic_graph(n_user=300, n_item=800, n_tag=120, avg_deg=12, seed=5)
    host = ell.build_adj_pair(g.joint_norm_adj("si_norm", True),
                              symmetric=False, mode="hybrid",
                              hub_min_degree=24)
    pair = ell.to_device(host, cuda)
    assert pair.bwd is not pair.fwd and pair.bwd.ell.parts
    n = host.fwd.ell.n_rows
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        cuda)
    for side in (pair.fwd, pair.bwd):
        for p in side.ell.parts:
            got = dg.gather_reduce(x, p.idx, p.val, p.deg)
            torch.testing.assert_close(
                got, dg.gather_reduce_plain(x, p.idx, p.val, p.deg),
                rtol=RTOL, atol=ATOL)
    xg = x.clone().requires_grad_()
    gy = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    propagate.adj_mm(pair, xg).backward(gy.to(cuda))
    cpu = ell.to_device(host, "cpu")
    xc = x.cpu().requires_grad_()
    propagate.adj_mm(cpu, xc).backward(gy)
    torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_ell_mm_t_on_the_card_is_deterministic(cuda):
    """node_drop's backward A^T @ g over a skewed table (a few hub columns
    take most slots): two eager calls and a replayed CUDA graph agree bit
    for bit, and all match the float64 sum on the CPU."""
    from tagrec_tpu_torch.ops import ell, propagate

    rng = np.random.default_rng(8)
    n, m, d, e = 3000, 2000, 64, 120_000
    row = rng.integers(0, n, e)
    col = np.where(rng.random(e) < 0.5, rng.integers(0, 4, e),
                   rng.integers(0, m, e))
    val = rng.standard_normal(e)
    host = ell.build_ell(row, col, val, n, m)
    t = ell.to_device(host, cuda)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        cuda)
    first = propagate.ell_mm_t(t, g, m)
    assert torch.equal(propagate.ell_mm_t(t, g, m), first)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        propagate.ell_mm_t(t, g, m)
        with torch.cuda.graph(graph):
            static = propagate.ell_mm_t(t, g, m)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    assert torch.equal(static, first)
    want = propagate.ell_mm_t(ell.to_device(host, "cpu"), g.cpu().double(),
                              m)  # float32 values times float64 g: float64
    torch.testing.assert_close(first.cpu().double(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(2000, 10000, 64), (3000, 2000, 32)])
def test_bf16_block_product_accumulates_in_float32(cuda, n, m, d):
    """A bfloat16 block times x: ``torch.mm(..., out_dtype=float32)`` on the
    card against the float32 product of the bfloat16-rounded operands; the
    result is float32, not rounded to bfloat16."""
    from tagrec_tpu_torch.ops import propagate

    rng = np.random.default_rng(n)
    b = torch.from_numpy((rng.random((n, m)) < 0.01).astype(np.float32)
                         * rng.random((n, m)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    bb = b.to(torch.bfloat16).to(cuda)
    got = propagate.block_mm(bb, x.to(cuda))
    assert got.dtype == torch.float32
    want = bb.double() @ x.to(cuda).to(torch.bfloat16).double()
    torch.testing.assert_close(got.double(), want, rtol=RTOL, atol=ATOL)
    assert not torch.equal(got, got.to(torch.bfloat16).float())


# ------------------------------------------ KGAT over a KG, and TGCN (no kernel)

def _small_graph():
    from tagrec_tpu_torch.data.synthetic import synthetic_graph

    return synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)


def _card_against_cpu(make_model, batch):
    """``make_model(device)``'s forward and BPR gradients on the card
    against the CPU's, from the same seeded weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        model = make_model(dev)
        with torch.no_grad():
            outs.append([t.cpu() for t in model.forward()])
        sum(model.bpr_loss(torch.as_tensor(batch, device=dev))).backward()
        grads.append([p.grad.cpu() for p in model.parameters()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=ATOL)


@pytest.mark.cuda
def test_kgat_over_a_kg_on_the_card_matches_the_cpu(cuda):
    """The relation-dense tier (cuBLAS score planes, selects, softmax)."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.kg import KnowledgeGraph
    from tagrec_tpu_torch.models import model_class

    g = _small_graph()
    kg = KnowledgeGraph.synthetic(g, n_entity=120, n_triples=400, n_rela=3)
    batch = np.stack([np.arange(32) % g.n_user, np.arange(32) % g.n_item,
                      (np.arange(32) * 7) % g.n_item], axis=1)
    _card_against_cpu(lambda dev: model_class("kgat")(
        g, model_preset("kgat", agg_type="bi_inter", reg=1e-4), kg=kg,
        device=dev, generator=torch.Generator().manual_seed(3)), batch)


@pytest.mark.cuda
def test_tgcn_auto_on_the_card_matches_the_cpu(cuda):
    """TGCN's dedup tier, the same host tables on both devices."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class

    g = _small_graph()
    batch = np.stack([np.arange(32) % g.n_user, np.arange(32) % g.n_item,
                      (np.arange(32) * 7) % g.n_item], axis=1)
    _card_against_cpu(lambda dev: model_class("tgcn")(
        g, model_preset("tgcn", reg=1e-4), device=dev,
        generator=torch.Generator().manual_seed(3)), batch)


# ------------------------------------------ the EdgeMap tier (gather_reduce)

def _wide_edgemap(device):
    """An EdgeMap of 400 rows over 3,000 columns: row 0 with 2,500 edges
    (past WIDE_K and SPAN: blocks of 8 warps, split across blocks), rows
    1..299 with a few each, rows 300..399 with none (a zero-width bucket)."""
    from tagrec_tpu_torch.ops import edgemap

    rng = np.random.default_rng(31)
    rows = np.concatenate([np.zeros(2500, np.int64),
                           rng.integers(1, 300, 3000)])
    cols = np.concatenate([rng.permutation(3000)[:2500],
                           rng.integers(0, 3000, 3000)])
    host = edgemap.build_edge_map(rows, cols, None, 400, 3000)
    assert host.f.buckets[0].idx.shape[1] == 0
    return edgemap.to_device(host, device)


@pytest.mark.cuda
def test_edge_reduce_on_the_card_matches_plain_float64(cuda):
    """``edge_reduce`` at D = 16 with a leading F = 4 axis launches
    ``gather_reduce`` once per factor and non-empty bucket (the zero-width
    bucket launches nothing) and matches its plain version evaluated in
    float64 on the CPU; its backward (d x over the transpose tables, two
    launch sets; d vals by gathers) matches the plain backward in float64.
    On a float64 CUDA tensor it raises rather than fall back."""
    from tagrec_tpu_torch.ops import edgemap

    em, em_cpu = _wide_edgemap(cuda), _wide_edgemap("cpu")
    rng = np.random.default_rng(5)
    vals = [rng.standard_normal((4,) + tuple(i.shape)) * m.numpy()
            for i, m in zip(em_cpu.f_idx, em_cpu.masks())]
    x = rng.standard_normal((4, 3000, 16))
    g = rng.standard_normal((4, 400, 16))

    def run(emap, dev, dtype):
        v = [torch.tensor(a, dtype=dtype, device=dev, requires_grad=True)
             for a in vals]
        xt = torch.tensor(x, dtype=dtype, device=dev, requires_grad=True)
        out = edgemap.edge_reduce(emap, tuple(v), xt)
        out.backward(torch.tensor(g, dtype=dtype, device=dev))
        return out.detach().cpu(), xt.grad.cpu(), [t.grad.cpu() for t in v]

    before = dg.gather_reduce.launches
    got = run(em, cuda, torch.float32)
    torch.cuda.synchronize()
    live_f = sum(1 for i in em.f_idx if i.shape[1])
    live_b = sum(1 for i in em.b_idx if i.shape[1])
    assert dg.gather_reduce.launches - before == 4 * (live_f + live_b)
    want = run(em_cpu, "cpu", torch.float64)
    torch.testing.assert_close(got[0].double(), want[0], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got[1].double(), want[1], rtol=5e-4,
                               atol=ATOL)
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a.double(), b, rtol=5e-4, atol=ATOL)
    with pytest.raises(TypeError, match="float32"):
        edgemap.edge_reduce(em, tuple(torch.tensor(a, device=cuda)
                                      for a in vals),
                            torch.tensor(x, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgcf", "disengcn", "disenhan", "kgat",
                                  "tgcn"])
def test_edgemap_tier_on_the_card_matches_the_cpu(cuda, name):
    """Each model's ``adj_mode="ell"`` tier: forward and BPR gradients on
    the card (``gather_reduce`` under ``edge_reduce``) against the CPU's,
    from the same seeded weights."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class

    g = _small_graph()
    batch = np.stack([np.arange(32) % g.n_user, np.arange(32) % g.n_item,
                      (np.arange(32) * 7) % g.n_item], axis=1)
    cfg = dict(adj_mode="ell", reg=1e-4)
    if name == "kgat":
        cfg["agg_type"] = "bi_inter"
    before = dg.gather_reduce.launches
    _card_against_cpu(lambda dev: model_class(name)(
        g, model_preset(name, **cfg), device=dev,
        generator=torch.Generator().manual_seed(3)), batch)
    assert (dg.gather_reduce.launches > before) == (name != "tgcn")


# ------------------------------------------ the Trainer's captured step

# a TransE batch of 128 gives the small graph's TransE phase 13 steps an
# epoch (1 at the preset's 1024), so that it is captured in the first
KGAT_CAPTURED = dict(agg_type="bi_inter", reg=1e-4, transe_batch=128)

def _capture_pipeline(name, cfg):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig, model_preset

    tcfg = TrainConfig(train_batch=64)
    pipe = build_pipeline(_small_graph(), model_preset(name, **cfg), tcfg,
                          device="cuda",
                          generator=torch.Generator().manual_seed(0))
    return pipe, tcfg


def _train(pipe, tcfg, snap, gstate, capture, steps, epochs=1, patch=None):
    """``epochs`` epochs of ``steps`` steps a phase through a new Trainer
    (a fresh Adam) from the snapshot's parameters and generator state ->
    (losses, parameters, launches per counter, trainer)."""
    from tagrec_tpu_torch.training.train import COUNTED, Trainer

    with torch.no_grad():
        for p, s in zip(pipe.model.parameters(), snap):
            p.copy_(s)
    gen = torch.Generator(device="cuda")
    gen.set_state(gstate)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, generator=gen,
                      capture=capture)
    if patch is not None:
        patch(trainer)
    before = [f.launches for f in COUNTED]
    losses = [torch.from_numpy(v) for _ in range(epochs)
              for v in trainer.run_epoch(max_steps=steps).values()]
    torch.cuda.synchronize()
    return (losses, [p.detach().clone() for p in pipe.model.parameters()],
            [f.launches - b for f, b in zip(COUNTED, before)], trainer)


def _capture_holds(got, a, b):
    """chip_smoke.py's rule: each captured tensor equals the first eager
    run's bit for bit where the two eager runs agree, else lies within 4x
    their difference -> the names that fail."""
    bad = []
    for i, (x, y, z) in enumerate(zip(got, a, b)):
        if torch.equal(y, z):
            ok = torch.equal(x, y)
        else:
            ok = float((x - y).abs().max()) <= 4.0 * float((z - y).abs().max())
        if not ok:
            bad.append(i)
    return bad


def _snapshot(pipe):
    return ([p.detach().clone() for p in pipe.model.parameters()],
            torch.Generator(device="cuda").manual_seed(11).get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg", [
    ("dgcf", dict(reg=1e-3, cor_reg=0.1)),
    ("kgat", KGAT_CAPTURED),
    ("lightgcn", dict(adj_mode="hybrid", reg=1e-4))])
def test_captured_training_matches_eager(cuda, name, cfg):
    """Two epochs of 5 steps a phase (2 eager warm-up steps, then the
    capture and replays; the second epoch all replays) from one snapshot:
    the captured run's losses and parameters against two eager runs',
    under chip_smoke.py's rule, and the same launches."""
    pipe, tcfg = _capture_pipeline(name, cfg)
    snap, gstate = _snapshot(pipe)
    a, b, c = (_train(pipe, tcfg, snap, gstate, capture, 5, epochs=2)
               for capture in (False, False, True))
    assert all(run.graph is not None for run in c[3].runs.values())
    assert not any(run.graph for run in a[3].runs.values())
    assert len(c[3].runs) == len(pipe.phases) == (2 if name == "kgat" else 1)
    assert c[2] == a[2] == b[2]
    assert sum(c[2]) > 0  # the path ran its kernels
    assert _capture_holds(c[0], a[0], b[0]) == []
    assert _capture_holds(c[1], a[1], b[1]) == []


@pytest.mark.cuda
def test_replays_move_the_launch_counters(cuda):
    """DGCF: every step of an epoch, eager or replayed, counts its 6
    routed_rowsum, 6 routed_mm and 3 backward launches once ``run_phase``
    returns (the replays are added once an epoch, the eager steps as they
    launch)."""
    from tagrec_tpu_torch.training.train import Trainer

    pipe, tcfg = _capture_pipeline("dgcf", dict(reg=1e-3))
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    counters = (fr.routed_rowsum, fr.routed_mm, fr.routed_mm_bwd)
    seen = []
    for _ in range(2):
        before = [c.launches for c in counters]
        trainer.run_phase(pipe.phases[0], max_steps=5)
        seen.append([c.launches - b for c, b in zip(counters, before)])
    assert trainer.runs["bpr"].graph is not None
    assert seen == [[30, 30, 15]] * 2
    assert trainer.runs["bpr"].launches[:3] == (6, 6, 3)


@pytest.mark.cuda
def test_capture_without_clearing_grads_is_caught(cuda):
    """A planted fault: KGAT's TransE graph captured without clearing the
    grads to None adds each replay's gradients into the warm-up's; the
    hold of the captured run against the eager ones catches it."""
    pipe, tcfg = _capture_pipeline("kgat", KGAT_CAPTURED)
    snap, gstate = _snapshot(pipe)

    def keep_grads(trainer):
        capture = trainer._capture

        def faulty(phase, run):
            if phase.name == "transe":
                trainer.opt.zero_grad = lambda set_to_none=True: None
            try:
                capture(phase, run)
            finally:
                trainer.opt.__dict__.pop("zero_grad", None)
        trainer._capture = faulty

    a, b = (_train(pipe, tcfg, snap, gstate, False, 5) for _ in range(2))
    good = _train(pipe, tcfg, snap, gstate, True, 5)
    bad = _train(pipe, tcfg, snap, gstate, True, 5, patch=keep_grads)
    assert _capture_holds(good[1], a[1], b[1]) == []
    assert _capture_holds(bad[1], a[1], b[1]) != []


@pytest.mark.cuda
def test_resume_under_capturable_adam_continues_exactly(cuda, tmp_path):
    """A train state saved after a captured epoch (Adam's counts on the
    card) restored into a new model and Trainer continues as the
    uninterrupted run does, under chip_smoke.py's rule against a second
    uninterrupted run."""
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    cfg = KGAT_CAPTURED
    pipe, tcfg = _capture_pipeline("kgat", cfg)
    snap, gstate = _snapshot(pipe)
    path = str(tmp_path / "state.npz")

    def uninterrupted(save):
        _, _, _, trainer = _train(pipe, tcfg, snap, gstate, True, 4)
        if save:
            checkpoint.save_train_state(path, pipe.model, trainer.opt, 1)
        mid = trainer.generator.get_state()
        trainer.run_epoch(max_steps=4)
        return [p.detach().clone() for p in pipe.model.parameters()], mid

    want, mid = uninterrupted(True)
    want2, _ = uninterrupted(False)
    resumed, _ = _capture_pipeline("kgat", cfg)
    gen = torch.Generator(device="cuda")
    gen.set_state(mid)
    trainer = Trainer(resumed.model, resumed.phases, tcfg, generator=gen)
    assert checkpoint.restore_train_state(path, resumed.model,
                                          trainer.opt) == 1
    assert all(st["step"].device.type == "cuda"
               for st in trainer.opt.state.values())
    trainer.run_epoch(max_steps=4)
    got = [p.detach().clone() for p in resumed.model.parameters()]
    assert _capture_holds(got, want, want2) == []


@pytest.mark.cuda
def test_a_capture_that_fails_names_its_phase(cuda):
    """An operation that reads back to the host inside the step stops the
    capture: the Trainer raises, naming the phase; it does not fall back."""
    import dataclasses

    from tagrec_tpu_torch.training.train import Trainer

    pipe, tcfg = _capture_pipeline("lightgcn", {})
    (bpr,) = pipe.phases

    def loss_fn(batch, gen):
        parts = bpr.loss_fn(batch, gen)
        torch.nonzero(batch[:, 0] > 0)  # a host read
        return parts

    bad = dataclasses.replace(bpr, name="bad", loss_fn=loss_fn)
    trainer = Trainer(pipe.model, [bad], tcfg,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    with pytest.raises(RuntimeError, match="capture of phase 'bad' failed"):
        trainer.run_phase(bad, max_steps=4)


@pytest.fixture
def process_group(cuda):
    """A one-rank process group in this process; ``start(backend)``
    makes it, and it is torn down after the test."""
    import torch.distributed as dist

    def start(backend):
        kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if backend == "nccl" else {})
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.cuda
def test_capture_on_a_gloo_mesh_raises(process_group):
    """gloo's collectives cannot be captured: asking for a capture on a
    gloo mesh raises and names the reason; ``capture=False`` steps."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh
    from tagrec_tpu_torch.training.train import Trainer

    process_group("gloo")
    mesh = make_mesh(1)
    pipe, tcfg = _capture_pipeline("dgcf", dict(reg=1e-3))
    gen = torch.Generator(device="cuda").manual_seed(0)
    with pytest.raises(ValueError, match="cannot capture.*'gloo'"):
        Trainer(pipe.model, pipe.phases, tcfg, generator=gen, mesh=mesh)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, generator=gen,
                      mesh=mesh, capture=False)
    assert np.isfinite(trainer.run_phase(pipe.phases[0], max_steps=3)).all()
    assert trainer.runs["bpr"].graph is None


@pytest.mark.cuda
def test_one_rank_nccl_mesh_captures_bit_for_bit(process_group):
    """DGCF with its correlation term, captured on a one-rank NCCL mesh
    (the all-gathers and the gradient all-reduce inside the graph) and
    without one: the same losses and parameters, bit for bit."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.parallel.mesh import make_mesh
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    process_group("nccl")
    out = []
    for mesh in (None, make_mesh(1)):
        pipe, tcfg = _capture_pipeline("dgcf", dict(reg=1e-3, cor_reg=0.1))
        trainer = Trainer(pipe.model, pipe.phases, tcfg, mesh=mesh,
                          generator=torch.Generator(device="cuda").manual_seed(0))
        losses = trainer.run_phase(pipe.phases[0], max_steps=5)
        assert trainer.runs["bpr"].graph is not None
        with torch.no_grad(), sharding.gathered():
            out.append((losses, {n: sharding.value(pipe.model, n).clone()
                                 for n in checkpoint.jax_leaf_order(
                                     pipe.model)}))
    (l0, p0), (l1, p1) = out
    np.testing.assert_array_equal(l1, l0)
    assert all(torch.equal(p1[n], p0[n]) for n in p0)
