"""The port's routing ops (tagrec_tpu_torch.ops.flash_routing) against the JAX
Pallas kernels, which run here in interpret mode as in test_flash_routing.py.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those plain versions on the card
(test_torch_cuda_kernels.py and chip_smoke.py).  Tolerance: rtol 1e-4,
atol 1e-5 (float32 on both sides, sums taken in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.ops import flash_routing as jfr
from tagrec_tpu_torch.ops import flash_routing as tfr

RTOL, ATOL = 1e-4, 1e-5

# (r, base, all-zero q and k): test_flash_routing.py's r=8 fixture at both
# bases, a rank that is no power of two, and DGCF's all-zero first iteration
CASES = [(8, 0.0, False), (8, 1.0, False), (48, 1.0, False), (8, 1.0, True)]


def _inputs(r, zero):
    rng = np.random.default_rng(21)
    f, n, m, dx = 3, 70, 50, 5
    q = rng.standard_normal((f, n, r)).astype(np.float32)
    k = rng.standard_normal((f, m, r)).astype(np.float32)
    x = rng.standard_normal((f, m, dx)).astype(np.float32)
    mask = rng.random((n, m)) < 0.2
    mask[5, :] = False  # empty row
    if zero:
        q[:], k[:] = 0.0, 0.0
    return q, k, x, mask


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("r,base,zero", CASES)
def test_routed_mm_matches_jax(r, base, zero):
    q, k, x, mask = _inputs(r, zero)
    want = jfr.routed_mm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask),
                         jnp.asarray(x), base)
    with torch.no_grad():
        got = tfr.routed_mm(*_torch(q, k, mask, x), base=base)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("r,base,zero", CASES)
def test_routed_rowsum_matches_jax(r, base, zero):
    q, k, _, mask = _inputs(r, zero)
    want = np.asarray(jfr.routed_rowsum(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(mask), base))
    got = tfr.routed_rowsum(*_torch(q, k, mask), base=base).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:, 5] == 0.0)  # empty row -> zero degree


def test_cpu_calls_launch_no_kernel():
    q, k, x, mask = _torch(*_inputs(8, False))
    counters = (tfr.routed_rowsum, tfr.routed_mm, tfr.routed_mm_bwd)
    before = [c.launches for c in counters]
    with torch.no_grad():
        tfr.routed_rowsum(q, k, mask, 1.0)
        tfr.routed_mm(q, k, mask, x, 1.0)
    tfr.routed_mm(q, k, mask, x.requires_grad_(), 1.0).sum().backward()
    assert [c.launches for c in counters] == before


def test_routed_mm_is_forward_only_and_checks_shapes():
    """routed_mm is differentiable in x only, with the backward of JAX's
    custom VJP (the sweep over the mask's transpose; test_torch_dgcf_training.py
    holds it against JAX's), and checks shapes and dtypes, mask_t's too."""
    q, k, x, mask = _torch(*_inputs(8, False))
    q.requires_grad_()
    out = tfr.routed_mm(q, k, mask, x.requires_grad_(), 1.0)
    g = torch.ones_like(out)
    out.backward(g)
    assert q.grad is None and k.grad is None
    with torch.no_grad():
        want = tfr.routed_mm_plain(k, q, mask.T, g, 1.0)
    torch.testing.assert_close(x.grad, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfr.routed_rowsum(q, k[:, :-1], mask)
    with pytest.raises(TypeError, match="mask dtype"):
        tfr.routed_rowsum(q, k, mask.float())
    with pytest.raises(ValueError, match="shape mismatch"):
        tfr.routed_mm(q, k, mask, x, 1.0, mask_t=mask)
    with pytest.raises(TypeError, match="mask dtype"):
        tfr.routed_mm(q, k, mask, x, 1.0, mask_t=mask.T.float())



@pytest.mark.parametrize("f,r,match", [(5, 16, "factors"), (0, 16, "factors"),
                                       (4, 129, "out of range"),
                                       (4, 0, "out of range")])
@pytest.mark.parametrize("with_x", [False, True])
def test_kernel_limits_are_one_set_for_both(f, r, match, with_x):
    """routed_rowsum's kernel takes routed_mm's F and r limits (one edge
    sweep serves both); F = 4 and r = 128 pass."""
    mask = torch.ones((6, 5), dtype=torch.bool)
    x = torch.zeros((4, 5, 16)) if with_x else None
    tfr._check_kernel_args(torch.zeros((4, 6, 128)), torch.zeros((4, 5, 128)),
                           mask, x)
    x = torch.zeros((f, 5, 16)) if with_x else None
    with pytest.raises(ValueError, match=match):
        tfr._check_kernel_args(torch.zeros((f, 6, r)),
                               torch.zeros((f, 5, r)), mask, x)


# ------------------------------------------------ the kernels' edge lists

def _list_mask(dtype, seed=0, n=70, m=301):
    """Sparse rows, empty rows (first, last and one inside), a row with
    every column set, and int8 bytes of either sign."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, m)) < 0.05
    mask[[0, 9, n - 1]] = False
    mask[3] = True
    if dtype == np.int8:
        return (mask * rng.choice([-3, 1, 2, 7], size=(n, m))).astype(np.int8)
    return mask


def _decoded(edges):
    """(rows, cols, bytes) of a list's entries, on the host."""
    indptr = edges.indptr.numpy()
    e = edges.entries.numpy().view(np.uint32)
    rows = np.repeat(np.arange(edges.rows), np.diff(indptr))
    return rows, (e & (tfr._MAX_COLS - 1)).astype(np.int64), \
        (e >> 24).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("dtype", [bool, np.int8])
def test_mask_edges_are_the_masks_nonzero_row_by_row(dtype):
    mask = _list_mask(dtype)
    edges = tfr.mask_edges(torch.from_numpy(mask))
    rows, cols = np.nonzero(mask)
    got_rows, got_cols, got_bytes = _decoded(edges)
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_cols, cols)
    np.testing.assert_array_equal(got_bytes, mask[rows, cols].astype(np.int8))
    assert (edges.rows, edges.cols, edges.row0, edges.nnz) == (
        70, 301, 0, len(rows))
    assert edges.indptr.dtype == edges.entries.dtype == torch.int32
    # the full row (301 edges) is heavier than several segments
    assert 301 > 3 * edges.seg_len


def test_a_ranks_rows_are_the_slice_of_the_whole_list():
    mask = _list_mask(np.int8, seed=1)
    whole = tfr.mask_edges(mask)
    s0, s1 = 3, 40
    part = tfr.mask_edges(mask[s0:s1], row0=s0, seg_len=whole.seg_len)
    ip = whole.indptr.numpy()
    assert (part.row0, part.rows, part.cols) == (s0, s1 - s0, 301)
    np.testing.assert_array_equal(part.indptr.numpy(), ip[s0:s1 + 1] - ip[s0])
    np.testing.assert_array_equal(part.entries.numpy(),
                                  whole.entries.numpy()[ip[s0]:ip[s1]])
    # its rows cut as the whole list cuts them, so their sums are the
    # whole launch's bit for bit: (row, first and end offset in the row)
    def cuts(e):
        segs = e.segs.numpy()
        row = segs[:, 0] + e.row0
        keep = (row >= s0) & (row < s1)
        start = e.indptr.numpy()[segs[keep, 0]]
        return sorted(zip(row[keep], segs[keep, 1] - start,
                          segs[keep, 2] - start))
    assert cuts(part) == cuts(whole)


def _assert_plan(edges):
    """Every edge in exactly one segment, each row's segments in order and
    at most seg_len long, one (empty) segment an empty row, longest first;
    the split rows' slots consecutive in segment order."""
    segs, splits = edges.segs.numpy(), edges.splits.numpy()
    indptr = edges.indptr.numpy()
    length = segs[:, 2] - segs[:, 1]
    assert np.all(length <= edges.seg_len) and np.all(np.diff(length) <= 0)
    by_row = segs[np.lexsort((segs[:, 1], segs[:, 0]))]
    nseg = np.bincount(by_row[:, 0], minlength=edges.rows)
    assert np.all(nseg >= 1)
    first = np.cumsum(nseg) - nseg
    np.testing.assert_array_equal(by_row[first, 1], indptr[:-1])
    np.testing.assert_array_equal(by_row[first + nseg - 1, 2], indptr[1:])
    inner = np.ones(len(by_row), bool)
    inner[first] = False
    np.testing.assert_array_equal(by_row[inner, 1], by_row[np.flatnonzero(
        inner) - 1, 2])  # each segment starts where its row's last ended
    split = nseg > 1
    np.testing.assert_array_equal(by_row[:, 3] >= 0, split[by_row[:, 0]])
    np.testing.assert_array_equal(by_row[split[by_row[:, 0]], 3],
                                  np.arange(edges.slots))
    np.testing.assert_array_equal(splits[:, 0], np.flatnonzero(split))
    np.testing.assert_array_equal(splits[:, 2], nseg[split])
    np.testing.assert_array_equal(splits[:, 1], by_row[first[split], 3])


@pytest.mark.parametrize("dtype", [bool, np.int8])
def test_segments_cover_every_edge_once(dtype):
    from tagrec_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    try:
        edges = tfr.mask_edges(_list_mask(dtype, seed=2))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    _assert_plan(edges)
    assert counters == {"routing.edges": edges.nnz,
                        "routing.segments": edges.segs.shape[0],
                        "routing.split_rows": edges.splits.shape[0]}
    assert edges.splits.shape[0] >= 1 and edges.slots > edges.splits.shape[0]
    empty = tfr.mask_edges(np.zeros((4, 9), bool))
    _assert_plan(empty)
    assert (empty.nnz, empty.slots, empty.segs.shape[0]) == (0, 0, 4)


def test_seg_edges_follow_the_edge_count_and_the_card():
    # hetrec's joint mask on an H100: 986,300 edges over 132 SMs
    assert tfr.seg_edges(986_300, 132) == 152
    assert tfr.seg_edges(986_300 // 2, 132) == 72  # a rank's half
    assert tfr.seg_edges(700, 132) == 32            # the floor
    assert tfr.seg_edges(986_300, 66) == 304        # fewer SMs, longer


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("half", [False, True])
def test_coo_edges_equal_the_dense_masks_list(transpose, half):
    """From the coordinates a mask came from (duplicates too), of it or its
    transpose, over all rows or the second half: mask_edges of the same
    rows."""
    from tagrec_tpu_torch.ops import dense_adj

    rng = np.random.default_rng(3)
    row, col = rng.integers(0, 128, 900), rng.integers(0, 96, 900)
    row, col = np.concatenate([row, row[:50]]), np.concatenate([col, col[:50]])
    host = dense_adj.dense_mask_host(row, col, 128, 96)
    host = host.T if transpose else host
    n = host.shape[0]
    block = (n // 2, n) if half else None
    s0, s1 = block or (0, n)
    got = tfr.coo_edges(row, col, (128, 96), block, transpose)
    want = tfr.mask_edges(np.ascontiguousarray(host[s0:s1]), row0=s0)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert got[4:] == want[4:]


class _Mesh:
    """A ``model`` axis of 2, this process its rank 1."""
    shape = {"model": 2}

    def index(self, axis):
        return 1


@pytest.mark.parametrize("mesh", [None, _Mesh()])
def test_routing_masks_hand_out_the_lists(mesh):
    """A symmetric mask's list serves both sweeps; an asymmetric one's
    transpose gets its own; under a mesh each list holds the rank's rows
    its buffer holds; ``dense_xla`` builds none."""
    from types import SimpleNamespace

    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph
    from tagrec_tpu_torch.models import base, model_class

    if mesh is None:
        model = model_class("dgcf")(
            synthetic_graph(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7),
            model_preset("dgcf"), device="cpu",
            generator=torch.Generator().manual_seed(0))
        mask, mask_t, edges, edges_t = model.routing_masks()
        assert model.maskT is None and mask_t is mask and edges_t is edges
        for a, b in zip(edges[:4], tfr.mask_edges(model.mask)[:4]):
            assert torch.equal(a, b)

    class Masks(base.RoutingMaskGraph, torch.nn.Module):
        def __init__(self, coo, flash):
            super().__init__()
            self.flash = flash
            self.register_buffer("mask", None)
            self.register_buffer("maskT", None)
            self.place_routing_masks(coo, mesh, torch.device("cpu"))

    rng = np.random.default_rng(4)
    coo = SimpleNamespace(row=rng.integers(0, 128, 700),
                          col=rng.integers(0, 96, 700), shape=(128, 96))
    model = Masks(coo, flash=True)
    mask, mask_t, edges, edges_t = model.routing_masks()
    assert model.maskT is not None and edges_t is not edges
    for name, lst, row0 in (("mask", edges, 0 if mesh is None else 64),
                            ("maskT", edges_t, 0 if mesh is None else 48)):
        want = tfr.mask_edges(getattr(model, name), row0=row0)
        assert lst.row0 == row0 and lst.rows == getattr(model, name).shape[0]
        for a, b in zip(lst[:4], want[:4]):
            assert torch.equal(a, b)
    assert Masks(coo, flash=False).routing_edges == {}


def test_cpu_calls_take_the_list_and_the_card_checks_it():
    """On the CPU a list changes nothing; what a launch checks of it: there
    at all, the rows swept, and the device."""
    q, k, x, mask = _torch(*_inputs(8, False))
    edges = tfr.mask_edges(mask)
    with torch.no_grad():
        torch.testing.assert_close(
            tfr.routed_mm(q, k, mask, x, 1.0, edges=edges, edges_t=edges),
            tfr.routed_mm(q, k, mask, x, 1.0), rtol=0, atol=0)
    tfr._check_edges("routed_mm", edges, mask, 0, q)
    with pytest.raises(ValueError, match="needs edges="):
        tfr._check_edges("routed_mm", None, mask, 0, q)
    with pytest.raises(ValueError, match="needs edges_t="):
        tfr._check_edges("routed_mm_bwd", None, mask.T, 0, q, "edges_t")
    part = tfr.mask_edges(mask[10:], row0=10)
    with pytest.raises(ValueError, match="not the mask's"):
        tfr._check_edges("routed_rowsum", part, mask[10:], 0, q)
    with pytest.raises(ValueError, match="not the mask's"):
        tfr._check_edges("routed_rowsum", edges, mask[10:], 10, q)
    tfr._check_edges("routed_rowsum", part, mask[10:], 10, q)
