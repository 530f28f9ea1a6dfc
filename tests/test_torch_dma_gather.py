"""The port's row gather and ELL gather-reduce (plain versions, the CPU path
of their wrappers) against the JAX package's Pallas kernels in interpret
mode, on the same seeded inputs.

gather_rows must equal JAX's bit for bit (a copy); gather_reduce within
rtol 1e-5, atol 1e-5 (float32 sums of up to 25 terms in another order),
with and without the rows' degrees, on random tables and on one that the
port's build_ell packs from a seeded COO.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.ops import dma_gather as jdg
from tagrec_tpu_torch.ops import dma_gather as dg
from tagrec_tpu_torch.ops.ell import build_ell

RTOL, ATOL = 1e-5, 1e-5
ROWS = (7, 256)
REDUCE = ((64, 25), (300, 7))


def _rows_inputs(r):
    rng = np.random.default_rng(r)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    return x, rng.integers(0, 300, size=r).astype(np.int32)


def _reduce_inputs(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((200, 64)).astype(np.float32)
    idx = rng.integers(0, 200, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(np.float32)
    pad = rng.random((n, k)) < 0.2  # pad slots: id 0, value 0
    idx[pad], val[pad] = 0, 0.0
    return x, idx, val


def _ell_inputs():
    """x and the ELL table (EllHost) that build_ell packs from a seeded COO
    of 48 rows over 200 columns: degrees 0 to about 18, every edge before
    every pad, column 0 a real neighbour of a few rows."""
    rng = np.random.default_rng(5)
    row = rng.integers(0, 48, 400)
    row[row == 7] = 8  # row 7 has no edge
    col = rng.integers(0, 200, 400)
    col[:3] = 0
    val = rng.standard_normal(400).astype(np.float32)
    x = rng.standard_normal((200, 64)).astype(np.float32)
    return x, build_ell(row, col, val, 48, 200)


@pytest.fixture(scope="module")
def jax_out():
    rows = {r: np.asarray(jdg.gather_rows(*map(jnp.asarray, _rows_inputs(r)),
                                          block_rows=256)) for r in ROWS}
    red = {nk: np.asarray(jdg.gather_reduce(
        *map(jnp.asarray, _reduce_inputs(*nk)), block_n=64)) for nk in REDUCE}
    x, h = _ell_inputs()
    ell = np.asarray(jdg.gather_reduce(jnp.asarray(x), jnp.asarray(h.idx),
                                       jnp.asarray(h.val), block_n=64))
    return rows, red, ell


@pytest.mark.parametrize("r", ROWS)
def test_gather_rows_equals_jax(jax_out, r):
    x, idx = _rows_inputs(r)
    before = dg.gather_rows.launches
    got = dg.gather_rows(torch.from_numpy(x), torch.from_numpy(idx))
    assert dg.gather_rows.launches == before  # the CPU runs no kernel
    np.testing.assert_array_equal(got.numpy(), jax_out[0][r])
    np.testing.assert_array_equal(got.numpy(), x[idx])


@pytest.mark.parametrize("n,k", REDUCE)
def test_gather_reduce_equals_jax(jax_out, n, k):
    x, idx, val = _reduce_inputs(n, k)
    before = dg.gather_reduce.launches
    got = dg.gather_reduce(*map(torch.from_numpy, (x, idx, val)))
    assert dg.gather_reduce.launches == before
    np.testing.assert_allclose(got.numpy(), jax_out[1][(n, k)], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               np.einsum("nk,nkd->nd", val, x[idx]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("budget", [64 * 25 * 4 * 40, 1])
def test_gather_reduce_plain_chunks_rows(budget):
    """Row chunks of the budget (40 rows, and the 8-row floor) give the
    same rows as one gather."""
    x, idx, val = map(torch.from_numpy, _reduce_inputs(300, 25))
    whole = dg.gather_reduce_plain(x, idx, val)
    chunked = dg.gather_reduce_plain(x, idx, val, budget=budget)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_pad_slots_compute_their_row():
    """A pad slot (value 0) still multiplies its row, as the TPU kernel
    does: a non-finite row 0 reaches every row with a pad slot."""
    x, idx, val = map(torch.from_numpy, _reduce_inputs(64, 25))
    x[0, 3] = float("nan")
    out = dg.gather_reduce(x, idx, val)
    has_pad_or_0 = (idx == 0).any(dim=1)
    assert torch.isnan(out[has_pad_or_0, 3]).all()
    assert not torch.isnan(out[~has_pad_or_0]).any()


def test_gather_reduce_with_deg_equals_jax(jax_out):
    """On a table of build_ell (edges first, pads after them), the sum over
    each row's deg slots is JAX's sum over every slot."""
    x, h = _ell_inputs()
    assert h.deg.dtype == np.int32 and (h.deg < h.idx.shape[1]).any()
    got = dg.gather_reduce(*map(torch.from_numpy, (x, h.idx, h.val, h.deg)))
    np.testing.assert_allclose(got.numpy(), jax_out[2], rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[7] == 0.0)


def test_gather_reduce_writes_into_a_given_buffer(jax_out):
    """``out=`` (the partitioned SpMM's send buffer): the rows land in a
    slice of a larger buffer, equal to the rows returned without it and
    to JAX's; the rest of the buffer is untouched; a buffer of another
    shape or dtype raises."""
    x, h = _ell_inputs()
    args = [torch.from_numpy(a) for a in (x, h.idx, h.val, h.deg)]
    buf = torch.full((60, 64), 7.0)
    got = dg.gather_reduce(*args, out=buf[5:53])
    assert got.data_ptr() == buf[5:53].data_ptr()
    assert torch.equal(got, dg.gather_reduce(*args))
    np.testing.assert_allclose(got.numpy(), jax_out[2], rtol=RTOL, atol=ATOL)
    assert (buf[:5] == 7.0).all() and (buf[53:] == 7.0).all()
    for bad in (buf[:10], buf[5:53].double(), buf[5:53, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            dg.gather_reduce(*args, out=bad)


def test_deg_keeps_pad_slots_out_of_the_rows():
    """With deg the pad slots are not read: a NaN in row 0 of x reaches only
    the rows that have 0 as a real neighbour (without deg it reaches every
    row with a pad: test_pad_slots_compute_their_row)."""
    x, h = _ell_inputs()
    x[0, 3] = float("nan")
    idx, deg = torch.from_numpy(h.idx), torch.from_numpy(h.deg)
    out = dg.gather_reduce(torch.from_numpy(x), idx, torch.from_numpy(h.val),
                           deg)
    real = torch.arange(idx.shape[1])[None, :] < deg[:, None]
    has_0 = ((idx == 0) & real).any(dim=1)
    padded = ~real.all(dim=1)
    assert has_0.any() and (padded & ~has_0).any()
    assert torch.isnan(out[has_0, 3]).all()
    assert not torch.isnan(out[~has_0]).any()


def test_wrappers_refuse_what_they_do_not_take():
    x, idx, val = map(torch.from_numpy, _reduce_inputs(64, 25))
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        dg.gather_reduce(x, idx[0], val[0])
    with pytest.raises(ValueError, match="must match idx"):
        dg.gather_reduce(x, idx, val[:, :5])
    with pytest.raises(ValueError, match=r"\[R\]"):
        dg.gather_rows(x, idx)
    with pytest.raises(ValueError, match="one device"):
        dg.gather_rows(x, idx[0].to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        dg.gather_reduce(*(t.to("meta") for t in (x, idx, val)))
    deg = torch.full((64,), 25, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"deg \(63,\) must be \[N=64\]"):
        dg.gather_reduce(x, idx, val, deg[1:])
    with pytest.raises(TypeError, match="int32 deg"):
        dg.gather_reduce(x, idx, val, deg.long())
    with pytest.raises(ValueError, match="one device"):
        dg.gather_reduce(x, idx, val, deg.to("meta"))
    with pytest.raises(NotImplementedError, match="forward only"):
        dg.gather_reduce(x.requires_grad_(), idx, val)
    with torch.no_grad():
        assert dg.gather_reduce(x, idx, val).shape == (64, 64)
