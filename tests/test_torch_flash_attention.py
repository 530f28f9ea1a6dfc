"""The port's two-segment flash attention (tagrec_tpu_torch.ops.flash_attention)
against the JAX Pallas kernels, which run here in interpret mode as in
test_flash_attention.py.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those on the card (test_torch_cuda_kernels.py and
chip_smoke.py).  Tolerances: forward rtol 1e-4, atol 1e-5 (float32 on both
sides, sums in another order); gradients rtol 5e-4, atol 1e-5 (longer sums,
and dS = P (g x^T - delta) cancels).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tagrec_tpu.ops import flash_attention as jfa
from tagrec_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
NS, ND, SPLIT_J, DQ, DX = 256, 512, 1, 64, 16
SPLIT = SPLIT_J * jfa.TILE_J
EMPTY_ROWS = (5, 130)


def _inputs():
    rng = np.random.default_rng(31)
    q2 = np.tanh(rng.standard_normal((2, NS, DQ))).astype(np.float32)
    k = (0.3 * rng.standard_normal((ND, DQ))).astype(np.float32)
    x = rng.standard_normal((ND, DX)).astype(np.float32)
    g = rng.standard_normal((NS, DX)).astype(np.float32)
    mask = (rng.random((NS, ND)) < 0.05).astype(np.int8)
    mask[list(EMPTY_ROWS), :] = 0
    mask[7, :SPLIT] = 0  # edges right of the split only
    return q2, k, mask, x, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_run():
    """JAX stats, apply and the gradients of sum(apply * g) in q2, k, x."""
    q2, k, mask, x, g = (jnp.asarray(a) for a in _inputs())
    ms, zs = jfa.dot_flash_stats(q2, k, mask, SPLIT_J)
    out, vjp = jax.vjp(lambda q2_, k_, x_: jfa.dot_flash_apply(
        q2_, k_, mask, ms, zs, x_, SPLIT_J), q2, k, x)
    grads = vjp(g)
    return ([np.asarray(ms).reshape(-1), np.asarray(zs).reshape(-1)],
            np.asarray(out), [np.asarray(t) for t in grads])


def test_stats_match_jax(jax_run):
    (want_m, want_z), _, _ = jax_run
    q2, k, mask, _, _ = _t(*_inputs())
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(z.numpy(), want_z, rtol=RTOL, atol=ATOL)
    assert np.all(m.numpy()[list(EMPTY_ROWS)] == tfa.NEG)
    assert np.all(z.numpy()[list(EMPTY_ROWS)] == 0.0)


def test_stats_keep_a_nan_off_the_edges_out_as_jax_does():
    """A NaN in k at columns that are no row's edge, one each side of the
    split: JAX's stats kernel masks the scores before any sum, and so does
    the port's, so both are finite and agree (m exactly).  The kernel on the
    card reads no such column, so stats as an edge sweep diverges from JAX
    nowhere."""
    q2, k, mask, _, _ = _inputs()
    for col, c in ((100, 0), (300, 1)):
        mask[:, col] = 0
        k[col, c] = np.nan
    jm, jz = jfa.dot_flash_stats(jnp.asarray(q2), jnp.asarray(k),
                                 jnp.asarray(mask), SPLIT_J)
    jm, jz = np.asarray(jm).reshape(-1), np.asarray(jz).reshape(-1)
    m, z = tfa.dot_flash_stats(*_t(q2, k, mask), SPLIT)
    for t in (jm, jz, m.numpy(), z.numpy()):
        assert np.isfinite(t).all()
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_allclose(z.numpy(), jz, rtol=RTOL, atol=ATOL)
    assert np.all(m.numpy()[list(EMPTY_ROWS)] == tfa.NEG)
    assert np.all(z.numpy()[list(EMPTY_ROWS)] == 0.0)


def test_apply_matches_jax(jax_run):
    _, want, _ = jax_run
    q2, k, mask, x, _ = _t(*_inputs())
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    out = tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT)
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[list(EMPTY_ROWS)] == 0.0)


def test_gradients_match_jax(jax_run):
    _, _, (want_q2, want_k, want_x) = jax_run
    q2, k, mask, x, g = _t(*_inputs())
    for t in (q2, k, x):
        t.requires_grad_()
    m, z = tfa.dot_flash_stats(q2.detach(), k.detach(), mask, SPLIT)
    tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT).backward(g)
    for got, want in ((q2.grad, want_q2), (k.grad, want_k), (x.grad, want_x)):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert np.all(q2.grad.numpy()[:, list(EMPTY_ROWS)] == 0.0)


def test_backward_sweeps_match_jax(jax_run):
    """The two backward sweeps on their own, against JAX's, on the same
    delta."""
    (jm, jz), jout, _ = jax_run
    q2, k, mask, x, g = (jnp.asarray(a) for a in _inputs())
    ms, zs = jm.reshape(-1, jfa.TILE_I), jz.reshape(-1, jfa.TILE_I)
    dl = jnp.sum(g * jout, axis=1).reshape(-1, jfa.TILE_I)
    want_dq2 = jfa._dot_bwd_row(q2, k, mask, ms, zs, x, g, dl, SPLIT_J)
    want_dk, want_dx = jfa._dot_bwd_col(q2, k, mask, ms, zs, x, g, dl, SPLIT_J)
    q2t, kt, maskt, xt, gt, mt, zt, dlt = _t(*_inputs(), jm, jz,
                                             np.asarray(dl).reshape(-1))
    dq2 = tfa.dot_bwd_row(q2t, kt, maskt, mt, zt, xt, gt, dlt, SPLIT)
    dk, dx = tfa.dot_bwd_col(q2t, kt, maskt.T.contiguous(), mt, zt, xt, gt,
                             dlt, SPLIT)
    for got, want in ((dq2, want_dq2), (dk, want_dk), (dx, want_dx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("split", [0, ND, 100, 333])
def test_bwd_row_plain_is_the_gradient_in_q2(split):
    """dot_bwd_row_plain, which the card holds its kernel against, equals
    autograd's gradient in q2 of the plain stats and apply (the stats
    differentiated too, so that it is the softmax's gradient), in float64,
    at splits on the 64-column tile and off it (JAX's tile-aligned split_j
    cannot express those)."""
    q2, k, mask, x, g = _t(*_inputs())
    q2, k, x, g = (t.double() for t in (q2, k, x, g))
    q2.requires_grad_()
    m, z = tfa.dot_flash_stats_plain(q2, k, mask, split)
    out = tfa.dot_flash_apply_plain(q2, k, mask, m, z, x, split)
    out.backward(g)
    delta = torch.sum(g * out.detach(), dim=1)
    dq2 = tfa.dot_bwd_row_plain(q2.detach(), k, mask, m.detach(), z.detach(),
                                x, g, delta, split)
    torch.testing.assert_close(dq2, q2.grad, rtol=1e-9, atol=1e-12)
    assert torch.all(dq2[:, list(EMPTY_ROWS)] == 0)


def test_cpu_calls_launch_no_kernel():
    q2, k, mask, x, g = _t(*_inputs())
    x.requires_grad_()
    counters = (tfa.dot_flash_stats, tfa.dot_flash_apply, tfa.dot_bwd_row,
                tfa.dot_bwd_col)
    before = [f.launches for f in counters]
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT).backward(g)
    assert [f.launches for f in counters] == before


def test_mask_t_on_the_cpu_changes_nothing():
    """The apply's backward takes the column sweep's mask_t where it is
    given, and the mask itself on the CPU where it is not: the same output
    and gradients, bit for bit."""
    q2, k, mask, x, g = _t(*_inputs())
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    runs = []
    for mask_t in (None, mask.T.contiguous()):
        leaves = [t.clone().requires_grad_() for t in (q2, k, x)]
        out = tfa.dot_flash_apply(leaves[0], leaves[1], mask, m, z, leaves[2],
                                  SPLIT, mask_t)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mask_t_is_checked():
    q2, k, mask, x, g = _t(*_inputs())
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    delta = torch.sum(g * tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT), 1)
    mask_t = mask.T.contiguous()
    with pytest.raises(ValueError, match=r"mask_t \(256, 512\) must be "
                                          r"\[512, 256\]"):
        tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT, mask)
    with pytest.raises(ValueError, match="mask_t"):
        tfa.dot_bwd_col(q2, k, mask, m, z, x, g, delta, SPLIT)
    with pytest.raises(TypeError, match="mask_t dtype"):
        tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT, mask_t.bool())
    with pytest.raises(TypeError, match="mask_t dtype"):
        tfa.dot_bwd_col(q2, k, mask_t.float(), m, z, x, g, delta, SPLIT)
    with pytest.raises(ValueError, match="one device"):
        tfa.dot_flash_apply(q2, k, mask, m, z, x, SPLIT, mask_t.to("meta"))


def test_checks_shapes_and_split():
    q2, k, mask, x, _ = _t(*_inputs())
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.dot_flash_stats(q2, k[:-1], mask, SPLIT)
    with pytest.raises(ValueError, match="outside"):
        tfa.dot_flash_stats(q2, k, mask, ND + 1)
    with pytest.raises(TypeError, match="mask dtype"):
        tfa.dot_flash_stats(q2, k, mask.float(), SPLIT)
    m, z = tfa.dot_flash_stats(q2, k, mask, SPLIT)
    with pytest.raises(ValueError, match="must be"):
        tfa.dot_flash_apply(q2, k, mask, m, z, x[:-1], SPLIT)
