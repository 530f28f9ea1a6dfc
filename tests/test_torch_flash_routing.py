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
