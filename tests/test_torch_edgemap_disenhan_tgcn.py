"""The EdgeMap tier (``adj_mode="ell"``) of DisenHAN and TGCN against the
JAX package's EdgeMap tier on the CPU, and against the port's own tier
(DisenHAN's dense tier, TGCN's ``auto``) in float64
(``tests/torch_edgemap_parity.py`` has the tolerances).  A file of its
own: JAX's jit of these two models is most of the EdgeMap tests' time.
"""

import pytest

from torch_edgemap_parity import (check_equals_jax,
                                  check_equals_the_dense_tier, jax_runs)
from torch_threads import one_torch_thread  # noqa: F401

CASES = ["disenhan", "tgcn"]


@pytest.fixture(scope="module")
def jax_run(tiny_graph):
    return jax_runs(tiny_graph)


@pytest.mark.parametrize("case", CASES)
def test_edgemap_tier_equals_jax(jax_run, case):
    check_equals_jax(jax_run, case)


@pytest.mark.parametrize("case", CASES)
def test_edgemap_tier_equals_the_dense_tier(jax_run, case):
    check_equals_the_dense_tier(jax_run, case)
