"""A module-scoped autouse fixture for the port's CPU test files: one
intra-op thread for torch while the module runs, its count restored after.

Run under pytest-xdist with six workers on eight cores, torch's thread
pool (one thread a core in each worker) spins against the other
workers: TGCN's one-epoch CLI run took 169 s with eight threads and 14 s
with one on a loaded 8-core machine, 8 s and 3 s unloaded.  Import the
fixture into a test module to use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
