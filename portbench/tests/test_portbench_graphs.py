"""The benchmark's vectorised generator against the port's loop version."""

import numpy as np
import pytest

from portbench import graphs
from tagrec_tpu_torch.data.synthetic import synthetic_graph_large


@pytest.mark.parametrize("sizes", [(60, 300, 40, 2000, 0.3, 0),
                                   (200, 900, 70, 5000, 0.5, 3),
                                   # users short of two pairs get extras
                                   (400, 50, 10, 300, 0.3, 1)])
def test_same_graph_as_synthetic_graph_large(sizes):
    *dims, tpi, seed = sizes
    want = synthetic_graph_large(*dims, tag_per_inter=tpi, seed=seed)
    got = graphs.to_hetero(graphs.make(*dims, tag_per_inter=tpi, seed=seed))
    assert got.num == want.num
    assert got.user_items == want.user_items
    for split in ("train", "test"):
        np.testing.assert_array_equal(got.edge_index[split],
                                      want.edge_index[split])
    np.testing.assert_array_equal(got.uit_data, want.uit_data)
    for name in ("ui_adj", "ut_adj", "it_adj"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
