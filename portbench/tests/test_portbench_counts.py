"""The operation and byte counts against a graph and calls counted by
hand."""

import numpy as np
import pytest
import torch

from portbench import graphs, harness, peaks
from portbench.counts import dgcf, lightgcn

# 2 users, 3 items, 1 tag: train pairs (0,0) (0,1) (1,1) (1,2); assignments
# (0,0,0) (0,1,0) (1,1,0): joint pairs u-i 4, u-t 2 (user 0 twice), i-t 2
RAW = graphs.RawGraph(2, 3, 1, np.array([[0, 0], [0, 1], [1, 1], [1, 2]]),
                      np.zeros((0, 2), dtype=np.int64),
                      np.array([[0, 0, 0], [0, 1, 0], [1, 1, 0]]))
CFG = {"dim_latent": 8, "dim_layer_list": [8, 8], "factor_k": 2,
       "iterate_k": 2}


def test_joint_edges_by_hand():
    # 4 u-i + 2 u-t + 2 i-t distinct pairs, both directions
    assert lightgcn.edges(RAW) == 16


def test_lightgcn_counts_by_hand():
    # 2 layers x (forward + backward) x 2 x 16 edges x 8, + 8 x B x 8
    assert lightgcn.step_flops(RAW, CFG, 4) == 4 * 2 * 16 * 8 + 8 * 4 * 8
    # 2 layers x 2 x 16 x 8, + 2 x 5 users x 3 items x 8
    assert lightgcn.eval_flops(RAW, CFG, 5) == 2 * 2 * 16 * 8 + 2 * 5 * 3 * 8


def test_dgcf_counts_by_hand():
    dk, e, f = 4, 16, 2
    layer = 2 * e * f * (5 + 4 * dk) + e * f * 2 * dk
    assert dgcf.step_flops(RAW, CFG, 4) == 2 * layer + 8 * 4 * 8


def test_gather_reduce_bound_by_hand():
    r = harness.load("metrics/ell_spmm_roofline.py")
    x = torch.zeros(10, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    val = torch.ones(3, 2)
    deg = torch.tensor([2, 1, 0], dtype=torch.int32)
    calls = [("gather_reduce", None, (x, idx, val, deg), {}),
             ("gather_reduce", None, (x, idx, val, deg), {"out": None})]
    # each call: 3 edges x 8 + 3 rows x 4 (deg) + 3 x 4 x 4 (out); x once
    n_bytes = 2 * (3 * 8 + 3 * 4 + 3 * 4 * 4) + 10 * 4 * 4
    assert r.bound_ms(calls) == pytest.approx(
        peaks.bound_ms(n_bytes, 2 * 2 * 3 * 4))
    assert r.read({"kernels": {"ell_spmm_roofline": {
        "calls": 2, "bound_ms": 1.0, "device_ms": 4.0}}}) == 25.0
    assert r.read({"kernels": {}}) is None


def test_routing_bound_by_hand():
    r = harness.load("metrics/routing_roofline.py")
    f, n, rank, dx = 2, 5, 3, 4
    q, k = torch.zeros(f, n, rank), torch.zeros(f, n, rank)
    mask = torch.zeros(n, n, dtype=torch.bool)
    mask[0, 1] = mask[1, 0] = mask[2, 3] = True
    x = torch.zeros(f, n, dx)
    calls = [("routed_rowsum", None, (q, k, mask), {}),
             ("routed_mm_rows", None, (q, k, mask, x), {}),
             ("routed_mm_bwd", None, (q, k, mask, x), {})]
    # q and k, then the 3 edges' column ids and n + 1 row offsets
    qk = 2 * f * n * rank * 4 + (3 + n + 1) * 4
    n_bytes = (qk + f * n * 4) + 2 * (qk + 2 * n * f * dx * 4)
    ops = 3 * f * (2 * rank + 4) + 2 * 3 * f * (2 * rank + 3 + 2 * dx)
    assert r.bound_ms(calls) == pytest.approx(peaks.bound_ms(n_bytes, ops))


def test_shares_of_the_peak():
    step = harness.load("metrics/step_mfu.py")
    assert step.read({"step_flops": 67e9, "window": {
        "steps": 10, "seconds": 1.0}}) == pytest.approx(1.0)
    assert step.read({}) is None
    idle = harness.load("metrics/idle_share.train.py")
    assert idle.read({"driver": "train", "profile": {
        "busy_s": 0.75, "span_s": 1.0}}) == pytest.approx(25.0)
    assert idle.read({"driver": "eval", "profile": {
        "busy_s": 0.75, "span_s": 1.0}}) is None
