"""One training step's ``gather_reduce`` launches (``csrc/gather_reduce.cu``,
the ELL part of the hybrid SpMM) against their roofline: the bound of
max(bytes / 3.35 TB/s, operations / 67 TFLOP/s) over their device time.
The calls are recorded at their arguments in one eager step and replayed
in a CUDA graph, timed by CUDA events.  Bytes: each real edge's id and
value (8), each row's degree (4) and output row (4 a column), and each
distinct input table once; operations: 2 an edge and column."""

from portbench.peaks import bound_ms as _bound

RECORD = (("tagrec_tpu_torch.ops.propagate", "gather_reduce"),)


def bound_ms(calls) -> float:
    n_bytes = ops = 0
    seen = set()
    for _, _, a, k in calls:
        x, idx, val = a[:3]
        deg = a[3] if len(a) > 3 else k.get("deg")
        rows, d = idx.shape[0], x.shape[1]
        if deg is not None:
            edges = int(deg.sum())
            n_bytes += rows * 4
        else:
            edges = int((val != 0).sum())
        n_bytes += edges * 8 + rows * d * 4
        key = (x.data_ptr(), tuple(x.shape))
        if key not in seen:
            seen.add(key)
            n_bytes += x.numel() * 4
        ops += 2 * edges * d
    return _bound(n_bytes, ops)


def read(trace):
    k = trace.get("kernels", {}).get("ell_spmm_roofline")
    if not k or not k["calls"] or not k["device_ms"]:
        return None
    return 100.0 * k["bound_ms"] / k["device_ms"]
