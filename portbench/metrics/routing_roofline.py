"""One training step's routing-kernel launches (``routed_rowsum``,
``routed_mm`` forward and ``routed_mm_bwd``; ``csrc/routed_{rowsum,mm}.cu``)
against their roofline: the bound of max(bytes / 3.35 TB/s, operations /
67 TFLOP/s) over their device time, the calls recorded at their arguments
in one eager step and replayed in a CUDA graph, timed by CUDA events.

The bound is of the work the function needs, not of the layout the
kernels read: a launch reads q and k once, the mask's edges once as a
compressed row list (a 4-byte column id an edge, a 4-byte offset a row;
the kernels sweep the dense [R, N] mask instead, 225 MB a launch at
hetrec, which this share counts as their cost), and writes its output
once (routed_mm also reads x).  Its operations are the edges' only: per
edge and factor the score (2 r), the softmax and row sum (4), or for
routed_mm the score, softmax (3) and product (2 dx)."""

from portbench.peaks import bound_ms as _bound

_F = "tagrec_tpu_torch.ops.flash_routing"
RECORD = ((_F, "routed_rowsum"), (_F, "routed_mm_rows"), (_F, "routed_mm_bwd"))


def _launch(name, q, k, mask, x, nnz):
    """(bytes, operations) of one launch over ``mask``'s rows."""
    f, r = q.shape[0], q.shape[2]
    n_bytes = (q.numel() + k.numel()) * 4 + (nnz + mask.shape[0] + 1) * 4
    if x is None:
        return n_bytes + f * mask.shape[0] * 4, nnz * f * (2 * r + 4)
    dx = x.shape[2]
    n_bytes += (k.shape[1] + mask.shape[0]) * f * dx * 4
    return n_bytes, nnz * f * (2 * r + 3 + 2 * dx)


def bound_ms(calls) -> float:
    nnz = {}
    n_bytes = ops = 0
    for name, _, a, _ in calls:
        if name == "routed_mm_bwd":  # the forward's launch over mask^T
            q, k, mask, x = a[1], a[0], a[2], a[3]
        else:
            q, k, mask = a[:3]
            x = a[3] if name == "routed_mm_rows" else None
        key = (mask.data_ptr(), tuple(mask.shape))
        if key not in nnz:
            nnz[key] = int(mask.count_nonzero())
        b, o = _launch(name, q, k, mask, x, nnz[key])
        n_bytes += b
        ops += o
    return _bound(n_bytes, ops)


def read(trace):
    k = trace.get("kernels", {}).get("routing_roofline")
    if not k or not k["calls"] or not k["device_ms"]:
        return None
    return 100.0 * k["bound_ms"] / k["device_ms"]
