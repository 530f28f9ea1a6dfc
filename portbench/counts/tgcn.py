"""Operations TGCN needs for one BPR step and its share of TransTag steps,
from shapes, and the bound of one step's Attention 1 calls.

Per layer of input width d, attention width da and weight width dw:

* Attention 1, over 2 (U + I + T) rows of k slots: a slot's score (2 da)
  and its share of the weighted sum (2 d); the products that factor
  through a node count once a row of their table, not once a slot: e_v W1
  (d rows of W1) for each relation's rows, e_j W2 for each node table and
  the neighbour type's attention (2 d da a row), e_w W1 for each
  attention's weight table (2 dw da a row);
* Attention 2, a node's 3 rows through U and p (3 (2 d da + 2 da));
* the convolutions: 32 filters of 3 taps at d places (192 d), 8 filters
  of j d taps at 3 - j + 1 places for j = 1, 2, 3 (160 d);
* the fusion, 2 (32 d + 48) d_out a node.

The backward of every product is twice its forward (both operands'
gradients).  BPR's scores at the final width as LightGCN's; a TransTag
step's two distances (4 d a row, three times with the backward), weighted
by the epoch's TransTag steps a BPR step.  Elementwise work (the softmax,
ReLU, the normalisation, Adam) is left out."""

from portbench.reference.tgcn import num_weight


def _layer_forward(n_nodes: int, n_weight: int, k: int, d: int, da: int,
                   dw: int, d_out: int, nb: int, nv: int) -> float:
    rows = 2 * n_nodes                 # each node type is centre of 2
    atten1 = (rows * k * (2 * da + 2 * d) + rows * 2 * d * da
              + n_nodes * 2 * d * da + 3 * (n_weight + 1) * 2 * dw * da)
    atten2 = n_nodes * 3 * (2 * d * da + 2 * da)
    conv = n_nodes * (nb * 3 * 2 * d
                      + sum(nv * (3 - j + 1) * 2 * j * d for j in (1, 2, 3)))
    fusion = n_nodes * 2 * (nb * d + nv * 6) * d_out
    return float(atten1 + atten2 + conv + fusion)


def step_flops(raw, cfg: dict, batch: int) -> float:
    """One BPR step and its share of TransTag steps."""
    d = cfg["dim_latent"]
    dims = [d] + list(cfg["dim_layer_list"])
    n_nodes = raw.n_user + raw.n_item + raw.n_tag
    fwd = sum(_layer_forward(n_nodes, num_weight(raw), cfg["neighbor_k"], di,
                             cfg["dim_atten"], cfg["dim_weight"], do,
                             cfg["num_bit_conv"], cfg["num_vec_conv"])
              for di, do in zip(dims[:-1], dims[1:]))
    bpr = 3.0 * fwd + 8.0 * batch * sum(dims)
    tt_batch = cfg["transtag_batch"]
    share = (len(raw.uit) // tt_batch) / (len(raw.train) // batch)
    return bpr + share * 3.0 * 4.0 * 2 * tt_batch * d


def atten1_work(calls):
    """(bytes, operations) that one step's recorded ``_atten1_dedup``
    calls (ap, ev, ej, ew, buckets, inv) need, forward and backward,
    whatever implements them: each distinct (neighbour, weight) pair's two
    ids and multiplicity once (12 bytes), each table (the centre rows, the
    neighbour and weight tables, W1, W2, b, v) read once and its gradient
    written once, the aggregate written once and its cotangent read once;
    operations 2 da + 2 d a distinct pair forward and twice that backward,
    plus the products that factor through a node once a row of their
    table (2 d da, or 2 dw da), forward and twice that backward."""
    n_bytes = ops = 0
    for _, _, a, _ in calls:
        ap, ev, ej, ew, buckets, _ = a[:6]
        n, d = ev.shape
        da, dw = ap["W2"].shape[1], ew.shape[1]
        pairs = sum(int((b[3] > 0).sum()) for b in buckets)
        tables = (ev.numel() + ej.numel() + ew.numel()
                  + sum(ap[key].numel() for key in ("W1", "W2", "b", "v")))
        n_bytes += 12 * pairs + 4 * 2 * tables + 4 * 2 * n * d
        node = 2 * d * da * (n + ej.shape[0]) + 2 * dw * da * ew.shape[0]
        ops += 3 * (pairs * (2 * da + 2 * d) + node)
    return n_bytes, ops
