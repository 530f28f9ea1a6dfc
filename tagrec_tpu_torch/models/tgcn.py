"""TGCN: tag-aware GCN with dual attention and convolutional fusion
(tagrec_tpu/models/tgcn.py; reference model/tgcn.py:11-268).

* Fixed-width (k = 25) neighbour tables for the six relations
  [ui, ut, iu, it, tu, ti], ids shifted +1 with row 0 the zero pad, each
  slot with its interaction-multiplicity ("weight") id, whose embedding
  enters the attention score.
* Per layer: Attention1 per neighbour type, a softmax over the k slots of
  ReLU([e_v | e_w] W1 + e_j W2 + b) . v; Attention2 fusing the three
  per-type aggregates with a softmax gate; the bit-level (3, 1) x 32 and
  vector-level (j, d) x 8 convolutions over the stacked [3, d] matrix, as
  einsums; a linear fusion.  The output is the concat of [ego, normalized
  layer outputs] (64 + 64 + 32 + 16 = 176 at the preset).
* Quirk #6: the reference samples the tables once and never again, so by
  default they are static, drawn on the host at build time.
  ``resample_each_layer=True`` keeps the full CSR lists on the device and
  draws k fresh slots per node for every layer of a training forward.
* Phase 1 BPR (logsigmoid) with L2 on the final rows; phase 2 the TransTag
  margin loss on the ego tables (model/tgcn.py:251-261).

Tiers, as JAX selects them: ``adj_mode="auto"`` gathers each row's
distinct (neighbour, weight) pairs once, in degree buckets, and folds the
duplicate count into the softmax (the same sum, grouped);
``"dense_xla"`` (and ``"dense"``, and per-layer resampling) the plain
25-wide takes; ``adj_dtype="bf16"`` gathers bf16 tables.  ``"ell"`` holds
each [N, k] table as two EdgeMaps (``ops.edgemap``) over the shifted
neighbour and weight-id spaces, its pads real edges to row 0: the
neighbour and weight rows come from ``edge_vgather``, the centre rows from
``rows_gather``, whose backwards are gathers over the transpose tables,
not scatter-adds into the node tables; the softmax runs over all k slots,
and the tables stay float32, as in JAX.  There every weight multiplies a
whole node table before the slot reads, and the score weight ``v`` goes
through ``edge_score``, so under a mesh, where each map holds one
``model`` rank's rows (``ops.edgemap.shard_edge_map``), no weight's
gradient sums over one rank's slots alone; the scores and weighted sums
run over fixed row blocks, so a rank's rows get one device's bits; the
rows come back whole on every rank (``rows_ordered``).  Per-layer
resampling draws new tables every step and keeps the plain takes.

Under a mesh each rank holds, of every table leaf JAX's ``gdev_sharding``
row-shards (the [N, k] tables, each dedup bucket's rows, ids, wids and
mult), its block of rows; each relation's ``inv`` and the CSR lists stay
whole (``place_tables``).  With more than one ``model`` rank the
``auto`` and ``dense_xla`` attention runs on the rank's rows of each cut
bucket or table and whole on each whole bucket, and one all-gather over
``model`` makes the aggregate whole on every rank (``_atten1_split``):
what follows it is one device's code.  Backward, each rank takes its own
rows' cotangent and a whole bucket's on ``model`` rank 0 only, so the
gradients of the attention's inputs (the centre rows, both tables, W1,
W2, b, v) are that rank's part; one sum over ``model`` a relation
(``ops.propagate.model_sum``) makes them whole on every rank before the
parameters' gather takes its slice.  With no mesh or one ``model`` rank
the code runs as on one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tagrec_tpu_torch import runtime
from tagrec_tpu_torch.config import ModelConfig
from tagrec_tpu_torch.data.graph import COO, HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import base
from tagrec_tpu_torch.ops import edgemap
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops import losses
from tagrec_tpu_torch.ops.propagate import (RankRows, l2_normalize,
                                            message_dropout, model_sum)
from tagrec_tpu_torch.utils import profiling

DEDUP_WIDTHS = (4, 8, 12, 16, 20, 25)
# neighbour-table order (data/tgcn_load.py:29): ui, ut, iu, it, tu, ti
REL_ORDER = ("u_iw", "u_tw", "i_uw", "i_tw", "t_uw", "t_iw")


def neighbor_sample_csr(indptr: np.ndarray, cols: np.ndarray,
                        vals: np.ndarray, k: int,
                        seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """k slots per row drawn with replacement from its CSR list -> ([n, k]
    neighbour ids + 1, [n, k] weight ids), 0 for a row without neighbours,
    as tagrec_tpu/runtime ``neighbor_sample_csr`` draws them: the native
    sampler (``runtime.neighbor_sample``, ``std::mt19937_64``) whenever
    its library loads, the numpy loop only when it does not."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    native = runtime.neighbor_sample(indptr, cols, vals, k, seed)
    if native is not None:
        return native
    n_rows = len(indptr) - 1
    idx = np.zeros((n_rows, k), dtype=np.int32)
    w = np.zeros((n_rows, k), dtype=np.int32)
    rng = np.random.default_rng(seed)
    for r in range(n_rows):
        lo, hi = indptr[r], indptr[r + 1]
        if hi == lo:
            continue
        sel = rng.integers(lo, hi, size=k)
        idx[r] = cols[sel] + 1
        w[r] = vals[sel].astype(np.int32)
    return idx, w


def _csr(coo: COO):
    """(starts [n + 1], cols, vals) of ``coo``'s rows, stably sorted."""
    n = coo.shape[0]
    order = np.argsort(coo.row, kind="stable")
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(coo.row, minlength=n), out=starts[1:])
    return starts, coo.col[order], coo.val[order]


def _sample_neighbor_table(coo: COO, k: int, rng: np.random.Generator):
    """k neighbours (with replacement) and their weight ids per row, ids +1
    and 0 the pad; the seed is drawn from ``rng`` as JAX draws it."""
    starts, cols, vals = _csr(coo)
    return neighbor_sample_csr(starts, cols, vals, k,
                               int(rng.integers(0, 2**63 - 1)))


def _build_dedup_buckets(idx: np.ndarray, w: np.ndarray,
                         widths: Sequence[int] = DEDUP_WIDTHS):
    """A sampled [N, k] table as degree-bucketed DISTINCT (neighbour,
    weight) pairs with their multiplicities.

    A softmax over k slots with duplicates equals the multiplicity-weighted
    softmax over the distinct pairs.  Returns (buckets, inv): buckets a
    list of (rows [Nb], ids [Nb, W], wids [Nb, W], mult [Nb, W] float32),
    pad slots with mult 0; inv[n] the position of node n in the
    concatenated bucket rows."""
    n, k = idx.shape
    if widths[-1] < k:
        # past the default ladder: rungs every 8, capped by k
        widths = tuple(widths) + tuple(range(widths[-1] + 7, k, 8)) + (k,)
    # a per-row unique: encode the pairs, sort each row, run-length encode
    # (new[:, 0] is True, so each row's last run ends at the next row)
    m = int(w.max()) + 1
    enc = idx.astype(np.int64) * m + w.astype(np.int64)
    s = np.sort(enc, axis=1)
    new = np.ones_like(s, dtype=bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    dcount = new.sum(1)
    flat = np.flatnonzero(new.ravel())
    counts = np.diff(np.append(flat, n * k))
    vals = s.ravel()[flat]
    row_of = np.repeat(np.arange(n), dcount)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(dcount, out=starts[1:])
    col_of = np.arange(len(flat)) - starts[row_of]
    ids_m = np.zeros((n, k), dtype=np.int32)
    wid_m = np.zeros((n, k), dtype=np.int32)
    mul_m = np.zeros((n, k), dtype=np.float32)
    ids_m[row_of, col_of] = vals // m
    wid_m[row_of, col_of] = vals % m
    mul_m[row_of, col_of] = counts

    order, buckets = [], []
    for wi, width in enumerate(widths):
        lo = 0 if wi == 0 else widths[wi - 1]
        rows = np.nonzero((dcount > lo) & (dcount <= width))[0]
        if len(rows) == 0:
            continue
        buckets.append((rows.astype(np.int32), ids_m[rows, :width],
                        wid_m[rows, :width], mul_m[rows, :width]))
        order.append(rows)
    inv = np.empty(n, dtype=np.int32)
    inv[np.concatenate(order)] = np.arange(n, dtype=np.int32)
    return buckets, inv


def _atten1(ap, ev, ej, ew, v_j, v_w):
    """Neighbour attention over the plain k-wide takes (model/tgcn.py:11-37).
    ``ej``, ``ew``: the neighbour-type and weight tables with the zero row
    first, in the tables' dtype (bf16 under ``adj_dtype="bf16"``); the
    softmax runs over all k slots, pads included, in float32 (or wider)."""
    dt = ej.dtype
    e_nj = ej[v_j]                                       # [N, k, d]
    e_nw = ew[v_w]                                       # [N, k, dw]
    ev = ev.to(dt)
    e_nv = ev[:, None, :].expand(-1, v_j.shape[1], -1)
    cat = torch.cat([e_nv, e_nw], dim=-1)
    av = cat @ ap["W1"].to(dt) + e_nj @ ap["W2"].to(dt) + ap["b"].to(dt)
    x = torch.relu(av) @ ap["v"].T.to(dt)                # [N, k, 1]
    a = torch.softmax(x.to(_wide(dt)), dim=1)
    return torch.sum(a.to(dt) * e_nj, dim=1).to(_wide(dt))


def _dedup_weights(ap, d: int, dt):
    """(W1's centre rows, W1's weight rows, W2, b, v^T) in ``dt``."""
    return (ap["W1"][:d].to(dt), ap["W1"][d:].to(dt), ap["W2"].to(dt),
            ap["b"].to(dt), ap["v"].T.to(dt))


def _dedup_bucket(w, ev_rows, ej, ew, ids, wids, mult):
    """One dedup bucket's attention: each pair's exp weighted by its
    multiplicity, -inf on the pad slots -> [Nb, d] in ``ej``'s dtype."""
    w1v, w1w, w2, b, v_t = w
    e_nj = ej[ids]                                       # [Nb, W, d]
    av = (ev_rows @ w1v)[:, None, :] + ew[wids] @ w1w + e_nj @ w2 + b
    x = (torch.relu(av) @ v_t)[..., 0].to(mult.dtype)   # [Nb, W]
    xm = torch.where(mult > 0, x, -torch.inf)
    e = mult * torch.exp(xm - torch.amax(xm, dim=-1, keepdim=True))
    a = e / torch.sum(e, dim=-1, keepdim=True)
    return torch.einsum("nw,nwd->nd", a.to(ej.dtype), e_nj)


def _atten1_dedup(ap, ev, ej, ew, buckets, inv):
    """Attention1 over the degree buckets of distinct pairs
    (``_dedup_bucket``), the rows taken back to node order by ``inv``."""
    dt = ej.dtype
    w = _dedup_weights(ap, ev.shape[1], dt)
    ev = ev.to(dt)
    outs = [_dedup_bucket(w, ev[rows], ej, ew, ids, wids, mult)
            for rows, ids, wids, mult in buckets]
    return torch.cat(outs)[inv].to(_wide(dt))


def _atten1_split(ap, ev, ej, ew, pieces, blocks, inv, mesh):
    """Attention1 on a ``model`` rank's rows: ``_atten1`` (``inv`` None:
    one piece, the (v_j, v_w) table) or ``_atten1_dedup`` (``pieces`` the
    buckets) over the rows the rank holds of each piece that row-shards
    (``blocks``), a whole piece whole; one all-gather makes the result
    whole on every rank (``propagate.RankRows``).  Each rank's gradients
    of the inputs (the centre rows, both tables, W1, W2, b, v) are its
    rows' part, so the inputs pass through ``model_sum``: one all-reduce over
    ``model`` a relation makes them whole before anything reads them."""
    ev, ej, ew, *ws = model_sum(mesh, ev, ej, ew,
                                *(ap[k] for k in ("W1", "W2", "b", "v")))
    ap = dict(zip(("W1", "W2", "b", "v"), ws))
    dt = ej.dtype
    if inv is None:
        (v_j, v_w), = pieces
        outs = [_atten1(ap, ell_lib.cut_rows(ev, blocks[0]), ej, ew, v_j,
                        v_w)]
        rows = [None]
    else:
        w = _dedup_weights(ap, ev.shape[1], dt)
        evd = ev.to(dt)
        outs = [_dedup_bucket(w, evd[r], ej, ew, ids, wids, mult).to(
                    _wide(dt)) for r, ids, wids, mult in pieces]
        rows = [p[0] for p in pieces]
    return RankRows.apply((mesh, blocks, inv, rows, 0), *outs)


def _atten1_em(ap, ev, ej0, ew0, em_j, em_w):
    """Attention1 over a relation's EdgeMaps (``em_j`` over the neighbour
    rows, ``em_w`` over the weight ids, one slot layout): every table read
    is an ``ops.edgemap`` primitive, so the backward takes gathers over the
    transpose tables.  JAX's per-slot products (e_v W1v + e_w W1w + e_j W2
    + b) are taken of the whole tables, then read per slot, and the score
    weight is ``edge_score``'s: on a rank's rows no weight's gradient is
    that rank's part alone.  The scores and the weighted sum are
    products over fixed row blocks (``edge_score``, ``slot_sums``), which
    give a row the same bits however many rows the rank holds.  The
    softmax spans the table's k slots, node-0 pad edges included (deg ==
    k); only ELL width padding is masked."""
    d = ev.shape[1]
    w1v, w1w = ap["W1"][:d], ap["W1"][d:]
    # e_j and e_j W2 in one read ([Nb, K, d + A]), split as views: two
    # reads cost more than the split
    both = edgemap.edge_vgather(em_j, torch.cat([ej0, ej0 @ ap["W2"]], 1))
    nj, pj = zip(*(t.split([d, t.shape[-1] - d], dim=-1) for t in both))
    nw = edgemap.edge_vgather(em_w, ew0 @ w1w)           # ([Nb, K, A], ...)
    cv = edgemap.rows_gather(em_j, ev @ w1v + ap["b"])   # ([Nb, A], ...)
    hid = tuple(torch.relu(w + p + c[:, None, :])
                for c, w, p in zip(cv, nw, pj))
    att = tuple(torch.softmax(torch.where(m, x, torch.finfo(x.dtype).min),
                              dim=-1) * m
                for x, m in zip(edgemap.edge_score(em_j, hid, ap["v"]),
                                em_j.masks(torch.bool)))
    return edgemap.rows_ordered(em_j, edgemap.slot_sums(att, nj))


def _wide(dt):
    """float32, or the wider float the model runs in."""
    return torch.promote_types(dt, torch.float32)


def _atten2(lp, u, i, t):
    uit = torch.stack([u, i, t], dim=1)                  # [N, 3, d]
    x = torch.relu(uit @ lp.U + lp.q) @ lp.p.T  # [N, 3, 1]
    return torch.softmax(x, dim=1) * uit


def _conv(lp, e_n):
    """Bit-level and vector-level convolutions as einsums
    (model/tgcn.py:66-101): [N, 32 d] channel-major, then per j the 8
    channels' 3 - j + 1 positions."""
    n = e_n.shape[0]
    bit = torch.relu(torch.einsum("ncd,oc->nod", e_n, lp.bit)).reshape(n, -1)
    vecs = []
    for j, w in zip((1, 2, 3), lp.vec):               # w: [8, j, d]
        outs = [torch.einsum("ncd,ocd->no", e_n[:, p:p + j, :], w)
                for p in range(3 - j + 1)]
        vecs.append(torch.relu(torch.stack(outs, dim=2)).reshape(n, -1))
    return torch.cat([bit] + vecs, dim=1)


def _fusion(lp, x):
    return torch.relu(x @ lp.Wf + lp.bf)


class TGCN(base.EdgeMapGraph, nn.Module):
    """Parameters ``embed.0..2`` (user, item, tag), ``weight`` and per layer
    ``layers.L.atten1.{user,item,tag}.{W1,W2,b,v}``, ``layers.L.{U,q,p,bit,
    Wf,bf}`` and ``layers.L.vec.0..2``: JAX's tree as dotted names, drawn
    from ``generator`` (a CPU ``torch.Generator``).  The six neighbour
    tables are sampled on the host from ``sample_seed`` as JAX samples
    them (``neighbor_sample_csr``; ``sampler`` names the sampler that drew
    them), or taken from ``tables``, six (idx, w) arrays in ``REL_ORDER``,
    and live on
    ``device`` as int64 buffers: the tables, or under ``auto`` their dedup
    buckets, or under ``resample_each_layer`` the CSR lists too; under
    ``ell`` ``em_hosts`` keeps each relation's EdgeMapHosts
    ``em.<name>.0`` (neighbours) and ``em.<name>.1`` (weight ids), JAX's
    leaf prefixes, and ``edges`` holds them on ``device``, or with
    ``mesh`` the rank's rows of them; with ``mesh`` the tables too hold
    the rank's rows (``place_tables``; both by ``place_graph``,
    ``parallel.sharding.shard_graph``).  The draw and the tier's build of
    the tables are the span ``tgcn.tables`` (attrs ``sampler``, ``tier``)
    of ``utils.profiling``, with its counters (``_build_tables``)."""

    REL_ORDER = REL_ORDER

    def __init__(self, graph: HeteroGraph, cfg: ModelConfig, *,
                 generator: torch.Generator, device="cuda",
                 resample_each_layer: bool = False, sample_seed: int = 0,
                 tables: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
                 mesh=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.num_list = [graph.n_user, graph.n_item, graph.n_tag]
        self.num_weight = graph.num["weight"]
        self.dims = [cfg.dim_latent] + list(cfg.dim_layer_list)
        self.resample_each_layer = resample_each_layer

        def xavier(*shape):
            return base.xavier_uniform(shape, generator, dev)

        self.embed = nn.ParameterList(
            [nn.Parameter(xavier(n, cfg.dim_latent)) for n in self.num_list])
        self.weight = nn.Parameter(xavier(self.num_weight, cfg.dim_weight))
        layers = []
        for li in range(cfg.num_layer):
            d_in, d_out = self.dims[li], self.dims[li + 1]
            lp = nn.Module()
            lp.atten1 = nn.ModuleDict({t: nn.ParameterDict({
                "W1": xavier(d_in + cfg.dim_weight, cfg.dim_atten),
                "W2": xavier(d_in, cfg.dim_atten),
                "b": xavier(1, cfg.dim_atten),
                "v": xavier(1, cfg.dim_atten)})
                for t in ("user", "item", "tag")})
            lp.U = nn.Parameter(xavier(d_in, cfg.dim_atten))
            lp.q = nn.Parameter(xavier(1, cfg.dim_atten))
            lp.p = nn.Parameter(xavier(1, cfg.dim_atten))
            # torch Conv2d shapes for the xavier fans, then squeezed
            lp.bit = nn.Parameter(xavier(cfg.num_bit_conv, 1, 3, 1)[:, 0, :, 0].contiguous())
            lp.vec = nn.ParameterList(
                [nn.Parameter(xavier(cfg.num_vec_conv, 1, j, d_in)[:, 0].contiguous())
                 for j in (1, 2, 3)])
            in_k = cfg.num_bit_conv * d_in + cfg.num_vec_conv * (3 + 2 + 1)
            lp.Wf = nn.Parameter(xavier(in_k, d_out))
            lp.bf = nn.Parameter(xavier(1, d_out))
            layers.append(lp)
        self.layers = nn.ModuleList(layers)

        adjs = [graph.ui_adj, graph.ut_adj, graph.ui_adj.transpose(),
                graph.it_adj, graph.ut_adj.transpose(),
                graph.it_adj.transpose()]
        self.dedup = cfg.adj_mode == "auto" and not resample_each_layer
        self.ell = cfg.adj_mode == "ell" and not resample_each_layer
        # which sampler drew the tables: "native", "numpy", or "given"
        self.sampler = "given" if tables is not None else runtime.sampler()
        with profiling.span("tgcn.tables", sampler=self.sampler,
                            tier=self.tier):
            self._build_tables(cfg, adjs, tables, sample_seed,
                               resample_each_layer, mesh, dev)
        # rows each relation fed to its attention in the last forward,
        # over its layers (a rank's rows under a mesh)
        self.attention_rows = {}

    def _build_tables(self, cfg, adjs, tables, sample_seed,
                      resample_each_layer, mesh, dev) -> None:
        """The six neighbour tables drawn (unless given), the tier's forms
        of them built and placed on ``dev``; the counters ``tgcn.slots``
        (N x k over the relations), and on ``auto`` ``tgcn.pairs`` (the
        distinct (neighbour, weight) pairs) and ``tgcn.buckets``."""
        if tables is None:
            rng = np.random.default_rng(sample_seed)
            tables = [_sample_neighbor_table(a, cfg.neighbor_k, rng)
                      for a in adjs]
        self.tables_host = tables
        profiling.count("tgcn.slots", sum(idx.size for idx, _ in tables))
        # (JAX's leaf path, buffer name, whole host array) of every table,
        # in JAX's leaf order (its dicts' keys sorted): the CSR lists, the
        # dedup buckets, then the [N, k] tables (the maps of ``ell`` are
        # ``em_hosts``)
        self._leaves = []
        if resample_each_layer:
            # the full CSR lists (cols +1, weight ids), one zero slot past
            # the end so a degree-0 last row indexes in range
            csr = {}
            for name, a in zip(REL_ORDER, adjs):
                starts, cols, vals = _csr(a)
                csr[name] = (starts, np.append(cols + 1, 0),
                             np.append(vals.astype(np.int64), 0))
            self._leaves += [(f"csr.{name}.{j}", f"{name}_{part}", arr)
                             for name in sorted(REL_ORDER)
                             for j, (part, arr) in enumerate(zip(
                                 ("starts", "cols", "cw"), csr[name]))]
        self._n_buckets = {}
        if self.dedup:
            dedup = {name: _build_dedup_buckets(idx, w)
                     for name, (idx, w) in zip(REL_ORDER, tables)}
            for name in sorted(REL_ORDER):
                buckets, inv = dedup[name]
                self._n_buckets[name] = len(buckets)
                profiling.count("tgcn.buckets", len(buckets))
                profiling.count("tgcn.pairs", sum(
                    int(np.count_nonzero(b[3])) for b in buckets))
                self._leaves += [
                    (f"dedup.{name}.0.{b}.{j}", f"{name}_b{b}_{part}", arr)
                    for b, bucket in enumerate(buckets)
                    for j, (part, arr) in enumerate(zip(
                        ("rows", "ids", "wids", "mult"), bucket))]
                self._leaves.append((f"dedup.{name}.1", f"{name}_inv", inv))
        tabs = dict(zip(REL_ORDER, tables))
        self._leaves += [(f"{name}.{j}", f"{name}_{part}", tabs[name][j])
                         for name in sorted(REL_ORDER)
                         for j, part in enumerate(("idx", "w"))]
        self.tables_mesh = None
        self.blocks = {}
        self.place_tables(mesh, dev)
        self.em_hosts = {}
        if self.ell:
            # each table is a fixed edge set over the shifted column space,
            # every row with k edges (pad_multiple 1: no width rounding);
            # JAX's order: the relations' names sorted
            tabs = dict(zip(REL_ORDER, zip(tables, adjs)))
            for name in sorted(REL_ORDER):
                (idx, w), a = tabs[name]
                n, k = idx.shape
                rows = np.repeat(np.arange(n, dtype=np.int64), k)
                for part, cols, n_cols in ((0, idx, a.shape[1] + 1),
                                           (1, w, self.num_weight + 1)):
                    self.em_hosts[f"em.{name}.{part}"] = (
                        edgemap.build_edge_map(
                            rows, cols.ravel().astype(np.int64), None, n,
                            n_cols, pad_multiple=1))
            self.edges = edgemap.EdgeMapBuffers(
                edgemap.maps_to_device(self.em_hosts, dev, mesh))

    # ----------------------------------------------------- tables on a mesh
    def leaf_blocks(self, mesh=None) -> Dict[str, Optional[Tuple[int, int]]]:
        """{JAX's leaf path: the (start, stop) rows ``mesh``'s rank holds,
        or None: whole} of the tables (not the maps), by JAX's rule: a leaf
        of 64 rows or more that divide by ``model`` row-shards, but each
        relation's ``inv``, which puts the gathered bucket rows in order,
        and the CSR lists, which per-layer resampling draws over whole,
        stay whole on every rank (ROADMAP.md section C).  No mesh: every
        leaf whole."""
        if mesh is None:
            return {path: None for path, _, _ in self._leaves}
        m, i = mesh.shape["model"], mesh.index("model")

        def block(path, n):
            parts = path.split(".")
            if parts[0] == "csr" or parts[0] == "dedup" and parts[2] == "1":
                return None
            return ((i * (n // m), (i + 1) * (n // m))
                    if ell_lib.row_sharded(n, m) else None)
        return {path: block(path, arr.shape[0])
                for path, _, arr in self._leaves}

    def table_leaves(self, mesh=None) -> List[Tuple[str, np.ndarray]]:
        """[(JAX's leaf path, host array)] of the tables in JAX's leaf
        order: whole, or what ``mesh``'s rank holds of each."""
        blocks = self.leaf_blocks(mesh)
        return [(path, ell_lib.cut_rows(arr, blocks[path]))
                for path, _, arr in self._leaves]

    def place_tables(self, mesh=None, device=None) -> None:
        """The tables as buffers on ``device`` (the parameters' by
        default): whole, or each leaf ``leaf_blocks`` cuts for ``mesh``'s
        rank cut on the host before the upload, the whole buffers let go
        first.  Integer tables are int64 on the device."""
        device = device or next(self.parameters()).device
        for _, name, _ in self._leaves:
            if name in self._buffers:
                self._buffers[name] = None
        for (_, name, _), (_, arr) in zip(self._leaves,
                                          self.table_leaves(mesh)):
            if arr.dtype.kind in "iu":
                arr = arr.astype(np.int64)
            self.register_buffer(name, torch.as_tensor(arr).to(device))
        self.tables_mesh = mesh
        self.blocks = self.leaf_blocks(mesh)

    def graph_leaves(self, mesh) -> Dict[str, Optional[str]]:
        """The maps' leaves (``ell``) and the tables' (``leaf_blocks``), in
        JAX's leaf order: its dicts' keys sorted (csr, dedup, em, then the
        relations)."""
        spec = super().graph_leaves(mesh)
        spec.update({path: None if blk is None else "model"
                     for path, blk in self.leaf_blocks(mesh).items()})
        return dict(sorted(spec.items(), key=lambda kv: kv[0].split(".")[0]))

    def graph_mesh(self):
        return self.tables_mesh

    def place_graph(self, mesh) -> None:
        super().place_graph(mesh)
        self.place_tables(mesh)

    def table_tensors(self) -> List[Tuple[str, torch.Tensor]]:
        """[(JAX's leaf path, buffer)] of the tables the model holds."""
        return [(path, getattr(self, name)) for path, name, _ in self._leaves]

    def table_nbytes(self) -> int:
        """Bytes of the tables the model holds (the maps of ``ell`` are
        ``edges.nbytes()``)."""
        return sum(t.numel() * t.element_size()
                   for _, t in self.table_tensors())

    def piece_paths(self, name: str) -> List[str]:
        """The leaf paths of the pieces of relation ``name``'s attention:
        each dedup bucket's rows (``auto``), or else its [N, k] table."""
        if self.dedup:
            return [f"dedup.{name}.0.{b}.0"
                    for b in range(self._n_buckets[name])]
        return [f"{name}.0"]

    def _piece_blocks(self, name: str) -> list:
        """The rows the rank holds of each piece (``blocks``)."""
        return [self.blocks[p] for p in self.piece_paths(name)]

    def _split(self, name: str) -> bool:
        """Whether relation ``name``'s attention runs on a rank's rows: a
        mesh of more than one ``model`` rank that row-shards a piece."""
        mesh = self.tables_mesh
        return (mesh is not None and mesh.shape["model"] > 1
                and any(b is not None for b in self._piece_blocks(name)))

    @property
    def tier(self) -> str:
        """The execution tier built: "dedup" (``auto``: the deduplicated
        neighbour buckets), "ell" (two EdgeMaps a relation) or "takes"
        (the plain takes of ``dense_xla`` and ``resample_each_layer``)."""
        return "ell" if self.ell else "dedup" if self.dedup else "takes"

    # ------------------------------------------------------------- tables
    def table(self, name: str):
        """The (idx, w) [N, k] buffers of relation ``name``."""
        return getattr(self, f"{name}_idx"), getattr(self, f"{name}_w")

    def buckets(self, name: str):
        """The dedup buckets [(rows, ids, wids, mult)] of relation ``name``
        and its ``inv``."""
        return ([tuple(getattr(self, f"{name}_b{b}_{part}")
                       for part in ("rows", "ids", "wids", "mult"))
                 for b in range(self._n_buckets[name])],
                getattr(self, f"{name}_inv"))

    def _resample(self, generator: torch.Generator):
        """k fresh with-replacement slots per node from the full CSR lists,
        drawn from ``generator`` (on the model's device); degree-0 rows keep
        the 0 pad."""
        out = {}
        k = self.cfg.neighbor_k
        for name in REL_ORDER:
            starts = getattr(self, f"{name}_starts")
            deg = starts[1:] - starts[:-1]
            deg1 = torch.clamp(deg, min=1)[:, None]
            u = torch.rand((deg.shape[0], k), generator=generator,
                           device=deg.device, dtype=torch.float64)
            j = torch.minimum((u * deg1).long(), deg1 - 1)
            flat = starts[:-1, None] + j
            live = deg[:, None] > 0
            out[name] = (torch.where(live, getattr(self, f"{name}_cols")[flat], 0),
                         torch.where(live, getattr(self, f"{name}_cw")[flat], 0))
        return out

    # ------------------------------------------------------------ forward
    def forward(self, *, training: bool = False, generator=None):
        """-> (user, item, tag) tables [n, 176 at the preset]; ``generator``
        (on the model's device) draws the per-layer resampling and the
        message dropout when training."""
        cfg = self.cfg
        eu, ei, et = self.embed
        wide = eu.dtype
        # the EdgeMap tier keeps its tables in the model's float type
        tdt = (torch.bfloat16 if cfg.adj_dtype == "bf16" and not self.ell
               else wide)
        ew0 = torch.cat([self.weight.new_zeros((1, cfg.dim_weight)),
                         self.weight]).to(tdt)
        outs_u, outs_i, outs_t = [eu], [ei], [et]
        rows = self.attention_rows = dict.fromkeys(REL_ORDER, 0)
        for li, lp in enumerate(self.layers):
            z = eu.new_zeros((1, eu.shape[1]))
            eu0, ei0, et0 = (torch.cat([z, e]).to(tdt) for e in (eu, ei, et))
            a1 = lp.atten1
            # (attention params, node rows, neighbour table) per relation
            plan = {"u_iw": (a1["item"], eu, ei0), "u_tw": (a1["tag"], eu, et0),
                    "i_uw": (a1["user"], ei, eu0), "i_tw": (a1["tag"], ei, et0),
                    "t_uw": (a1["user"], et, eu0), "t_iw": (a1["item"], et, ei0)}
            tabs_static = not (self.resample_each_layer
                               and generator is not None)
            tabs = ({name: self.table(name) for name in REL_ORDER}
                    if tabs_static else self._resample(generator))
            agg = {}
            for name, (ap, ev, ej) in plan.items():
                if self.ell:
                    em_j = self.edges[f"em.{name}.0"]
                    rows[name] += sum(i.shape[0] for i in em_j.f_idx)
                    agg[name] = _atten1_em(ap, ev, ej, ew0, em_j,
                                           self.edges[f"em.{name}.1"])
                    continue
                pieces, inv = (self.buckets(name) if self.dedup
                               else ([tabs[name]], None))
                rows[name] += sum(p[0].shape[0] for p in pieces)
                if tabs_static and self._split(name):
                    agg[name] = _atten1_split(
                        ap, ev, ej, ew0, pieces, self._piece_blocks(name),
                        inv, self.tables_mesh)
                elif self.dedup:
                    agg[name] = _atten1_dedup(ap, ev, ej, ew0, pieces, inv)
                else:
                    agg[name] = _atten1(ap, ev, ej, ew0, *tabs[name])
            eu_n = _atten2(lp, eu, agg["u_iw"], agg["u_tw"])
            ei_n = _atten2(lp, agg["i_uw"], ei, agg["i_tw"])
            et_n = _atten2(lp, agg["t_uw"], agg["t_iw"], et)
            eu, ei, et = (_fusion(lp, _conv(lp, e)) for e in (eu_n, ei_n, et_n))
            rate = cfg.message_drop_list[li]
            if generator is not None:
                eu, ei, et = (message_dropout(e, rate, generator, training)
                              for e in (eu, ei, et))
            outs_u.append(l2_normalize(eu))
            outs_i.append(l2_normalize(ei))
            outs_t.append(l2_normalize(et))
        return (torch.cat(outs_u, dim=1), torch.cat(outs_i, dim=1),
                torch.cat(outs_t, dim=1))

    # --------------------------------------------------------------- loss
    def bpr_loss(self, batch, *, generator=None, training: bool = True):
        """BPR on a [B, 3] (user, item+, item-) batch with the L2 term on
        the final rows (model/tgcn.py:243-246) -> (loss, reg * l2)."""
        u_all, i_all, _ = self.forward(training=training, generator=generator)
        return base.bpr_with_reg(u_all, i_all, u_all, i_all, batch,
                                 self.cfg.mul_loss_func, self.cfg.reg)

    def transtag_loss(self, batch):
        """The margin loss on a [B, 4] (user, tag, item+, item-) batch over
        the EGO tables (model/tgcn.py:251-261) -> (loss, transtag_reg *
        l2)."""
        eu, ei, et = self.embed
        ue, te = eu[batch[:, 0]], et[batch[:, 1]]
        pe, ne = ei[batch[:, 2]], ei[batch[:, 3]]
        loss = losses.transtag_loss(ue, te, pe, ne, margin=self.cfg.margin)
        return loss, self.cfg.transtag_reg * losses.l2reg_loss(ue, te, pe, ne)

    @torch.no_grad()
    def predict(self, users):
        """[B, n_item] sigmoid scores of ``users``."""
        u_all, i_all, _ = self.forward()
        users = torch.as_tensor(users, device=u_all.device)
        return base.predict_sigmoid(u_all[users], i_all)
