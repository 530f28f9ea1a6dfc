"""EdgeMap: paired forward/transpose ELL tables with scatter-free backwards
(tagrec_tpu/ops/edgemap.py).

The attention and routing models (KGAT, DGCF, DisenGCN, DisenHAN, TGCN's
``adj_mode="ell"``) compute learned per-edge values every step.  Autograd
of a gather-based formulation turns every gather into a scatter-add in the
backward.  But every cotangent of an edge op over a fixed edge set is an
edge op over the same edge set: an aggregation transposes to an
aggregation over the reversed edges, a per-edge product to gathers.  So
the host builds, once, the forward AND the transpose degree-bucketed ELL
tables and the flat slot bijection between them, and each primitive below
is a ``torch.autograd.Function`` whose backward is written over the
transpose structure with gathers only, never a scatter or ``index_add_``:

* ``edge_reduce(em, vals, x)``  out[r] = sum_k vals[r, k] * x[idx[r, k]]
    backward: d vals = edge_dot(em, g, x); d x = edge_reduce(em^T, T(vals), g)
* ``edge_dot(em, a, b)``        s[r, k] = a[r] . b[idx[r, k]]  (0 on pads)
    backward: d a = edge_reduce(em, ds, b); d b = edge_reduce(em^T, T(ds), a)
* ``edge_gather(em, v)``        s[r, k] = v[idx[r, k]]         (0 on pads)
* ``edge_vgather(em, x)``       s[r, k, :] = x[idx[r, k], :]   (0 on pads)
* ``rows_gather(em, x)``        row-ordered node data split into bucket order
* ``rows_ordered(em, parts)``   its adjoint: per-bucket row results in row
    order (TGCN's attention)
* ``edge_score(em, h, v)``      s[r, k] = h[r, k, :] . v[0], one shared
    weight row over per-slot vectors
* ``slot_sums(vals, vecs)``     out[r] = sum_k vals[r, k] * vecs[r, k, :]
* ``slot_transfer(vals, to, from)`` per-slot values between two EdgeMaps of
    one edge set (``cross_slot_maps``)

``T(.)`` (``transpose_vals``) moves per-slot values to the transpose layout
by the bijection, a gather with a zero sentinel for the pads.  Each value
operand may carry leading axes (the disentangled models' [F] factor
axis); the leading axes of the two operands of ``edge_reduce`` and
``edge_dot`` must be equal.  Per-bucket value tuples follow the map's
buckets, as JAX's do.

Each bucket's sum of ``edge_reduce`` (forward, and the two reductions of
the backwards of ``edge_reduce`` and ``edge_dot``) is
``ops.dma_gather.gather_reduce(x_f, idx, vals_f, deg)``, once per element
of the flattened leading axes: on a CUDA tensor the hand-written kernel
(float32 only; it raises on anything else), on a CPU tensor its plain
version.  ``deg`` keeps the pad slots out of the sum; JAX sums every slot,
which is the same on finite inputs because the pads' values are 0.  A
zero-width bucket gives zeros without a launch.  The other primitives
take rows by indexing, as JAX's ``jnp.take`` does.

The raw forms (``_reduce_raw``, ``_dot_raw``) are plain differentiable
PyTorch: ``edge_dot``'s forward and ``edge_reduce``'s d vals use
``_dot_raw``, and the tests differentiate both against the Functions.
Buckets whose [rows, K, D] gather is over ``EDGEMAP_GATHER_BUDGET_BYTES``
(priced with JAX's TPU padding, so the same buckets chunk) run in row
chunks, each recomputed in the backward rather than saved.  ``_dot_raw``
runs one batched product a block of ``_dot_rows`` rows, a count set by
the bucket's width and the device, never by its row count: on the card
a batched product's kernel, and its order of sums, follow its batch
count.

Under a mesh each map holds one ``model`` rank's rows (``shard_edge_map``,
JAX's ``gdev_sharding`` rule per bucket; an ``EdgeMapShard``), and each
slot map between two maps (KGAT's ``k2n`` and ``n2k``) the rank's rows of
its destination map (``shard_slot_map``; a ``SlotMapShard``, which
without a mesh holds the whole tables and exchanges nothing).  Per-slot
values live on the rank that holds their row.  A value that another rank
reads moves in one ``all_to_all_single`` over ``model``: the host maps
each slot's source slot once to (owning rank, that rank's slot), which
fixes the send indices and split sizes (``Exchange``), so a captured step
holds the exchange.  Whatever a primitive returns in row order is WHOLE on
every ``model`` rank: the rank's rows of each sharded bucket, one
all-gather over ``model`` (``propagate.gathered_rows``), each whole bucket
computed whole, then the whole ``f_inv``.  So ``edge_reduce`` (through
``gather_reduce(out=)``), ``row_sums``, ``rows_ordered`` and the
backwards of ``rows_gather``, ``edge_gather`` and ``edge_vgather`` (the
cotangents moved to the transpose layout by the exchange, then summed over
the rank's transpose rows) return the whole product, and a gradient that
reaches a whole tensor is the full gradient on every rank.
``transpose_vals`` and ``slot_transfer`` are the exchanges; ``edge_dot``,
``edge_gather``'s and ``edge_vgather``'s forwards, ``edge_softmax`` and
the d vals of ``edge_reduce`` are local to the rank's slots.  A weight
applied to per-slot values would get only the rank's part of its
gradient, so ``edge_score`` sums a weight row's gradient per row, puts the
rows in order whole, then sums them.  Over one rank the shard's tables are
the whole map's and today's code runs.  ``_reduce_raw`` takes whole maps
only, and raises on a shard.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from tagrec_tpu_torch.ops import dma_gather
from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.propagate import gathered_rows


class EdgeMapHost(NamedTuple):
    f: ell_lib.EllBucketsHost
    b: ell_lib.EllBucketsHost
    f_src: List[np.ndarray]  # per fwd bucket [Nb, Kb]: flat bwd slot
    b_src: List[np.ndarray]  # per bwd bucket [Mb, Kb]: flat fwd slot
    f_slot_of_edge: np.ndarray  # [E] flat fwd slot of each input edge
    b_slot_of_edge: np.ndarray


class EdgeMap(NamedTuple):
    """The device side: per-bucket int32 tensors (``f_val``/``b_val`` the
    float32 static payload), on one device."""

    f_idx: tuple   # per bucket [Nb, Kb] column ids
    f_val: tuple   # per bucket [Nb, Kb] static edge payload
    f_rows: tuple  # per bucket [Nb] row ids
    f_deg: tuple   # per bucket [Nb]
    f_inv: torch.Tensor  # [n_rows]: concat(bucket rows)[f_inv] is row order
    b_idx: tuple
    b_val: tuple
    b_rows: tuple
    b_deg: tuple
    b_inv: torch.Tensor
    f_src: tuple
    b_src: tuple

    @property
    def n_buckets(self) -> int:
        return len(self.f_idx)

    def transpose(self) -> "EdgeMap":
        return EdgeMap(f_idx=self.b_idx, f_val=self.b_val, f_rows=self.b_rows,
                       f_deg=self.b_deg, f_inv=self.b_inv, b_idx=self.f_idx,
                       b_val=self.f_val, b_rows=self.f_rows, b_deg=self.f_deg,
                       b_inv=self.f_inv, f_src=self.b_src, b_src=self.f_src)

    def masks(self, dtype=torch.float32) -> tuple:
        """Per-bucket [Nb, Kb] validity masks."""
        return tuple(_slot_mask(i, d).to(dtype)
                     for i, d in zip(self.f_idx, self.f_deg))


def _slot_mask(idx: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    return (torch.arange(idx.shape[1], device=deg.device)[None, :]
            < deg[:, None])


def build_edge_map(row, col, val, n_rows: int, n_cols: int,
                   boundaries=None, pad_multiple: int = 8) -> EdgeMapHost:
    """The paired forward/transpose bucketed tables and their slot
    bijection (host, once)."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if val is None:
        val = np.ones(len(row), dtype=np.float32)
    f, f_slot = ell_lib.build_ell_buckets_slots(
        row, col, val, n_rows, n_cols, boundaries=boundaries,
        pad_multiple=pad_multiple)
    b, b_slot = ell_lib.build_ell_buckets_slots(
        col, row, val, n_cols, n_rows, boundaries=boundaries,
        pad_multiple=pad_multiple)
    f_total, b_total = _total_slots(f), _total_slots(b)
    return EdgeMapHost(f=f, b=b,
                       f_src=_slot_tables(f, f_slot, b_slot, b_total),
                       b_src=_slot_tables(b, b_slot, f_slot, f_total),
                       f_slot_of_edge=f_slot, b_slot_of_edge=b_slot)


def _total_slots(h: ell_lib.EllBucketsHost) -> int:
    return sum(b.idx.shape[0] * b.idx.shape[1] for b in h.buckets)


def _split_flat(h: ell_lib.EllBucketsHost, flat: np.ndarray) -> List:
    """A flat per-slot array cut into ``h``'s per-bucket [Nb, Kb] tables."""
    out, off = [], 0
    for bk in h.buckets:
        n = bk.idx.shape[0] * bk.idx.shape[1]
        out.append(flat[off:off + n].reshape(bk.idx.shape))
        off += n
    return out


def _slot_tables(h: ell_lib.EllBucketsHost, slot, other_slot,
                 sentinel: int) -> List[np.ndarray]:
    """Per bucket of ``h``, each edge's slot in the other layout
    (``other_slot[e]`` at ``slot[e]``), ``sentinel`` (the other layout's
    zero slot) on the pads."""
    flat = np.full(_total_slots(h), sentinel, dtype=np.int64)
    flat[slot] = other_slot
    return [t.astype(np.int32) for t in _split_flat(h, flat)]


def slot_payload(host: EdgeMapHost, per_edge: np.ndarray, fill=0,
                 side: str = "f") -> List[np.ndarray]:
    """A per-edge array placed into per-bucket [Nb, Kb] tables (host,
    once), ``fill`` on the pads."""
    h = host.f if side == "f" else host.b
    slot = host.f_slot_of_edge if side == "f" else host.b_slot_of_edge
    per_edge = np.asarray(per_edge)
    flat = np.full(_total_slots(h), fill, dtype=per_edge.dtype)
    flat[slot] = per_edge
    return _split_flat(h, flat)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def to_device(host, device):
    """The device form of an EdgeMapHost (an EdgeMap), of a rank's
    EdgeMapShardHost (an EdgeMapShard) or of a SlotMapShardHost (a
    SlotMapShard)."""
    if isinstance(host, SlotMapShardHost):
        return SlotMapShard(read=tuple(_i32(t, device) for t in host.read),
                            x=host.x._replace(send=_i32(host.x.send, device)),
                            mesh=host.mesh)
    if isinstance(host, EdgeMapShardHost):
        em = to_device(host.cut._replace(f_src=host.f_read,
                                         b_src=host.b_read), device)
        return EdgeMapShard(
            local=em, f_blocks=host.f_blocks, b_blocks=host.b_blocks,
            f_x=host.f_x._replace(send=_i32(host.f_x.send, device)),
            b_x=host.b_x._replace(send=_i32(host.b_x.send, device)),
            mesh=host.mesh)

    def i32(a):
        return _i32(a, device)

    def side(h):
        return (tuple(ell_lib._ids(b.idx, h.n_cols, device)
                      for b in h.buckets),
                tuple(ell_lib._f32(b.val, device) for b in h.buckets),
                tuple(i32(r) for r in h.rows),
                tuple(i32(b.deg) for b in h.buckets),
                i32(h.inv_perm))

    f_idx, f_val, f_rows, f_deg, f_inv = side(host.f)
    b_idx, b_val, b_rows, b_deg, b_inv = side(host.b)
    return EdgeMap(f_idx=f_idx, f_val=f_val, f_rows=f_rows, f_deg=f_deg,
                   f_inv=f_inv, b_idx=b_idx, b_val=b_val, b_rows=b_rows,
                   b_deg=b_deg, b_inv=b_inv,
                   f_src=tuple(i32(s) for s in host.f_src),
                   b_src=tuple(i32(s) for s in host.b_src))


# ---------------------------------------------------------------------------
# rows over the ``model`` axis
# ---------------------------------------------------------------------------

# the leaves JAX row-shards too, but which stay whole here: a rank's rows
# of a product are put in order by the whole permutation (ROADMAP.md
# section C)
WHOLE_LEAVES = ("f_inv", "b_inv")
_FIELDS = ("idx", "val", "rows", "deg")


class Exchange(NamedTuple):
    """One ``all_to_all_single`` over ``model`` that moves per-slot values
    of one layout to the ranks whose slots of the other layout read them:
    ``send`` the rank's own flat slots it sends, grouped by destination
    rank; the split sizes by ``model`` rank (0 for itself); ``total`` the
    values every pair of ranks moves together (0: no exchange at all)."""

    send: object        # [S] int32 (numpy on the host, a tensor on a device)
    send_splits: tuple
    recv_splits: tuple
    total: int


class EdgeMapShardHost(NamedTuple):
    """One ``model`` rank's rows of an EdgeMapHost (``shard_edge_map``):
    ``cut`` the map with each row-sharded bucket of either layout cut to
    the rank's block (its ``f_src``/``b_src`` still JAX's global flat
    slots, its ``*_inv`` whole); ``f_read``/``b_read`` per bucket the
    position each of the rank's slots reads in the rank's extended slot
    vector of the other layout (its own slots, a zero sentinel, then the
    values the exchange brings); ``f_x`` moves forward values to the
    transpose's readers, ``b_x`` back."""

    cut: EdgeMapHost
    f_read: List[np.ndarray]
    b_read: List[np.ndarray]
    f_blocks: tuple     # per forward bucket (start, stop) of the rank's rows,
    b_blocks: tuple     # or None for a bucket whole on every rank
    f_x: Exchange
    b_x: Exchange
    mesh: object        # the parallel.Mesh


class EdgeMapShard(NamedTuple):
    """An EdgeMapShardHost on the device.  ``local`` is an EdgeMap over the
    rank's rows whose ``f_src``/``b_src`` are the read tables; the
    primitives take an EdgeMapShard where they take an EdgeMap, and its
    properties are ``local``'s."""

    local: EdgeMap
    f_blocks: tuple
    b_blocks: tuple
    f_x: Exchange
    b_x: Exchange
    mesh: object

    @property
    def model(self) -> int:
        return self.mesh.shape["model"]

    f_idx = property(lambda self: self.local.f_idx)
    f_rows = property(lambda self: self.local.f_rows)
    f_deg = property(lambda self: self.local.f_deg)
    f_inv = property(lambda self: self.local.f_inv)
    b_src = property(lambda self: self.local.b_src)

    @property
    def n_buckets(self) -> int:
        return self.local.n_buckets

    def masks(self, dtype=torch.float32) -> tuple:
        """The rank's rows of each bucket's validity mask, from its own
        ``deg`` (the masks are not stored)."""
        return self.local.masks(dtype)

    def transpose(self) -> "EdgeMapShard":
        return EdgeMapShard(local=self.local.transpose(),
                            f_blocks=self.b_blocks, b_blocks=self.f_blocks,
                            f_x=self.b_x, b_x=self.f_x, mesh=self.mesh)


def _blocks(h: ell_lib.EllBucketsHost, m: int, i: int) -> tuple:
    """Per bucket of ``h``: rank i's (start, stop) of the m even row blocks
    where JAX row-shards the bucket (``ell.row_sharded``), else None."""
    return tuple((i * (n // m), (i + 1) * (n // m))
                 if ell_lib.row_sharded(n, m) else None
                 for n in (b.idx.shape[0] for b in h.buckets))


def _cut_side(h: ell_lib.EllBucketsHost, blocks) -> ell_lib.EllBucketsHost:
    cut = ell_lib.cut_rows
    return h._replace(
        buckets=[ell_lib.EllHost(idx=cut(b.idx, k), val=cut(b.val, k),
                                 deg=cut(b.deg, k), n_cols=b.n_cols)
                 for b, k in zip(h.buckets, blocks)],
        rows=[cut(r, k) for r, k in zip(h.rows, blocks)])


class _SlotOwners:
    """Where each global flat slot of one layout lives under m row
    blocks: its owning rank (-1 in a whole bucket, on every rank) and its
    position in the owner's flat slots (the same layout on every rank, the
    blocks being even)."""

    def __init__(self, h: ell_lib.EllBucketsHost, blocks, m: int):
        shapes = [b.idx.shape for b in h.buckets]
        self.offs = np.cumsum([0] + [n * k for n, k in shapes])
        self.total = int(self.offs[-1])
        self.k = np.array([k for _, k in shapes] + [1], dtype=np.int64)
        self.per = np.array([(n // m if blk else n) for (n, _), blk in
                             zip(shapes, blocks)] + [1], dtype=np.int64)
        self.cut = np.array([blk is not None for blk in blocks] + [False])
        self.local_offs = np.cumsum([0] + [p * k for p, k in
                                           zip(self.per[:-1], self.k[:-1])])
        self.n_local = int(self.local_offs[-1])

    def __call__(self, s: np.ndarray):
        """-> (owner, local slot) of global slots ``s``; the sentinel
        (``total``) gets owner -2."""
        j = np.searchsorted(self.offs, s, side="right") - 1
        j = np.minimum(j, len(self.k) - 1)
        rel = s - self.offs[j]
        r, c = rel // self.k[j], rel % self.k[j]
        own = np.where(self.cut[j], r // self.per[j], -1)
        lr = np.where(self.cut[j], r - own * self.per[j], r)
        local = self.local_offs[j] + lr * self.k[j] + c
        return np.where(s == self.total, -2, own), local


def _exchange(src: ell_lib.EllBucketsHost, src_blocks, dst_tables,
              dst_rows, m: int, i: int):
    """The exchange that feeds the slots of the other layout from ``src``'s
    values, seen from rank i -> (Exchange, per destination bucket rank i's
    read table).  ``dst_tables``: per destination bucket the global src
    slot of each slot (``src``'s total on the pads); ``dst_rows(q)``: per
    destination bucket rank q's (start, stop) or None."""
    if m == 1:  # every slot is the rank's own: the tables are the reads
        return (Exchange(send=np.zeros(0, np.int32), send_splits=(0,),
                         recv_splits=(0,), total=0),
                [np.asarray(t, np.int32) for t in dst_tables])
    owners = _SlotOwners(src, src_blocks, m)
    # every destination slot's source, owner and local slot, found once;
    # rank q's slots are its rows' ranges of them
    own_all, local_all = owners(np.concatenate(
        [t.reshape(-1) for t in dst_tables]
        + [np.zeros(0, np.int64)]).astype(np.int64))
    offs = np.cumsum([0] + [t.size for t in dst_tables])

    def ranks_slots(a, q):
        return np.concatenate([a[o:o + t.size] if blk is None else
                               a[o + blk[0] * t.shape[1]:
                                 o + blk[1] * t.shape[1]]
                               for t, o, blk in zip(dst_tables, offs,
                                                    dst_rows(q))]
                              + [a[:0]])

    need, counts = {}, {}
    for q in range(m):
        need[q] = (ranks_slots(own_all, q), ranks_slots(local_all, q))
        own = need[q][0]
        counts[q] = np.bincount(own[own >= 0], minlength=m)
        counts[q][q] = 0
    send = [np.zeros(0, np.int64)] * m
    for q in range(m):
        if q != i:
            own, local = need[q]
            send[q] = local[own == i]
    own, local = need[i]
    recv = counts[i]
    base = owners.n_local + 1
    read = np.where(own == -2, owners.n_local, local)
    starts = base + np.concatenate([[0], np.cumsum(recv)[:-1]])
    for p in range(m):
        if p != i and recv[p]:
            read[np.flatnonzero(own == p)] = starts[p] + np.arange(recv[p])
    tables, off = [], 0
    for t, blk in zip(dst_tables, dst_rows(i)):
        shape = ell_lib.cut_rows(t, blk).shape
        n = int(np.prod(shape))
        tables.append(read[off:off + n].reshape(shape).astype(np.int32))
        off += n
    x = Exchange(send=np.concatenate(send).astype(np.int32),
                 send_splits=tuple(len(a) for a in send),
                 recv_splits=tuple(int(c) for c in recv),
                 total=int(sum(c.sum() for c in counts.values())))
    return x, tables


def shard_edge_map(host: EdgeMapHost, mesh) -> EdgeMapShardHost:
    """``mesh``'s rank's rows of an EdgeMap, cut on the host before
    anything is uploaded, as JAX's ``gdev_sharding`` places the map's
    leaves: each bucket of either layout whose rows JAX row-shards (64 or
    more, dividing by ``model``: ``ell.row_sharded``) keeps the rank's
    block, the i-th of ``model`` even blocks, of its idx, val, rows, deg
    and slot map; every other bucket is whole on every rank; ``f_inv``
    and ``b_inv`` stay whole (WHOLE_LEAVES).  The slot maps index the
    other layout's global flat slots; each is mapped once here to (owning
    rank, that rank's slot), which gives the send indices and split sizes
    of one ``all_to_all_single`` a direction and the rank's read tables."""
    m, i = mesh.shape["model"], mesh.index("model")
    fb, bb = _blocks(host.f, m, i), _blocks(host.b, m, i)
    cut = EdgeMapHost(
        f=_cut_side(host.f, fb), b=_cut_side(host.b, bb),
        f_src=[ell_lib.cut_rows(t, k) for t, k in zip(host.f_src, fb)],
        b_src=[ell_lib.cut_rows(t, k) for t, k in zip(host.b_src, bb)],
        f_slot_of_edge=None, b_slot_of_edge=None)
    f_x, b_read = _exchange(host.f, _blocks(host.f, m, 0), host.b_src,
                            lambda q: _blocks(host.b, m, q), m, i)
    b_x, f_read = _exchange(host.b, _blocks(host.b, m, 0), host.f_src,
                            lambda q: _blocks(host.f, m, q), m, i)
    return EdgeMapShardHost(cut=cut, f_read=f_read, b_read=b_read,
                            f_blocks=fb, b_blocks=bb, f_x=f_x, b_x=b_x,
                            mesh=mesh)


class SlotMapHost(NamedTuple):
    """Per forward bucket of the map ``dst`` the global flat forward slot
    of the map ``src`` each slot reads (``src``'s total on the pads): one
    direction of ``cross_slot_maps`` (KGAT's ``k2n``: ``em`` reading
    ``emk``; ``n2k`` the reverse).  ``src`` and ``dst`` are the maps' keys
    among the model's hosts."""

    tables: List[np.ndarray]
    src: str
    dst: str


class SlotMapShardHost(NamedTuple):
    """One ``model`` rank's rows of a SlotMapHost (``shard_slot_map``):
    ``cut`` its tables cut as the destination map's forward buckets (still
    global slots: JAX's blocks), ``read`` per bucket the position each of
    the rank's slots reads in the rank's extended slot vector of the
    source map, ``x`` the exchange that brings the values other ranks
    hold.  Without a mesh (``mesh`` None) or over one rank ``cut`` and
    ``read`` are the whole tables and ``x`` exchanges nothing."""

    cut: List[np.ndarray]
    read: List[np.ndarray]
    x: Exchange
    mesh: object


class SlotMapShard(NamedTuple):
    """A SlotMapShardHost on the device, the form ``slot_transfer``
    takes."""

    read: tuple
    x: Exchange
    mesh: object


def shard_slot_map(host: SlotMapHost, hosts, mesh) -> SlotMapShardHost:
    """``mesh``'s rank's rows of a slot map, ``hosts`` holding its source
    and destination maps by key: the table of each destination bucket JAX
    row-shards cut to the rank's block, as the destination's forward
    buckets are; the source slots each owner sends and each rank's read
    tables from ``_exchange``, as ``shard_edge_map`` finds its own.
    ``mesh`` None: the whole tables, as over one rank."""
    m, i = (1, 0) if mesh is None else (mesh.shape["model"],
                                         mesh.index("model"))
    src, dst = hosts[host.src].f, hosts[host.dst].f
    x, read = _exchange(src, _blocks(src, m, 0), host.tables,
                        lambda q: _blocks(dst, m, q), m, i)
    return SlotMapShardHost(
        cut=[ell_lib.cut_rows(t, k)
             for t, k in zip(host.tables, _blocks(dst, m, i))],
        read=read, x=x, mesh=mesh)


def maps_to_device(hosts, device, mesh=None) -> Dict[str, object]:
    """A model's maps and slot maps ({JAX's leaf prefix: EdgeMapHost or
    SlotMapHost}) on ``device``, for ``EdgeMapBuffers``: whole, or under
    ``mesh`` each cut to the rank's rows on the host before the upload;
    a slot map always as a SlotMapShard (``shard_slot_map``)."""
    out = {}
    for key, h in hosts.items():
        if isinstance(h, SlotMapHost):
            h = shard_slot_map(h, hosts, mesh)
        elif mesh is not None:
            h = shard_edge_map(h, mesh)
        out[key] = to_device(h, device)
    return out


def host_leaves(hosts):
    """[(JAX's leaf path, array)] of a model's maps and slot maps, in
    ``hosts``' order (JAX's): each map's ``leaves``, each slot map's
    tables ``<key>.0`` ...; a rank's cut forms (EdgeMapShardHost,
    SlotMapShardHost) give their cut tables."""
    out = []
    for key, h in hosts.items():
        if isinstance(h, (SlotMapHost, SlotMapShardHost)):
            tables = h.tables if isinstance(h, SlotMapHost) else h.cut
            out += [(f"{key}.{j}", t) for j, t in enumerate(tables)]
        else:
            out += leaves(h, key)
    return out


def leaves(em, prefix: str = "em"):
    """[(JAX's leaf path, array)] of an EdgeMapHost, EdgeMap or a rank's
    form (EdgeMapShardHost: its cut map; EdgeMapShard: its local map), in
    JAX's leaf order: ``em.f_idx.0`` ... ``em.f_val.*``, ``em.f_rows.*``,
    ``em.f_deg.*``, ``em.f_inv``, the same of ``b``, then ``em.f_src.*``
    and ``em.b_src.*``."""
    if isinstance(em, EdgeMapShardHost):
        em = em.cut
    if isinstance(em, EdgeMapShard):
        em = em.local
    out = []
    for side in ("f", "b"):
        if isinstance(em, EdgeMapHost):
            h = getattr(em, side)
            parts = {"idx": [b.idx for b in h.buckets],
                     "val": [b.val for b in h.buckets], "rows": h.rows,
                     "deg": [b.deg for b in h.buckets]}
            inv = h.inv_perm
        else:
            parts = {f: getattr(em, f"{side}_{f}") for f in _FIELDS}
            inv = getattr(em, f"{side}_inv")
        out += [(f"{prefix}.{side}_{f}.{j}", a) for f in _FIELDS
                for j, a in enumerate(parts[f])]
        out.append((f"{prefix}.{side}_inv", inv))
    return out + [(f"{prefix}.{side}_src.{j}", a) for side in ("f", "b")
                  for j, a in enumerate(getattr(em, f"{side}_src"))]


class EdgeMapBuffers(nn.Module):
    """EdgeMaps (or a rank's EdgeMapShards) and SlotMapShards, held as a
    model's non-persistent buffers: ``.to()`` carries them,
    ``state_dict`` and the checkpoints do not see them.  ``buffers[key]``
    rebuilds the item from the current buffers; a key may be a dotted JAX
    leaf prefix (``ems.0``)."""

    def __init__(self, items: Dict[str, object]):
        super().__init__()
        self._layout = {}
        self._shards = {}  # key -> the shard's static part
        for key, item in items.items():
            if isinstance(item, EdgeMapShard):
                self._put(f"{key}_f_x", item.f_x.send)
                self._put(f"{key}_b_x", item.b_x.send)
                self._shards[key] = item._replace(
                    local=None, f_x=item.f_x._replace(send=None),
                    b_x=item.b_x._replace(send=None))
                item = item.local
            elif isinstance(item, SlotMapShard):
                self._put(f"{key}_x", item.x.send)
                self._shards[key] = item._replace(
                    read=None, x=item.x._replace(send=None))
                item = item.read
            if isinstance(item, EdgeMap):
                self._layout[key] = {f: self._put(f"{key}_{f}", v)
                                     for f, v in zip(item._fields, item)}
            else:
                self._layout[key] = self._put(key, item)

    def _put(self, name: str, v):
        name = name.replace(".", "_")
        if isinstance(v, tuple):
            for i, t in enumerate(v):
                self.register_buffer(f"{name}_{i}", t, persistent=False)
            return len(v)
        self.register_buffer(name, v, persistent=False)
        return None

    def _get(self, name: str, n):
        name = name.replace(".", "_")
        if n is None:
            return getattr(self, name)
        return tuple(getattr(self, f"{name}_{i}") for i in range(n))

    def __getitem__(self, key: str):
        lay = self._layout[key]
        shard = self._shards.get(key)
        if not isinstance(lay, dict):
            return shard._replace(
                read=self._get(key, lay),
                x=shard.x._replace(send=self._get(f"{key}_x", None)))
        em = EdgeMap(**{f: self._get(f"{key}_{f}", n)
                        for f, n in lay.items()})
        if shard is None:
            return em
        return shard._replace(
            local=em,
            f_x=shard.f_x._replace(send=self._get(f"{key}_f_x", None)),
            b_x=shard.b_x._replace(send=self._get(f"{key}_b_x", None)))

    def nbytes(self) -> int:
        """Bytes of every buffer: the maps, slot maps and exchange plans."""
        return sum(t.numel() * t.element_size() for t in self.buffers())


# ---------------------------------------------------------------------------
# raw forms (plain differentiable PyTorch)
# ---------------------------------------------------------------------------

# Budget of one bucket's [Nb, Kb, D] vector-gather intermediate, priced as
# JAX prices it on the TPU (minor dim padded to 128, slot dim to 8), so the
# same buckets run in row chunks in both packages.
EDGEMAP_GATHER_BUDGET_BYTES = 1 << 30


def _gather_bytes_per_row(k: int, d: int, itemsize: int = 4) -> int:
    return -(-k // 8) * 8 * (-(-d // 128) * 128) * itemsize


def _lead_n(lead) -> int:
    n = 1
    for s in lead:
        n *= int(s)
    return n


def _row_chunk_for(n: int, k: int, d: int, itemsize: int, lead=()) -> int:
    """0: no chunking (the bucket fits the budget); else the row-chunk size,
    a multiple of 8."""
    per_row = _gather_bytes_per_row(k, d, itemsize) * _lead_n(lead)
    if n == 0 or k == 0 or n * per_row <= EDGEMAP_GATHER_BUDGET_BYTES:
        return 0
    return max(EDGEMAP_GATHER_BUDGET_BYTES // per_row // 8 * 8, 8)


def _lead(what: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The common leading axes of two operands, which must be equal: a
    mismatch would otherwise fold into the row axis of a chunk."""
    la, lb = tuple(a.shape[:-2]), tuple(b.shape[:-2])
    if la != lb:
        raise ValueError(f"{what}: leading axes {la} and {lb} differ")
    return la


def _row_chunks(body, n: int, chunk: int) -> torch.Tensor:
    """body(start, stop) over row chunks, concatenated on axis -2; each
    chunk recomputed in the backward rather than saved; no chunk draws a
    random number, so no RNG state is stashed (graph-safe)."""
    remat = torch.is_grad_enabled()
    outs = [checkpoint(body, i, min(i + chunk, n), use_reentrant=False,
                       preserve_rng_state=False)
            if remat else body(i, min(i + chunk, n))
            for i in range(0, n, chunk)]
    return torch.cat(outs, dim=-2)


def _fixed_rows(body, *ts, dim: int, rows: int):
    """body(*blocks) over blocks of exactly ``rows`` rows of ``ts`` (row
    axis ``dim`` of each), the last block zero-padded; the results, rows
    on ``dim``, cut to the rows given and concatenated.  Every call has one
    shape, so a library kernel's choice, and with it the order in which it
    sums, does not depend on how many rows there are: a ``model`` rank's
    block of a bucket gets one device's bits.  The blocks are ``split``
    views (made contiguous), whose backward is one concatenation."""
    outs = []
    for blk in zip(*(t.split(rows, dim) for t in ts)):
        short = rows - blk[0].shape[dim]
        # contiguous, as a padded block is: a library call may take
        # another route for a strided view
        blk = [torch.nn.functional.pad(
                   b, [0, 0] * (b.dim() - 1 - dim % b.dim()) + [0, short])
               if short else b.contiguous() for b in blk]
        out = body(*blk)
        outs.append(out.narrow(dim, 0, rows - short) if short else out)
    return torch.cat(outs, dim=dim) if len(outs) > 1 else outs[0]


# Rows of one block of ``edge_score``'s and ``slot_sums``' products, by
# device type: a few launches a bucket on the card; few pad rows on the
# CPU (the plain path), whose buckets are small.
SLOT_BLOCK_ROWS = {"cuda": 2048}
SLOT_BLOCK_ROWS_ELSE = 256


def _slot_rows(device) -> int:
    return SLOT_BLOCK_ROWS.get(device.type, SLOT_BLOCK_ROWS_ELSE)


# Elements of one ``_dot_bucket`` block's [rows, K, D] gather, by device
# type: large on the card, where a block costs a few launches; small
# elsewhere (the CPU's plain path), where the last block's pad rows cost.
DOT_BLOCK_ELEMS = {"cuda": 1 << 24}
DOT_BLOCK_ELEMS_ELSE = 1 << 16


def _dot_rows(k: int, d: int, itemsize: int, lead, device) -> int:
    """The rows of one ``_dot_bucket`` block: set by the bucket's width
    and the device, never by its row count; within the gather budget."""
    per_row = _gather_bytes_per_row(k, d, itemsize) * _lead_n(lead)
    budget = max(EDGEMAP_GATHER_BUDGET_BYTES // per_row // 8 * 8, 8)
    elems = DOT_BLOCK_ELEMS.get(device.type, DOT_BLOCK_ELEMS_ELSE)
    return max(min(budget, elems // (k * d * _lead_n(lead)) // 8 * 8), 8)


def _reduce_bucket(v, idx, x):
    """sum_k v[..., n, k] * x[..., idx[n, k], :] for one bucket, over row
    chunks where the [chunk, Kb, D] gather is over the budget."""
    n, k = idx.shape
    lead = _lead("reduce", v, x)
    chunk = _row_chunk_for(n, k, x.shape[-1], x.element_size(), lead)

    def body(i, j):
        return torch.einsum("...nk,...nkd->...nd", v[..., i:j, :],
                            x[..., idx[i:j], :])

    if chunk == 0 or n <= chunk:
        return body(0, n)
    return _row_chunks(body, n, chunk)


def _reduce_raw(em: EdgeMap, vals, x):
    """out[..., r, :] = sum_k vals[..., rb, k] * x[..., idx[rb, k], :] in
    row order (the pads' vals must be 0).  A whole map only: on a rank's
    rows the whole ``f_inv`` would take rows the rank does not hold."""
    if _sharded(em):
        raise ValueError("_reduce_raw takes a whole EdgeMap, not one "
                         "model rank's rows; edge_reduce takes both")
    outs = [_reduce_bucket(v, idx, x) for v, idx in zip(vals, em.f_idx)]
    return torch.cat(outs, dim=-2)[..., em.f_inv, :]


def _dot_bucket(ar, idx, b):
    """s[..., n, k] = ar[..., n, :] . b[..., idx[n, k], :] for one bucket:
    batched products over blocks of ``_dot_rows`` rows (``_fixed_rows``),
    since on the card a batched product's kernel, and its order of sums,
    follow its batch count, and a rank's rows must get one device's bits;
    each block recomputed in the backward where the bucket's gather is
    over the budget (``_row_chunk_for``), as ``_reduce_bucket``'s."""
    n, k = idx.shape
    lead = _lead("dot", ar, b)
    d, size = b.shape[-1], b.element_size()

    def body(a_, i_):
        return torch.einsum("...nd,...nkd->...nk", a_, b[..., i_, :])

    if n == 0 or k == 0 or d == 0:
        return body(ar, idx)
    block = body
    if _row_chunk_for(n, k, d, size, lead) and torch.is_grad_enabled():
        def block(a_, i_):
            return checkpoint(body, a_, i_, use_reentrant=False,
                              preserve_rng_state=False)
    return _fixed_rows(block, ar, idx, dim=-2,
                       rows=_dot_rows(k, d, size, lead, b.device))


def _dot_raw(em: EdgeMap, a, b, masked: bool = True):
    """s[..., rb, k] = a[..., rows[rb], :] . b[..., idx[rb, k], :], 0 on
    the pads."""
    out = []
    for idx, rows, deg in zip(em.f_idx, em.f_rows, em.f_deg):
        s = _dot_bucket(a[..., rows, :], idx, b)
        out.append(torch.where(_slot_mask(idx, deg), s, 0.0) if masked
                   else s)
    return tuple(out)


def _gather_raw(em: EdgeMap, v, masked: bool = True):
    """s[..., rb, k] = v[..., idx[rb, k]], 0 on the pads."""
    out = []
    for idx, deg in zip(em.f_idx, em.f_deg):
        s = v[..., idx]
        out.append(torch.where(_slot_mask(idx, deg), s, 0.0) if masked
                   else s)
    return tuple(out)


def _vgather_raw(em: EdgeMap, x, masked: bool = True):
    """s[..., rb, k, :] = x[..., idx[rb, k], :], zero vectors on the pads."""
    out = []
    for idx, deg in zip(em.f_idx, em.f_deg):
        s = x[..., idx, :]
        out.append(torch.where(_slot_mask(idx, deg)[..., None], s, 0.0)
                   if masked else s)
    return tuple(out)


def _rows_gather_raw(em: EdgeMap, x):
    return tuple(x[..., rows, :] for rows in em.f_rows)


def _mask_tuple(em: EdgeMap, vals):
    return tuple(torch.where(_slot_mask(idx, deg), v, 0.0)
                 for v, idx, deg in zip(vals, em.f_idx, em.f_deg))


def _flat_slots(vals, tail: int = 0) -> torch.Tensor:
    """The per-bucket values concatenated over the flat slots, with one
    zero slot appended (the pads' sentinel); ``tail`` trailing axes kept."""
    lead = vals[0].shape[:vals[0].dim() - 2 - tail]
    rest = tuple(vals[0].shape[vals[0].dim() - tail:])
    flat = torch.cat([v.reshape(lead + (-1,) + rest) for v in vals],
                     dim=len(lead))
    zero = flat.new_zeros(lead + (1,) + rest)
    return torch.cat([flat, zero], dim=len(lead))


def transpose_vals(em, vals, tail: int = 0):
    """Per-slot values moved from the forward layout to the transpose's;
    the transpose's pads read the zero sentinel; ``tail`` trailing axes
    (``edge_vgather``'s D) ride along.  On an EdgeMapShard over more than
    one rank, the rank's slots of each layout: the values its transpose
    slots read from other ranks come in one ``all_to_all_single`` over
    ``model`` (``Exchange``), the rest are read locally."""
    flat = _flat_slots(vals, tail)
    if isinstance(em, EdgeMapShard) and em.f_x.total:
        flat = _exchanged(em.f_x, em.mesh, flat, tail)
    return tuple(flat[(Ellipsis, src) + (slice(None),) * tail]
                 for src in em.b_src)


def _exchanged(x: Exchange, mesh, flat: torch.Tensor,
               tail: int = 0) -> torch.Tensor:
    """The rank's slot values (``flat``, its slot axis the ``tail``-th
    from the end, [..., L + 1, *tail] with the zero sentinel last)
    extended on that axis by the values ``x`` brings from other ranks, in
    the order the read tables expect."""
    ax = flat.dim() - 1 - tail
    f = flat.movedim(ax, -1)
    f2 = f.reshape(-1, f.shape[-1])
    send = f2[:, x.send].t().contiguous()                 # [S, rest]
    recv = send.new_empty((sum(x.recv_splits), f2.shape[0]))
    dist.all_to_all_single(recv, send, list(x.recv_splits),
                           list(x.send_splits), group=mesh.group("model"))
    out = torch.cat([f2, recv.t()], dim=1)
    return out.reshape(f.shape[:-1] + (-1,)).movedim(-1, ax)


def _transfer(vals, slot_map: "SlotMapShard"):
    """``slot_transfer``'s move: each destination slot's value from the
    rank's extended slot vector by its read table, the other ranks' values
    brought by the slot map's exchange (none without a mesh)."""
    flat = _flat_slots(vals)
    if slot_map.x.total:
        flat = _exchanged(slot_map.x, slot_map.mesh, flat)
    return tuple(flat[..., t] for t in slot_map.read)


# ---------------------------------------------------------------------------
# the per-bucket sum on the gather_reduce kernel
# ---------------------------------------------------------------------------

def _bucket_sum(v, idx, deg, x, out=None):
    """sum over k < deg[n] of v[..., n, k] * x[..., idx[n, k], :] for one
    bucket: one ``gather_reduce`` per element of the flattened leading
    axes; zeros without a launch for a bucket of width 0.  ``out``: a
    [..., n, D] view whose [n, D] planes are contiguous (the rank's part
    of a send buffer) that takes the rows."""
    n, k = idx.shape
    lead = _lead("edge_reduce", v, x)
    d = x.shape[-1]
    if n == 0 or k == 0:
        return x.new_zeros(lead + (n, d)) if out is None else out.zero_()
    vf = v.reshape((-1, n, k))
    xf = x.reshape((-1,) + tuple(x.shape[-2:]))
    if out is not None:
        of = out.view((-1, n, d))
        for i in range(vf.shape[0]):
            dma_gather.gather_reduce(xf[i].contiguous(), idx,
                                     vf[i].contiguous(), deg, out=of[i])
        return out
    out = [dma_gather.gather_reduce(xf[i].contiguous(), idx,
                                    vf[i].contiguous(), deg)
           for i in range(vf.shape[0])]
    return torch.stack(out).reshape(lead + (n, d))


def _sharded(em) -> bool:
    """An EdgeMapShard over more than one rank: its rows are the rank's.
    Over one rank its tables are the whole map's, and today's code runs."""
    return isinstance(em, EdgeMapShard) and em.model > 1


def _in_row_order(em, parts, like: torch.Tensor, lead, tail=()):
    """Per forward bucket row results in row order, [*lead, n_rows,
    *tail]: ``parts[j](out)`` gives bucket j's rows (into ``out`` where
    given).  On an EdgeMapShard over more than one rank
    ``propagate.gathered_rows`` over its forward buckets and ``f_inv``,
    whole on every ``model`` rank; else the buckets' rows concatenated and
    put in order by ``f_inv``."""
    if _sharded(em):
        return gathered_rows(em.mesh, em.f_blocks, em.f_inv, parts, like,
                             lead, tail)
    ax = len(lead)
    return torch.cat([part(None) for part in parts],
                     dim=ax).index_select(ax, em.f_inv)


def _into(t: torch.Tensor):
    """A part for ``_in_row_order`` that gives ``t``."""
    return lambda out: t if out is None else out.copy_(t)


def _reduce(em, vals, x):
    """``_reduce_raw``'s value, each bucket through ``_bucket_sum``.  On an
    EdgeMapShard over more than one rank: the rank's rows of each sharded
    bucket, all-gathered once (``propagate.gathered_rows``); the whole
    buckets whole on every rank; the WHOLE product on every ``model``
    rank."""
    lead = _lead("edge_reduce", vals[0], x)
    parts = [lambda out, v=v, idx=idx, deg=deg: _bucket_sum(v, idx, deg, x,
                                                            out=out)
             for v, idx, deg in zip(vals, em.f_idx, em.f_deg)]
    return _in_row_order(em, parts, x, lead, (x.shape[-1],))


def row_sums(em, vals) -> torch.Tensor:
    """Each row's sum of its slots' values, [..., n_rows] in row order
    (DGCF's routed degree): ``vals`` a tuple of [..., Nb, Kb].  On an
    EdgeMapShard over more than one rank, the rank's rows of each sharded
    bucket, all-gathered once."""
    return _in_row_order(em, [_into(v.sum(dim=-1)) for v in vals], vals[0],
                         vals[0].shape[:-2])


# ---------------------------------------------------------------------------
# the primitives: autograd Functions whose backwards are gathers only
# ---------------------------------------------------------------------------

class _RowsGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x):
        ctx.em = em
        return _rows_gather_raw(em, x)

    @staticmethod
    def backward(ctx, *dparts):
        # the buckets partition the rows: the cotangent is a gather (on a
        # rank's rows, whole after one all-gather)
        d = dparts[0]
        return None, _in_row_order(ctx.em, [_into(p) for p in dparts], d,
                                   d.shape[:-2], d.shape[-1:])


def rows_gather(em, x) -> tuple:
    """Row-ordered node data [..., n_rows, D] split into the buckets' row
    order -> tuple of [..., Nb, D] (on an EdgeMapShard, the rank's rows of
    each bucket)."""
    return _RowsGather.apply(em, x)


class _RowsOrdered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, *parts):
        ctx.em = em
        d = parts[0]
        return _in_row_order(em, [_into(p) for p in parts], d,
                             d.shape[:-2], d.shape[-1:])

    @staticmethod
    def backward(ctx, g):
        return (None, *_rows_gather_raw(ctx.em, g))


def rows_ordered(em, parts) -> torch.Tensor:
    """Per-bucket row results (a tuple of [..., Nb, D], on an EdgeMapShard
    the rank's rows of each bucket) put in row order -> [..., n_rows, D],
    whole on every ``model`` rank (JAX's ``take(concat(parts), f_inv)``):
    ``rows_gather``'s adjoint, whose backward is ``rows_gather``."""
    return _RowsOrdered.apply(em, *parts)


class _EdgeReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x, *vals):
        ctx.em = em
        ctx.save_for_backward(x, *vals)
        return _reduce(em, vals, x)

    @staticmethod
    def backward(ctx, g):
        em = ctx.em
        x, *vals = ctx.saved_tensors
        dvals = ((None,) * len(vals) if not any(ctx.needs_input_grad[2:])
                 else _dot_raw(em, g, x, masked=True))
        dx = (_reduce(em.transpose(), transpose_vals(em, vals), g)
              if ctx.needs_input_grad[1] else None)
        return (None, dx, *dvals)


def edge_reduce(em: EdgeMap, vals, x) -> torch.Tensor:
    """The learned-value SpMM: vals a tuple of [..., Nb, Kb] (0 on the
    pads), x [..., n_cols, D] -> [..., n_rows, D] in row order."""
    return _EdgeReduce.apply(em, x, *vals)


class _EdgeDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, a, b):
        ctx.em = em
        ctx.save_for_backward(a, b)
        return _dot_raw(em, a, b, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        em = ctx.em
        a, b = ctx.saved_tensors
        ds = _mask_tuple(em, ds)
        da = _reduce(em, ds, b) if ctx.needs_input_grad[1] else None
        db = (_reduce(em.transpose(), transpose_vals(em, ds), a)
              if ctx.needs_input_grad[2] else None)
        return None, da, db


def edge_dot(em: EdgeMap, a, b) -> tuple:
    """Per-edge inner products s[r, k] = a[r] . b[idx[r, k]], 0 on the pads:
    a [..., n_rows, D] in row order, b [..., n_cols, D] -> tuple of
    [..., Nb, Kb]."""
    return _EdgeDot.apply(em, a, b)


class _EdgeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, v):
        ctx.em = em
        return _gather_raw(em, v, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        # each transpose row's sum of its slots, whole on every rank
        em = ctx.em
        return None, row_sums(em.transpose(),
                              transpose_vals(em, _mask_tuple(em, ds)))


def edge_gather(em, v) -> tuple:
    """Per-slot gather of a per-node value: s[r, k] = v[idx[r, k]], 0 on
    the pads; v [..., n_cols] -> tuple of [..., Nb, Kb]."""
    return _EdgeGather.apply(em, v)


class _EdgeVGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, x):
        ctx.em = em
        return _vgather_raw(em, x, masked=True)

    @staticmethod
    def backward(ctx, *ds):
        # the forward's pad slots are in no b_src table, so their
        # cotangents drop out; D stays the minor axis throughout
        em = ctx.em
        d = ds[0]
        ds_t = transpose_vals(em, ds, tail=1)
        return None, _in_row_order(em.transpose(),
                                   [_into(s.sum(dim=-2)) for s in ds_t], d,
                                   d.shape[:-3], d.shape[-1:])


def edge_vgather(em, x) -> tuple:
    """Per-slot vector gather: s[r, k, :] = x[idx[r, k], :], zero vectors
    on the pads; x [..., n_cols, D] -> tuple of [..., Nb, Kb, D].  Its
    backward sums each transpose row's slots (TGCN's neighbour reads,
    whose autograd backward is a scatter-add into the node table)."""
    return _EdgeVGather.apply(em, x)


def edge_softmax(em, scores) -> tuple:
    """Masked softmax over each row's slots (torch.sparse.softmax over
    dim 1): 0 on the pads, all-zero rows for degree-0 rows; the row max is
    detached, as JAX's stop_gradient.  scores: tuple of [..., Nb, Kb].
    Row-local: on an EdgeMapShard the rank's rows."""
    out = []
    for s, idx, deg in zip(scores, em.f_idx, em.f_deg):
        if s.shape[-1] == 0:
            out.append(s)
            continue
        m = _slot_mask(idx, deg)
        masked = torch.where(m, s, torch.finfo(s.dtype).min)
        mx = torch.amax(masked, dim=-1, keepdim=True).detach()
        e = torch.exp(masked - mx) * m
        z = torch.sum(e, dim=-1, keepdim=True)
        out.append(e / torch.where(z == 0, 1.0, z))
    return tuple(out)


def _slot_blocks(body, vals, vecs):
    """body(vals, vecs) over fixed row blocks (``_fixed_rows``), with the
    row axes (-2 of vals [..., Nb, Kb], -3 of vecs [..., Nb, Kb, X])
    moved first and the result's (``body``'s first axis) moved to -2."""
    return _fixed_rows(body, vals.movedim(-2, 0), vecs.movedim(-3, 0),
                       dim=0, rows=_slot_rows(vecs.device)).movedim(0, -2)


class _EdgeScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, em, v, *h):
        ctx.em = em
        ctx.save_for_backward(v, *h)
        return tuple(_fixed_rows(lambda h_: (h_ @ v.T)[..., 0],
                                 hb.movedim(-3, 0), dim=0,
                                 rows=_slot_rows(hb.device)).movedim(0, -2)
                     for hb in h)

    @staticmethod
    def backward(ctx, *ds):
        em = ctx.em
        v, *h = ctx.saved_tensors
        dh = tuple(d[..., None] * v for d in ds)
        # d v: each row's sum over its slots, the rows in order (whole on
        # every rank), then their sum: the same on every rank and over one
        parts = [_into(_slot_blocks(
            lambda d_, h_: torch.einsum("n...k,n...ka->n...a", d_, h_),
            d, hb)) for d, hb in zip(ds, h)]
        rows = _in_row_order(em, parts, v, ds[0].shape[:-2], v.shape[-1:])
        return (None, rows.reshape(-1, v.shape[-1]).sum(dim=0,
                                                        keepdim=True), *dh)


def edge_score(em, h, v) -> tuple:
    """Per-slot scores of per-slot vectors against one shared weight row:
    h a tuple of [..., Nb, Kb, A], v [1, A] -> tuple of [..., Nb, Kb],
    s = (h @ v.T)[..., 0] (TGCN's attention scores), in products over
    fixed row blocks, so a rank's rows are one device's bit for bit.  v's
    gradient is summed per row and over the rows in row order, so on an
    EdgeMapShard it is the full gradient on every rank, not the rank's
    part."""
    return _EdgeScore.apply(em, v, *h)


def slot_sums(vals, vecs) -> tuple:
    """Each row's sum of its slots' vectors weighted by the slots' values,
    out[..., n, :] = sum_k vals[..., n, k] * vecs[..., n, k, :]: vals a
    tuple of [..., Nb, Kb], vecs of [..., Nb, Kb, D] -> tuple of
    [..., Nb, D] (TGCN's attention-weighted neighbour sum), in batched
    products over fixed row blocks, so a rank's rows get one device's
    bits; differentiable in both."""
    return tuple(_slot_blocks(
        lambda a_, x_: torch.einsum("n...k,n...kd->n...d", a_, x_), a, x)
        for a, x in zip(vals, vecs))


# ---------------------------------------------------------------------------
# two EdgeMaps over one edge set
# ---------------------------------------------------------------------------

def cross_slot_maps(host_from: EdgeMapHost, host_to: EdgeMapHost):
    """The slot bijections between two EdgeMaps built over the same edges
    in the same order (a node-keyed and a (relation, node)-keyed map) ->
    (to_tables, from_tables): per to-bucket [Nb, Kb] indices into the
    from-side flat slots (the from total on the pads), and the reverse.
    ``slot_transfer`` takes them."""
    assert len(host_from.f_slot_of_edge) == len(host_to.f_slot_of_edge)
    f_tot = _total_slots(host_from.f)
    t_tot = _total_slots(host_to.f)
    to_tables = _slot_tables(host_to.f, host_to.f_slot_of_edge,
                             host_from.f_slot_of_edge, f_tot)
    from_tables = _slot_tables(host_from.f, host_from.f_slot_of_edge,
                               host_to.f_slot_of_edge, t_tot)
    return to_tables, from_tables


class _SlotTransfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, to, from_, *vals):
        ctx.from_ = from_
        return _transfer(vals, to)

    @staticmethod
    def backward(ctx, *ds):
        # the inverse transfer: a gather, not a scatter
        return (None, None, *_transfer(ds, ctx.from_))


def slot_transfer(vals, to, from_) -> tuple:
    """Per-slot values moved between the layouts of two EdgeMaps over one
    edge set: ``to`` and ``from_`` each direction's SlotMapShard
    (``shard_slot_map`` of ``cross_slot_maps``' tables), whose exchanges
    bring what other ranks hold."""
    return _SlotTransfer.apply(to, from_, *vals)
