"""Graph propagation over the ELL and dense formats of ``ops.ell``
(tagrec_tpu/ops/propagate.py).

``adj_mm`` is the SpMM of every constant-adjacency model: per degree bucket
one ``gather_reduce`` (kernel), the buckets' rows put back in order by one
``gather_rows`` (kernel), and one matmul for a dense block (the hub
columns, or the whole adjacency at small scale; a bfloat16 block takes x
rounded to bfloat16 and returns the float32 sums, as JAX's
``preferred_element_type=float32``).  ``pair_spmm`` differentiates it
without a scatter: the gradient of A @ x is A^T @ g, the same SpMM over the
transpose tables.  An adjacency with no transpose, such as the one
``edge_dropout`` returns, is differentiated by ``transpose_mm``: the
scatter-add of JAX's autodiff (a deterministic accumulate over the ELL
slots, the hub block's transpose product into the hub columns).  ``coo_spmm`` is the
oracle.

Under a mesh, LightGCN's and NGCF's pair holds one ``model`` rank's rows
(``ops.ell.RowShard``, JAX's ``gdev_sharding``), and ``sharded_mm`` is the
partition XLA derives from those rows: the rank's bucket rows through
``gather_reduce``, its hub rows ``dense_block @ gather_rows(x,
dense_cols)``, its sector rows, each written into the rank's part of one
buffer that one all-gather over ``model`` fills (in place on NCCL); the
whole [N, D] is then put in order (``gather_rows(., inv_perm)``) and
summed as on one device, by the same piece code (``_pieces``,
``_assemble``).  A piece whole on every rank (fewer than 64 rows, or
rows that do not divide) is computed whole on each.  The design returns
the WHOLE product on every ``model`` rank, so everything outside the
SpMM sees whole, identical tensors as it does without a mesh: the
parameters' gather keeps its slice backward, NGCF's replicated ``W``
gradients need no all-reduce, and the backward, over ``bwd``, takes the
whole gradient, identical on every ``model`` rank.  Returning row
blocks instead would save the gather's
bytes, but turn that slice into a reduce-scatter and every replicated
gradient into an all-reduce.  ``edge_dropout`` draws each table's
whole-shape mask and keeps the rank's rows, so the masks equal one
device's; the dropped form has no transpose tables, and its backward is
``transpose_mm`` over the rank's rows, a partial [N, D] summed by one
all-reduce over ``model``.  ``gathered_rows`` is that pattern for any
per-piece row results (the EdgeMap tier's, TGCN's attention; all of them
through ``gathered_blocks``, one all-gather of several results' blocks,
which the kernel tiers' mask sweeps also use), ``RankRows`` its
differentiable form (the cotangent's rows of each piece backward, a
whole piece's on ``model`` rank 0 only: TGCN's attention, the chunked
dense tiers), and ``model_sum`` the identity whose backward sums its
inputs' gradients over ``model`` in one all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tagrec_tpu_torch.ops import ell as ell_lib
from tagrec_tpu_torch.ops.dma_gather import (GATHER_BUDGET_BYTES,
                                             gather_reduce, gather_rows)


def coo_spmm(row, col, val, x, n_rows: int) -> torch.Tensor:
    """Oracle SpMM: out[r] = sum over edges e of row r of val[e] * x[col[e]]."""
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, row.long(), x[col.long()] * val[:, None])


def ell_mm(ell: ell_lib.Ell, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM: out[n] = sum_k val[n, k] * x[idx[n, k]] over the row's
    deg[n] edges (the pad slots after them are not read).  Forward only."""
    return gather_reduce(x, ell.idx, ell.val, ell.deg)


def ell_buckets_mm(eb: ell_lib.EllBuckets, x: torch.Tensor) -> torch.Tensor:
    """Bucketed ELL SpMM: one gather-reduce per bucket, then one row gather
    to restore row order.  Forward only."""
    outs = torch.cat([ell_mm(p, x) for p in eb.parts])
    return gather_rows(outs, eb.inv_perm)


def block_mm(b: torch.Tensor, x: torch.Tensor, out=None) -> torch.Tensor:
    """b @ x for a dense adjacency block, into ``out`` when given.  A
    bfloat16 block times x rounded to bfloat16, accumulated and returned
    in float32: on the card one ``torch.mm(..., out_dtype=float32)``; on
    the CPU, which has no kernel for it, the same product of the operands
    widened to float32 (exact: a product of two bfloat16 values fits a
    float32)."""
    if b.dtype != torch.bfloat16:
        return torch.mm(b, x, out=out)
    xb = x.to(torch.bfloat16)
    y = (torch.mm(b, xb, out_dtype=torch.float32) if b.is_cuda
         else b.float() @ xb.float())
    return y if out is None else out.copy_(y)


def block_t_mm(b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """b^T @ g as JAX's autodiff transposes ``block_mm``: for a bfloat16
    block the float32 product of b and g, rounded to bfloat16 (the dtype of
    the product's bfloat16 operand), then widened back."""
    if b.dtype != torch.bfloat16:
        return b.t() @ g
    return (b.t().float() @ g).to(torch.bfloat16).float()


def _pieces(form, x: torch.Tensor):
    """The products of a Hybrid's or DenseSectors' pieces with x, each a
    function of an ``out`` (None, or the buffer that takes the rows), in
    piece order: a Hybrid's buckets (``gather_reduce``; one with no rows
    launches nothing), then its dense block (the hub product, or the
    whole adjacency's); a DenseSectors' blocks."""
    if isinstance(form, ell_lib.DenseSectors):
        xs = torch.split(x, list(form.sizes))
        return [lambda o, b=b, xc=xs[ci]: block_mm(b, xc, out=o)
                for b, (_, ci) in zip(form.blocks, form.coords)]
    out = [lambda o, p=p: gather_reduce(x, p.idx, p.val, p.deg, out=o)
           for p in form.ell.parts]
    b = form.dense_block
    if b is not None and form.dense_cols is None:
        out.append(lambda o: block_mm(b, x, out=o))
    elif b is not None:
        out.append(lambda o: torch.mm(b, gather_rows(x, form.dense_cols),
                                      out=o))
    return out


def _piece_rows(form):
    """The rows of each of a Hybrid's or DenseSectors' pieces."""
    if isinstance(form, ell_lib.DenseSectors):
        return [b.shape[0] for b in form.blocks]
    return [p.idx.shape[0] for p in form.ell.parts] + (
        [] if form.dense_block is None else [form.dense_block.shape[0]])


def _assemble(form, outs, x: torch.Tensor) -> torch.Tensor:
    """The product from its pieces' products (each the whole piece's
    rows): the buckets' rows put in order by one ``gather_rows``, plus the
    hub product; the sector blocks summed into their row sectors."""
    if isinstance(form, ell_lib.DenseSectors):
        acc = [None] * len(form.sizes)
        for y, (ri, _) in zip(outs, form.coords):
            acc[ri] = y if acc[ri] is None else acc[ri] + y
        return torch.cat([o if o is not None else x.new_zeros((s, x.shape[1]))
                          for o, s in zip(acc, form.sizes)])
    if form.dense_cols is None and form.dense_block is not None:
        return outs[0]  # the whole adjacency as one block
    n = len(form.ell.parts)
    out = gather_rows(torch.cat(outs[:n]), form.ell.inv_perm)
    if form.dense_block is not None:
        out = out + outs[n]
    return out


def hybrid_mm(h, x: torch.Tensor) -> torch.Tensor:
    """Hybrid SpMM: the ELL tail plus the hub block times the hub columns'
    rows; a block with no hub columns is the whole adjacency.  Also takes
    the sector-blocked dense form: one matmul per nonzero sector block."""
    return _assemble(h, [product(None) for product in _pieces(h, x)], x)


def ell_mm_t(ell: ell_lib.Ell, g: torch.Tensor, n_cols: int,
             budget: int = GATHER_BUDGET_BYTES) -> torch.Tensor:
    """A^T @ g for one ELL table: each real slot (k < deg[n]) adds
    val[n, k] * g[n] into row idx[n, k] of the [n_cols, D] result, over
    chunks of the real slots (``ell.live``, found once on the host) whose
    [slots, D] terms fit ``budget``, in row-major order.  Its shapes are
    fixed when the table is built and it reads nothing back to the host,
    so a CUDA graph can hold it.

    The sum is deterministic on both devices: ``index_add_`` on the CPU;
    on the card, whose ``index_add_`` adds floats atomically in no fixed
    order, ``index_put_(accumulate=True)``, which sorts the target rows
    and sums each row's terms in slot order, so two runs and a replayed
    graph agree bit for bit."""
    k = ell.idx.shape[1]
    d = g.shape[1]
    out = g.new_zeros((n_cols, d))
    chunk = max(budget // max(d * g.element_size(), 1), 1)
    idx, val = ell.idx.reshape(-1), ell.val.reshape(-1)
    for i in range(0, ell.live.shape[0], chunk):
        live = ell.live[i:i + chunk]
        rows = torch.div(live, k, rounding_mode="floor")
        dest = idx.index_select(0, live).long()
        terms = val.index_select(0, live)[:, None] * g.index_select(0, rows)
        if out.is_cuda:
            out.index_put_((dest,), terms, accumulate=True)
        else:
            out.index_add_(0, dest, terms)
    return out


def _transpose_pieces(form, g: torch.Tensor, n_cols: int, cuts,
                      lead: bool = True) -> torch.Tensor:
    """A^T @ g over a Hybrid or DenseSectors form, each piece's part over
    its rows of g.  ``cuts``: per piece (block, rows): the rows [start,
    stop) of the piece's whole ``rows`` that the form holds, or None for
    all; a piece held whole adds its part only when ``lead``."""
    keep = [blk is not None or lead for blk, _ in cuts]
    d = g.shape[1]
    if isinstance(form, ell_lib.DenseSectors):
        gs = torch.split(g, list(form.sizes))
        acc = [None] * len(form.sizes)
        for b, (ri, ci), (blk, _), k in zip(form.blocks, form.coords, cuts,
                                            keep):
            if k:
                y = block_t_mm(b, ell_lib.cut_rows(gs[ri], blk))
                acc[ci] = y if acc[ci] is None else acc[ci] + y
        return torch.cat([o if o is not None else g.new_zeros((s, d))
                          for o, s in zip(acc, form.sizes)])
    if form.dense_cols is None and form.dense_block is not None:
        return (block_t_mm(form.dense_block, ell_lib.cut_rows(g, cuts[0][0]))
                if keep[0] else g.new_zeros((n_cols, d)))
    n = len(form.ell.parts)
    g_cat = torch.empty_like(g)  # the buckets' rows in concatenated order
    g_cat[form.ell.inv_perm.long()] = g
    out, start = None, 0
    for p, (blk, rows), k in zip(form.ell.parts, cuts, keep):
        if k:
            y = ell_mm_t(p, ell_lib.cut_rows(g_cat[start:start + rows], blk),
                         n_cols)
            out = y if out is None else out + y
        start += rows
    if out is None:
        out = g.new_zeros((n_cols, d))
    if form.dense_block is not None and keep[n]:
        out.index_add_(0, form.dense_cols.long(), form.dense_block.t()
                       @ ell_lib.cut_rows(g, cuts[n][0]))
    return out


def transpose_mm(h, g: torch.Tensor, n_cols: int) -> torch.Tensor:
    """A^T @ g for any one adjacency form (Hybrid, DenseSectors,
    EllBuckets, Ell) with ``n_cols`` columns: the backward of
    ``hybrid_mm``, as JAX's autodiff computes it (a scatter-add over the
    ELL slots; the dense blocks' transpose products, ``block_t_mm``)."""
    if isinstance(h, ell_lib.Ell):
        return ell_mm_t(h, g, n_cols)
    if isinstance(h, ell_lib.EllBuckets):
        h = ell_lib.Hybrid(ell=h, dense_cols=None, dense_block=None)
    return _transpose_pieces(h, g, n_cols,
                             [(None, n) for n in _piece_rows(h)])


class _AdjSpmm(torch.autograd.Function):
    """A @ x over one adjacency form; its gradient A^T @ g by
    ``transpose_mm``.  The adjacency is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.n = adj, x.shape[0]
        if isinstance(adj, ell_lib.EllBuckets):
            return ell_buckets_mm(adj, x)
        if isinstance(adj, ell_lib.Ell):
            return ell_mm(adj, x)
        return hybrid_mm(adj, x)

    @staticmethod
    def backward(ctx, g):
        return transpose_mm(ctx.adj, g.contiguous(), ctx.n), None


class _PairSpmm(torch.autograd.Function):
    """A @ x over ``fwd``; its gradient A^T @ g over ``bwd``.  The adjacency
    is a constant and gets no gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return hybrid_mm(fwd, x)

    @staticmethod
    def backward(ctx, g):
        return hybrid_mm(ctx.bwd, g.contiguous()), None, None


def pair_spmm(x: torch.Tensor, fwd, bwd) -> torch.Tensor:
    """SpMM with a scatter-free backward: ``fwd`` aggregates, its transpose
    ``bwd`` carries the gradient."""
    return _PairSpmm.apply(x.contiguous(), fwd, bwd)


# ----------------------------------------- rows over the ``model`` axis

# the collective that fills one tensor with every rank's rows (renamed
# all_gather_single in later torch)
_GATHER_INTO = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather_parts(full: torch.Tensor, mesh) -> torch.Tensor:
    """Fill ``full`` [model, ...] from every ``model`` rank's part: rank
    i's part ``full[i]`` goes to every rank, in one all-gather over
    ``model`` (in place on NCCL)."""
    i, group = mesh.index("model"), mesh.group("model")
    if mesh.backend == "nccl":  # in place: the rank's part is the input
        _GATHER_INTO(full.view(-1), full[i].view(-1), group=group)
    else:  # gloo: one all_gather into the buffer's parts
        dist.all_gather(list(full.unbind(0)), full[i].clone(), group=group)
    return full


def gathered_blocks(mesh, like: torch.Tensor, shapes, fill) -> list:
    """Results whole on every ``model`` rank from each rank's block of
    their rows, in one all-gather over ``model``: ``shapes`` gives each
    result's block as (lead, rows, tail), its rows on the axis after
    ``lead`` and split evenly over ``model`` (rank i holding rows [i *
    rows, (i + 1) * rows)); ``fill(*blocks)`` writes this rank's blocks
    into their views of one send buffer [model, total] of ``like``'s
    dtype, which the all-gather then fills (in place on NCCL)."""
    m, i = mesh.shape["model"], mesh.index("model")
    dims = [tuple(lead) + (rows,) + tuple(tail) for lead, rows, tail in shapes]
    sizes = [torch.Size(d).numel() for d in dims]
    full = like.new_empty((m, sum(sizes)))
    fill(*(v.view(d) for v, d in zip(full[i].split(sizes), dims)))
    all_gather_parts(full, mesh)
    return [part.view((m,) + d).movedim(0, len(lead))
            .reshape(tuple(lead) + (m * rows,) + tuple(tail))
            for part, d, (lead, rows, tail) in zip(full.split(sizes, dim=1),
                                                   dims, shapes)]


def gathered_pieces(mesh, blocks, parts, like: torch.Tensor, lead=(),
                    tail=()) -> list:
    """Each piece's [*lead, rows, *tail] result, whole on every ``model``
    rank, from a rank's rows.  ``parts[j](out)`` gives piece j's rows, in
    piece order: into ``out``, the rank's block of them in one send
    buffer, for a piece ``blocks[j]`` = (start, stop) row-shards, one
    all-gather over ``model`` filling every such piece's rows
    (``gathered_blocks``); returned whole, computed whole on every rank,
    for a whole one (``blocks[j]`` None)."""
    outs = [None] * len(parts)

    def fill(*views):
        cut = iter(views)
        for j, (part, blk) in enumerate(zip(parts, blocks)):
            outs[j] = part(None if blk is None else next(cut))

    shapes = [(lead, b[1] - b[0], tail) for b in blocks if b is not None]
    if not shapes:
        fill()
        return outs
    whole = iter(gathered_blocks(mesh, like, shapes, fill))
    return [o if blk is None else next(whole) for o, blk in zip(outs, blocks)]


def gathered_rows(mesh, blocks, inv, parts, like: torch.Tensor, lead=(),
                  tail=()) -> torch.Tensor:
    """The row-ordered [*lead, n_rows, *tail] result of per-piece row
    results, whole on every ``model`` rank, from a rank's rows: the
    pieces' results (``gathered_pieces``) concatenated and put in order by
    the whole ``inv`` (None: piece order is row order)."""
    ax = len(lead)
    out = torch.cat(gathered_pieces(mesh, blocks, parts, like, lead, tail),
                    dim=ax)
    return out if inv is None else out.index_select(ax, inv)


def leads(mesh) -> bool:
    """Whether this rank back-propagates a piece computed whole on every
    ``model`` rank: ``model`` rank 0 alone, so that a sum over ``model``
    counts the piece once."""
    return mesh.index("model") == 0


def _cut(g: torch.Tensor, blk, ax: int) -> torch.Tensor:
    """Rows ``blk`` = (start, stop) of ``g`` on axis ``ax`` (None: all)."""
    return g if blk is None else g.narrow(ax, blk[0], blk[1] - blk[0])


class RankRows(torch.autograd.Function):
    """Per-piece row results on a ``model`` rank -> the whole row-ordered
    result on every rank (``gathered_rows``: one all-gather of the
    row-sharded pieces' rows).  ``plan`` = (mesh, blocks, inv, rows, ax):
    each piece's block (None: computed whole), the whole ``inv`` (None:
    piece order is row order), each piece's global rows where ``inv`` is
    given (else None), and the rows' axis.  Backward: each piece's rows
    of the cotangent, a whole piece's on the leading rank only
    (``leads``; none elsewhere), so that a sum over ``model`` counts
    every row once."""

    @staticmethod
    def forward(ctx, plan, *outs):
        mesh, blocks, inv, rows, ax = plan
        ctx.plan = plan
        parts = [lambda out, o=o: o if out is None else out.copy_(o)
                 for o in outs]
        shape = outs[0].shape
        return gathered_rows(mesh, blocks, inv, parts, outs[0],
                             lead=shape[:ax], tail=shape[ax + 1:])

    @staticmethod
    def backward(ctx, g):
        mesh, blocks, inv, rows, ax = ctx.plan
        lead = leads(mesh)
        return (None, *(None if blk is None and not lead
                        else _cut(g, blk, ax) if r is None
                        else g.index_select(ax, r)
                        for r, blk in zip(rows, blocks)))


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.like = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        wide = torch.float32
        for _, dt in ctx.like:
            wide = torch.promote_types(wide, dt)
        flat = torch.cat([g.reshape(-1).to(wide) for g in gs])
        dist.all_reduce(flat, group=ctx.mesh.group("model"))
        out = flat.split([g.numel() for g in gs])
        return (None, *(p.view(shape).to(dt)
                        for p, (shape, dt) in zip(out, ctx.like)))


def model_sum(mesh, *xs) -> tuple:
    """``xs`` as they are; in the backward each one's gradient is summed
    over ``model``, all of them in one all-reduce of one flat buffer in
    their widest float type (float32 at least).  Put on the inputs of a
    computation that each rank runs over its own rows, it makes their
    gradients whole on every rank before anything reads them."""
    return _ModelSum.apply(mesh, *xs)


def sharded_mm(shard, x: torch.Tensor) -> torch.Tensor:
    """A @ x, whole on every ``model`` rank, from the rank's rows of A
    (``ell.RowShard``): each piece's product (``gathered_pieces``: the
    row-sharded pieces' rows through one all-gather over ``model``, the
    whole pieces computed whole), then the buckets' rows put in order and
    the pieces summed."""
    return _assemble(shard.form, gathered_pieces(
        shard.mesh, shard.blocks, _pieces(shard.form, x), x,
        tail=(x.shape[1],)), x)


def sharded_transpose_mm(shard, g: torch.Tensor, n_cols: int) -> torch.Tensor:
    """A^T @ g from the rank's rows of A: ``transpose_mm`` over each
    row-sharded piece's rows of g, each whole piece's on ``model`` rank 0
    only, summed over ``model`` by one all-reduce (with ``model`` = 1 the
    sum of ``transpose_mm``, in its order)."""
    out = _transpose_pieces(shard.form, g, n_cols,
                            list(zip(shard.blocks, shard.rows)),
                            lead=leads(shard.mesh))
    dist.all_reduce(out, group=shard.mesh.group("model"))
    return out


class _ShardedPairSpmm(torch.autograd.Function):
    """``_PairSpmm`` over a rank's rows: A @ x by ``sharded_mm`` over
    ``fwd``, its gradient A^T @ g by ``sharded_mm`` over ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return sharded_mm(fwd, x)

    @staticmethod
    def backward(ctx, g):
        return sharded_mm(ctx.bwd, g.contiguous()), None, None


class _ShardedSpmm(torch.autograd.Function):
    """``_AdjSpmm`` over a rank's rows (the dropped form): A @ x by
    ``sharded_mm``, its gradient by ``sharded_transpose_mm``."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.n = shard, x.shape[0]
        return sharded_mm(shard, x)

    @staticmethod
    def backward(ctx, g):
        return sharded_transpose_mm(ctx.shard, g.contiguous(), ctx.n), None


def adj_mm(adj, x: torch.Tensor) -> torch.Tensor:
    """Propagate with an AdjPair (its gradient over the transpose tables),
    or with a Hybrid, DenseSectors, EllBuckets or Ell (its gradient by
    ``transpose_mm``); a pair of RowShards or a RowShard the same over a
    rank's rows."""
    if isinstance(adj, ell_lib.AdjPair):
        if isinstance(adj.fwd, ell_lib.RowShard):
            return _ShardedPairSpmm.apply(x.contiguous(), adj.fwd, adj.bwd)
        return pair_spmm(x, adj.fwd, adj.bwd)
    if isinstance(adj, ell_lib.RowShard):
        return _ShardedSpmm.apply(x.contiguous(), adj)
    return _AdjSpmm.apply(x.contiguous(), adj)


def ell_softmax(ell: ell_lib.Ell, scores: torch.Tensor) -> torch.Tensor:
    """Row softmax over an ELL table's slots, the dense form of
    ``torch.sparse.softmax(adj, dim=1)``: ``scores`` [N, K] per-slot
    logits; the pad slots get 0 and a row with no edge is all zero."""
    mask = ell_lib.ell_mask(ell)
    masked = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    m = torch.max(masked, dim=1, keepdim=True).values
    e = torch.exp(masked - m.detach()) * mask
    s = torch.sum(e, dim=1, keepdim=True)
    return e / torch.where(s == 0, 1.0, s)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Row L2 normalize matching torch.nn.functional.normalize (clamp-min eps),
    through a clamped squared norm so an all-zero row stays finite (and its
    gradient is 0, not NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def message_dropout(x: torch.Tensor, rate: float,
                    generator: torch.Generator, training: bool) -> torch.Tensor:
    """Inverted dropout (torch.nn.functional.dropout semantics), its mask
    drawn from ``generator``, which lies on ``x``'s device."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _drop(v: torch.Tensor, keep: float, generator, block=None,
          rows: int = 0) -> torch.Tensor:
    """v * floor(u + keep) / keep, u uniform on [0, 1) from ``generator``:
    each value kept with probability ``keep`` and scaled by 1 / keep; a
    zero stays zero.  ``v`` the rows ``block`` = (start, stop) of a table
    of ``rows`` rows: u drawn for the whole table, its rows kept."""
    shape = v.shape if block is None else (rows,) + tuple(v.shape[1:])
    u = torch.rand(shape, generator=generator, device=v.device)
    u = ell_lib.cut_rows(u, block)
    return v * torch.floor(u + keep).to(v.dtype) / keep


def edge_dropout(adj, rate: float, generator: torch.Generator,
                 training: bool):
    """Edge dropout (the reference's ``node_drop``): each stored edge value
    dropped with probability ``rate``, the survivors scaled by 1 / (1 -
    rate), the masks drawn from ``generator`` (on the adjacency's device).
    Takes an Ell, EllBuckets, Hybrid (its ELL slots and every hub-block
    cell), DenseSectors, RowShard (each table's whole mask drawn, its
    rows kept: one device's masks) or AdjPair.  A dropped AdjPair is its
    dropped forward form, with no transpose tables, as in JAX: ``adj_mm``
    differentiates it by ``transpose_mm`` (``sharded_transpose_mm``)."""
    if not training or rate == 0.0:
        return adj
    keep = 1.0 - rate
    if isinstance(adj, ell_lib.AdjPair):
        return edge_dropout(adj.fwd, rate, generator, training)
    if isinstance(adj, ell_lib.RowShard):
        f, cuts = adj.form, list(zip(adj.blocks, adj.rows))
        if isinstance(f, ell_lib.DenseSectors):
            return adj._replace(form=f._replace(blocks=tuple(
                _drop(b, keep, generator, *c) for b, c in zip(f.blocks,
                                                              cuts))))
        parts = tuple(p._replace(val=_drop(p.val, keep, generator, *c))
                      for p, c in zip(f.ell.parts, cuts))
        return adj._replace(form=f._replace(
            ell=f.ell._replace(parts=parts),
            dense_block=None if f.dense_block is None
            else _drop(f.dense_block, keep, generator, *cuts[-1])))
    if isinstance(adj, ell_lib.DenseSectors):
        return ell_lib.DenseSectors(
            blocks=tuple(_drop(b, keep, generator) for b in adj.blocks),
            coords=adj.coords, sizes=adj.sizes)
    if isinstance(adj, ell_lib.Hybrid):
        return ell_lib.Hybrid(
            ell=edge_dropout(adj.ell, rate, generator, training),
            dense_cols=adj.dense_cols,
            dense_block=None if adj.dense_block is None
            else _drop(adj.dense_block, keep, generator))
    if isinstance(adj, ell_lib.EllBuckets):
        return ell_lib.EllBuckets(
            parts=tuple(edge_dropout(p, rate, generator, training)
                        for p in adj.parts),
            inv_perm=adj.inv_perm)
    return adj._replace(val=_drop(adj.val, keep, generator))
