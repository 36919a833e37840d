"""Row-sharded embedding lookups with explicit collectives. Counterpart
of `reviews4rec_tpu/parallel/embedding.py`.

The model axis row-shards the user/item tables (`parallel.mesh`): model
rank m holds rows [m * per, (m + 1) * per). Two lookups:

1. Owner-computes (`sharded_lookup`; `hp.embedding_lookup` "psum", and
   "gspmd" on a model axis > 1, since the port has no partitioner to
   choose for it): each rank gathers the rows it owns for the
   (replicated) ids, zeros elsewhere, and one all-reduce over the model
   axis combines the partial rows.
2. All-to-all bucketing (`sharded_lookup_a2a`; "a2a"): each rank takes
   1/n of the flat ids, buckets them by owner, one `all_to_all` ships
   the id buckets to their owners, owners gather their rows, a second
   `all_to_all` ships the rows back, the sort is undone, and the ranks'
   slices are all-gathered into the replicated [ids..., D] result.

Every collective is a `torch.autograd.Function` whose backward is JAX's
transpose for a result that is replicated over the axis: the model
ranks downstream of a lookup run the same computation, so each already
holds the whole cotangent. The all-reduce's backward is therefore the
identity and the final all-gather's keeps this rank's slice (torch's
differentiable collectives would sum the identical cotangents over the
ranks and scale the table gradient by the axis size). The all-to-all is
its own transpose. Values and table gradients are bitwise the plain
gather's: the owner's rows get their contributions in id order.
"""

from __future__ import annotations

import torch


class _SumOverAxis(torch.autograd.Function):
    """psum of partial rows whose sum is replicated over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllToAll(torch.autograd.Function):
    """Block j of x [n, ...] to rank j; its own transpose."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axis), None, None


class _GatherOverAxis(torch.autograd.Function):
    """[n, ...] of every rank's x, replicated over the axis: the
    backward keeps this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.index = mesh.index[axis]
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """Rows of a table sharded over `axis` (`table` is this rank's
    [per, ...] rows) at replicated int ids of any shape; returns
    ids.shape + table.shape[1:], replicated."""
    per = table.shape[0]
    local = ids.long() - mesh.index[axis] * per
    owned = (local >= 0) & (local < per)
    part = table[torch.where(owned, local, torch.zeros_like(local))]
    owned = owned.reshape(tuple(owned.shape) + (1,) * (table.dim() - 1))
    part = torch.where(owned, part, torch.zeros((), dtype=part.dtype,
                                                device=part.device))
    return _SumOverAxis.apply(part, mesh, axis)


def sharded_lookup_a2a(table: torch.Tensor, ids: torch.Tensor, mesh,
                       axis: str = "model") -> torch.Tensor:
    """ID-partitioned all-to-all lookup: `table` is this rank's [per, D]
    rows, `ids` this rank's [m] flat ids; returns their [m, D] rows.

    Sort the ids by owner, scatter them into an [n, m] bucket matrix
    (bucket s = the ids rank s owns, padded with id 0, never read back),
    all-to-all the buckets to their owners, gather the owned rows,
    all-to-all the rows back, undo the sort."""
    n = mesh.shape[axis]
    per = table.shape[0]
    assert ids.dim() == 1, ids.shape
    m = ids.shape[0]
    ids = ids.long()
    owner = torch.div(ids, per, rounding_mode="floor")
    order = torch.argsort(owner, stable=True)
    s_ids, s_owner = ids[order], owner[order]
    # rank within each owner bucket: position minus the bucket start
    start = torch.searchsorted(s_owner, torch.arange(n, device=ids.device))
    rank = torch.arange(m, device=ids.device) - start[s_owner]
    send = torch.zeros((n, m), dtype=ids.dtype, device=ids.device)
    send[s_owner, rank] = s_ids
    recv = mesh.all_to_all(send, axis)                  # [n, m]
    local = (recv - mesh.index[axis] * per).clamp(0, per - 1)
    back = _AllToAll.apply(table[local], mesh, axis)    # [n, m, D]
    got = back[s_owner, rank]                           # [m, D]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(m, device=ids.device)
    return got[inverse]


def make_lookup(strategy: str, mesh, axis: str = "model"):
    """Config-selected embedding gather (hp.embedding_lookup): a callable
    (table, ids any-shape int) -> ids.shape + (D,). On a model axis > 1
    `table` is this rank's rows; "gspmd" there is the owner-computes
    gather, and without one the plain `table[ids]`. All strategies are
    bitwise the plain gather in value and table gradient."""
    if strategy == "gspmd":
        if mesh is None or mesh.shape[axis] < 2:
            return lambda table, ids: table[ids]
        return lambda table, ids: sharded_lookup(table, ids, mesh, axis)
    if mesh is None or mesh.shape[axis] < 2:
        raise ValueError(
            f"embedding_lookup={strategy!r} needs a mesh with {axis!r} "
            f"axis > 1; got {None if mesh is None else dict(mesh.shape)}")
    if strategy == "psum":
        return lambda table, ids: sharded_lookup(table, ids, mesh, axis)
    if strategy == "a2a":
        n = mesh.shape[axis]

        def lookup(table, ids):
            flat = ids.reshape(-1)
            pad = (-flat.shape[0]) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            mine = flat.reshape(n, -1)[mesh.index[axis]]
            out = _GatherOverAxis.apply(
                sharded_lookup_a2a(table, mine, mesh, axis), mesh, axis)
            out = out.reshape((-1,) + tuple(table.shape[1:]))
            if pad:
                out = out[:-pad]
            return out.reshape(tuple(ids.shape) + tuple(table.shape[1:]))

        return lookup
    raise ValueError(f"unknown embedding_lookup {strategy!r} "
                     f"(expected gspmd | psum | a2a)")
