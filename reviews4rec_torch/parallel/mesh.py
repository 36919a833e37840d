"""The (data, model) mesh of the port and its placement rules.
Counterpart of `reviews4rec_tpu/parallel/mesh.py`.

The mesh is a grid of `torch.distributed` ranks (one process a device,
`parallel.distributed`), rank = d * M + m for data index d and model
index m, with one process group for each data row (its model ranks) and
one for each model column (its data ranks). The port has no partitioner,
so every collective that GSPMD inserts for the JAX package is explicit
here:

- `data` axis: each data rank takes its contiguous rows of every global
  batch (`host_slice`), the loss is normalised by the weight sum over
  the axis, every dropout mask is drawn at the global batch's shape and
  sliced to the rank's rows (`models.layers.uniform`), and the
  gradients are summed over the axis before the optimizer steps
  (`reduce_grads`), so the updates are the single-device ones up to the
  order of the sums. The device caches hold each rank's example rows
  (`ShardedRecords`: an all-gather of the requested row ids and one
  all-to-all of the rows a step).
- `model` axis: the user/item embedding and bias tables are row-sharded
  (`param_spec`; each model rank holds, and trains, its contiguous row
  range, and so does its Adam state) and read through the owner-computes
  lookups of `parallel.embedding`. Everything else is replicated: the
  model ranks of a data row run the same dense computation on the same
  rows, except the TextCNN under `hp.seq_parallel`, whose time axis is
  split over the model ranks (`parallel.sequence`) and whose conv
  gradients are therefore summed over the model axis too.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


class Mesh:
    """A (data, model) grid over the world's ranks. `shape` and `index`
    map each axis name to its size and to this rank's coordinate."""

    def __init__(self, shape: Tuple[int, int],
                 axes: Tuple[str, str] = ("data", "model")):
        n_data, n_model = (int(s) for s in shape)
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (n_data, n_model)))
        self.rank = dist.get_rank()
        d, m = divmod(self.rank, n_model)
        self.index = dict(zip(self.axis_names, (d, m)))
        # every rank creates every group, in the same order
        self._groups = {}
        if n_model > 1:
            for row in range(n_data):
                g = dist.new_group([row * n_model + j for j in range(n_model)])
                if row == d:
                    self._groups[self.axis_names[1]] = g
        if n_data > 1:
            for col in range(n_model):
                g = dist.new_group([i * n_model + col for i in range(n_data)])
                if col == m:
                    self._groups[self.axis_names[0]] = g
        # gloo moves card tensors through host memory
        self._via_host = dist.get_backend() == "gloo"

    @property
    def data_axis(self) -> str:
        return self.axis_names[0]

    @property
    def model_axis(self) -> str:
        return self.axis_names[1]

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        if self._via_host and t.device.type != "cpu":
            return t.detach().cpu().contiguous()
        return t.detach().clone().contiguous()

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of `t` over `axis` (a new tensor; no autograd)."""
        if self.shape[axis] == 1:
            return t
        buf = self._send(t)
        dist.all_reduce(buf, group=self._groups[axis])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """[n, *t.shape]: every rank's `t` along `axis`, in axis order."""
        n = self.shape[axis]
        if n == 1:
            return t.detach().unsqueeze(0)
        src = self._send(t)
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self._groups[axis])
        return torch.stack(out).to(t.device)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """t [n, ...]: block j goes to rank j of `axis`; the result's
        block s is what rank s sent here."""
        if self.shape[axis] == 1:
            return t
        src = self._send(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._groups[axis])
        return out.to(t.device)


# by (shape, axes), for the process group `parallel.distributed` brought
# up (its `shutdown` empties it)
_meshes: Dict[Tuple, Mesh] = {}


def make_mesh(shape: Tuple[int, ...],
              axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    """The mesh of `shape` over the running process group (made once a
    shape; every rank must ask for the same meshes in the same order)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != 2 or len(axes) != 2:
        raise ValueError(f"the port's mesh has two axes (data, model); got "
                         f"mesh_shape {shape}, mesh_axes {axes}")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(
            f"mesh_shape {shape} needs a torch.distributed process group of "
            f"{n} ranks, one a device; found "
            f"{'none' if world is None else f'{world} ranks'}. Start one "
            f"process a device and call "
            f"reviews4rec_torch.parallel.distributed.initialize(coordinator,"
            f" num_processes, process_id) in each, or pass the CLI's "
            f"--coordinator/--num_processes/--process_id")
    key = (shape, axes)
    if key not in _meshes:
        _meshes[key] = Mesh(shape, axes)
    return _meshes[key]


def mesh_from_hp(hp) -> Optional[Mesh]:
    """The product-path mesh of `hp.mesh_shape` / `hp.mesh_axes`, or None
    for one device, so single-device runs skip the mesh machinery."""
    if math.prod(hp.mesh_shape) <= 1:
        return None
    n_data = int(hp.mesh_shape[0])
    if hp.batch_size % n_data:
        raise ValueError(
            f"batch_size {hp.batch_size} must divide over the data axis "
            f"({n_data} shards); pick a multiple of {n_data}")
    return make_mesh(tuple(hp.mesh_shape), tuple(hp.mesh_axes))


def host_slice(batch: Dict, mesh: Optional[Mesh], axis: int = 0) -> Dict:
    """This data rank's contiguous rows of a global batch (rows on dim
    `axis`: 1 for `ScanSteps`' stacked [S, B, ...] groups). Identity
    without a mesh or on a data axis of 1."""
    if mesh is None or mesh.shape[mesh.data_axis] == 1:
        return batch
    n, d = mesh.shape[mesh.data_axis], mesh.index[mesh.data_axis]

    def sl(x):
        per = x.shape[axis] // n
        return x[(slice(None),) * axis + (slice(d * per, (d + 1) * per),)]

    return {k: sl(v) for k, v in batch.items()}


# Parameter-name suffixes that hold per-entity rows and get sharded over
# the `model` axis. Everything else is replicated.
_ROW_SHARDED_2D = ("embedding",)
_ROW_SHARDED_1D = ("user_bias", "item_bias")


def param_spec(name: str, leaf: torch.Tensor) -> Optional[str]:
    """"model" for a row-sharded parameter (a 2-D `*embedding` table, a
    `user_bias` / `item_bias` vector), None for a replicated one."""
    last = name.rsplit(".", 1)[-1]
    if leaf.dim() == 2 and any(last.endswith(s) for s in _ROW_SHARDED_2D):
        return "model"
    if leaf.dim() == 1 and last in _ROW_SHARDED_1D:
        return "model"
    return None


def _shard_rows(full: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Rank m's rows of `full` split in n equal ranges, the last padded
    with zero rows (never indexed)."""
    per = -(-full.shape[0] // n)
    part = full[m * per:(m + 1) * per]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros(
            (per - part.shape[0],) + tuple(part.shape[1:]))])
    return part.clone()


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod_name, _, attr = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), attr


def _set_data_shard(model, args):
    from ..models import layers
    layers.set_data_shard(model._data_shard)


def _clear_data_shard(model, args, out):
    from ..models import layers
    layers.set_data_shard(None)


def shard_model(model: nn.Module, hp, mesh: Mesh) -> nn.Module:
    """Lay `model` out on `mesh` in place (the JAX package's
    `shard_params` plus what its partitioner does): on a model axis > 1
    each row-sharded parameter becomes this rank's row range and the
    tables are read through `parallel.embedding`'s lookups
    (`hp.embedding_lookup` for the id models' embeddings, the
    owner-computes gather for every other table); under
    `hp.seq_parallel` every TextCNN splits its time axis over the model
    axis; and every random draw of a forward takes the global batch's
    draws and keeps this rank's rows. Build the optimizer after this.
    Idempotent."""
    if getattr(model, "mesh", None) is not None:
        return model
    from ..models.layers import TextCNN
    from .embedding import make_lookup, sharded_lookup
    n_model = mesh.shape[mesh.model_axis]
    m = mesh.index[mesh.model_axis]
    rows: Dict[str, int] = {}
    if n_model > 1:
        for name, p in list(model.named_parameters()):
            if param_spec(name, p) is None:
                continue
            mod, attr = _owner(model, name)
            rows[name] = p.shape[0]
            setattr(mod, attr, nn.Parameter(
                _shard_rows(p.detach(), n_model, m),
                requires_grad=p.requires_grad))
        model.row_lookup = functools.partial(sharded_lookup, mesh=mesh,
                                             axis=mesh.model_axis)
        model.embed_lookup = make_lookup(hp.embedding_lookup, mesh,
                                         mesh.model_axis)
    split: List[nn.Parameter] = []
    if hp.seq_parallel:
        for conv in model.modules():
            if isinstance(conv, TextCNN):
                conv.seq_mesh = mesh
                split += [conv.conv_kernel, conv.conv_bias]
    model.mesh = mesh
    model._mesh_rows = rows
    model._model_split = split
    n_data = mesh.shape[mesh.data_axis]
    model._data_shard = (mesh.index[mesh.data_axis], n_data)
    if n_data > 1:
        model.register_forward_pre_hook(_set_data_shard)
        model.register_forward_hook(_clear_data_shard, always_call=True)
    return model


def model_mesh(model: nn.Module) -> Optional[Mesh]:
    """The mesh a model was laid out on, or None."""
    return getattr(model, "mesh", None)


def _flat_all_reduce(mesh: Mesh, grads: List[torch.Tensor],
                     axis: str) -> None:
    """Sum `grads` over `axis` in place, one collective a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        flat = mesh.all_reduce(flat, axis)
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def reduce_grads(model: nn.Module) -> None:
    """Sum each gradient over the axes its contributions are split
    across: every parameter over the data axis (each data rank holds
    the gradient of its rows), and the conv of a sequence-parallel
    TextCNN over the model axis too (each model rank holds that of its
    windows). Replicated work needs no sum: the model ranks of a data
    row compute the same gradients, and a row-sharded table's owner
    holds its rows' whole gradient (the lookups' backward)."""
    mesh = model_mesh(model)
    if mesh is None:
        return
    if mesh.shape[mesh.data_axis] > 1:
        _flat_all_reduce(mesh, [p.grad for p in model.parameters()
                                if p.grad is not None], mesh.data_axis)
    if model._model_split and mesh.shape[mesh.model_axis] > 1:
        _flat_all_reduce(mesh, [p.grad for p in model._model_split
                                if p.grad is not None], mesh.model_axis)


def _gather_full(mesh: Mesh, t: torch.Tensor, rows: int) -> torch.Tensor:
    full = mesh.all_gather(t, mesh.model_axis)
    return full.reshape((-1,) + tuple(t.shape[1:]))[:rows].clone()


def full_params(model: nn.Module, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A `state_dict` of `model` with every row-sharded table gathered
    whole (for a checkpoint; a collective over the model axis, so every
    rank calls it)."""
    rows = getattr(model, "_mesh_rows", None)
    if not rows:
        return state
    return {k: (_gather_full(model.mesh, v, rows[k]) if k in rows else v)
            for k, v in state.items()}


def local_params(model: nn.Module, state: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The inverse of `full_params`: this rank's rows of each
    row-sharded table of a whole `state_dict`."""
    rows = getattr(model, "_mesh_rows", None)
    if not rows:
        return state
    mesh = model.mesh
    n, m = mesh.shape[mesh.model_axis], mesh.index[mesh.model_axis]
    return {k: (_shard_rows(v, n, m) if k in rows else v)
            for k, v in state.items()}


def _opt_names(model: nn.Module) -> List[str]:
    # the optimizer holds model.parameters() in this order
    return [name for name, _ in model.named_parameters()]


def _map_opt_state(model: nn.Module, opt_state: Dict, fn) -> Dict:
    rows = getattr(model, "_mesh_rows", None)
    if not rows or not opt_state:
        return opt_state
    names = _opt_names(model)
    state = {}
    for idx, entry in opt_state["state"].items():
        name = names[int(idx)]
        state[idx] = {k: (fn(v, rows[name]) if name in rows and torch.is_tensor(v)
                          and v.dim() > 0 else v)
                      for k, v in entry.items()}
    return {**opt_state, "state": state}


def full_opt_state(model: nn.Module, opt_state: Dict) -> Dict:
    """An optimizer `state_dict` with the moments of each row-sharded
    table gathered whole (a collective; every rank calls it)."""
    return _map_opt_state(model, opt_state,
                          lambda v, r: _gather_full(model.mesh, v, r))


def local_opt_state(model: nn.Module, opt_state: Dict) -> Dict:
    """The inverse of `full_opt_state`."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return opt_state
    n, m = mesh.shape[mesh.model_axis], mesh.index[mesh.model_axis]
    return _map_opt_state(model, opt_state,
                          lambda v, r: _shard_rows(v, n, m))


class ShardedRecords:
    """The example rows of a device cache split over the data axis: data
    rank d holds rows [d * per, (d + 1) * per) of every array (the last
    range padded with zero rows, never requested). `take(rows)` returns
    the arrays' rows at this rank's global row ids: every data rank's
    ids are all-gathered, each owner gathers the rows asked of it, and
    one all-to-all a key brings them back (the owner-computes exchange
    that GSPMD lowers the JAX package's sharded gather to)."""

    def __init__(self, arrays: Dict[str, torch.Tensor], mesh: Mesh):
        n, d = mesh.shape[mesh.data_axis], mesh.index[mesh.data_axis]
        self.mesh = mesh
        self.arrays = {k: _shard_rows(v, n, d) for k, v in arrays.items()}
        self.per = next(iter(self.arrays.values())).shape[0]

    def take(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        mesh, axis = self.mesh, self.mesh.data_axis
        rows = rows.long()
        if mesh.shape[axis] == 1:
            return {k: v.index_select(0, rows) for k, v in self.arrays.items()}
        d = mesh.index[axis]
        want = mesh.all_gather(rows, axis)                 # [n, b]
        local = (want - d * self.per).clamp(0, self.per - 1).reshape(-1)
        owner = torch.div(want[d], self.per, rounding_mode="floor")
        pos = torch.arange(rows.shape[0], device=rows.device)
        out = {}
        for k, v in self.arrays.items():
            part = v.index_select(0, local).reshape(
                tuple(want.shape) + tuple(v.shape[1:]))
            out[k] = mesh.all_to_all(part, axis)[owner, pos]
        return out


def shard_cache(cache, mesh: Mesh):
    """Row-shard a device cache (`train.loop.build_doc_cache`) over the
    data axis as `ShardedRecords`. An EntityCache shards its per-example
    arrays the same way and keeps its doc tables whole on every rank:
    they are entity-scaled, and a replicated table makes the second
    gather a local read."""
    from ..train.loop import EntityCache

    if isinstance(cache, EntityCache):
        return EntityCache(example=shard_cache(cache.example, mesh),
                           tables=cache.tables)
    return ShardedRecords(dict(cache), mesh)
