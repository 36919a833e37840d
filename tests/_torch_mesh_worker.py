"""One rank of the port's mesh tests (tests/test_torch_parallel.py): a
process of a `torch.distributed` gloo world on the CPU that runs a list
of cases and, on rank 0, pickles their results for the parent. Imports
the port only (no JAX); inputs made from numpy seeds, or read from the
files the parent wrote.

Usage: python tests/_torch_mesh_worker.py <init_file> <world> <rank>
       <cases.json> <out_dir>
"""

import json
import os
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)
CPU = torch.device("cpu")
# the conftest corpus and the port tests' small geometry
CORPUS = dict(num_users=40, num_items=30, vocab=120, seed=0)
GEOM = dict(batch_size=16, epochs=1, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16, save_model=False)


def _dataset():
    from reviews4rec_torch.data.synthetic import make_synthetic
    if "ds" not in _cache:
        _cache["ds"] = make_synthetic(**CORPUS)
    return _cache["ds"]


_cache = {}


def _hp(**kw):
    from reviews4rec_torch.config import HyperParams
    return _dataset().apply_to(HyperParams(**{**GEOM, **kw}))


def _full_grad(mesh, local, rows):
    """A row-sharded table's gradient gathered whole."""
    from reviews4rec_torch.parallel.mesh import _gather_full
    return _gather_full(mesh, local, rows).numpy()


def case_lookup(mesh_shape, strategy, shape, seed=2):
    """A lookup strategy's value and table gradient on a (data, model)
    mesh, against `table[ids]` (the same ids on every rank: duplicates
    and every owner's rows)."""
    from reviews4rec_torch.parallel.embedding import (make_lookup,
                                                      sharded_lookup)
    from reviews4rec_torch.parallel.mesh import _shard_rows, make_mesh
    mesh = make_mesh(tuple(mesh_shape))
    rows, dim = 64, 16
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(rows, dim)).astype(np.float32))
    ids = rng.integers(0, rows, size=shape).reshape(-1)
    ids[:8] = [0, 0, 63, 63, 17, 17, 5, 5]
    ids = torch.from_numpy(ids.reshape(shape).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=tuple(shape) + (dim,))
                         .astype(np.float32))
    n, m = mesh.shape["model"], mesh.index["model"]
    local = _shard_rows(table, n, m).requires_grad_(True)
    lk = (lambda t, i: sharded_lookup(t, i, mesh)) if strategy == "owner" \
        else make_lookup(strategy, mesh)
    out = lk(local, ids)
    (out * w).sum().backward()
    ref = table.clone().requires_grad_(True)
    want = ref[ids.long()]
    (want * w).sum().backward()
    grad = _full_grad(mesh, local.grad, rows)
    return {"value": out.detach().numpy(), "grad": grad,
            "value_equal": bool(torch.equal(out.detach(), want.detach())),
            "grad_equal": bool(np.array_equal(grad, ref.grad.numpy()))}


def case_seq(mesh_shape, window, b=4, t=64, e=8, f=12, seed=0):
    """textcnn_pool_seq's value, kernel and x gradients (summed over the
    mesh as the trainer sums them) against the plain single-device op."""
    from reviews4rec_torch.ops.textcnn import textcnn_pool
    from reviews4rec_torch.parallel.mesh import make_mesh
    from reviews4rec_torch.parallel.sequence import textcnn_pool_seq
    mesh = make_mesh(tuple(mesh_shape))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, e)).astype(np.float32))
    kernel = torch.from_numpy(rng.normal(size=(window * e, f))
                              .astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(f,)).astype(np.float32))
    n, m = mesh.shape["model"], mesh.index["model"]
    c = t // n
    try:
        xs = x[:, m * c:(m + 1) * c].clone().requires_grad_(True)
        k = kernel.clone().requires_grad_(True)
        bb = bias.clone().requires_grad_(True)
        y = textcnn_pool_seq(xs, k, bb, window, mesh)
    except AssertionError as exc:
        return {"error": str(exc)}
    (y ** 2).sum().backward()
    dk = mesh.all_reduce(k.grad, "model")
    db = mesh.all_reduce(bb.grad, "model")
    dx = mesh.all_gather(xs.grad, "model")        # [n, b, c, e]
    dx = dx.permute(1, 0, 2, 3).reshape(b, t, e)
    xr = x.clone().requires_grad_(True)
    kr = kernel.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    yr, _ = textcnn_pool(xr, kr, br, window)
    (yr ** 2).sum().backward()
    return {"value": y.detach().numpy(), "dk": dk.numpy(), "db": db.numpy(),
            "dx": dx.numpy(), "plain_value": yr.detach().numpy(),
            "plain_dk": kr.grad.numpy(), "plain_db": br.grad.numpy(),
            "plain_dx": xr.grad.numpy()}


def case_step(mesh_shape, model_type, params_file, batch_file):
    """One sharded train step from the parent's params and batch (the
    JAX package's init, bridged), at dropout 0: the batch loss and the
    updated params, whole."""
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.parallel.mesh import (full_params, host_slice,
                                                 make_mesh, shard_model)
    from reviews4rec_torch.train import loop
    hp = _hp(model_type=model_type, dropout=0.0,
             mesh_shape=tuple(mesh_shape))
    model = build_model(hp, _dataset().word_vectors, device=CPU)
    model.load_state_dict(torch.load(params_file))
    mesh = make_mesh(tuple(mesh_shape))
    shard_model(model, hp, mesh)
    opt = loop.make_optimizer(hp, model)
    batch = dict(np.load(batch_file))
    model.train()
    placed = {k: torch.from_numpy(v) for k, v in
              host_slice(batch, mesh).items()}
    loss, _, _ = loop.train_step(model, opt, placed)
    loss = mesh.all_reduce(loss, "data")
    params = full_params(model, model.state_dict())
    return {"loss": float(loss),
            "params": {k: v.numpy() for k, v in params.items()}}


def _run(hp, device=CPU):
    from reviews4rec_torch.api import run
    metrics, ucm, icm = run(hp, _dataset(), device=device)
    return {"metrics": metrics, "ucm": {k: sorted(v) for k, v in ucm.items()},
            "icm_keys": sorted(icm)}


def case_run(mesh_shape, ref=None, log_dir=None, **kw):
    """api.run on the mesh, and (unless `ref` is False) the port's own
    single-device run of `ref`'s options (default the same ones)."""
    hp = _hp(**kw)
    if log_dir:
        rank = torch.distributed.get_rank()
        hp = hp.replace(log_dir=os.path.join(log_dir, f"rank{rank}"),
                        model_dir=os.path.join(log_dir, f"rank{rank}"))
    out = {"mesh": _run(hp.replace(mesh_shape=tuple(mesh_shape)))}
    if ref is not False:
        out["single"] = _run(hp.replace(**(ref or {})))
    if log_dir:
        from reviews4rec_torch.train.checkpoint import checkpoint_path
        path = checkpoint_path(hp)
        out["files"] = sorted(os.listdir(os.path.dirname(path))) \
            if os.path.isdir(os.path.dirname(path)) else []
        if os.path.exists(path):
            state = torch.load(path, weights_only=True)["params"]
            out["saved_shapes"] = {k: tuple(v.shape) for k, v in state.items()}
    return out


def case_scan(mesh_shape, model_type, **kw):
    """train_complete at scan_steps 2 against scan_steps 1 on the same
    mesh: the best params (whole) and the val MSE."""
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.parallel.mesh import full_params
    from reviews4rec_torch.train.loop import train_complete
    out = {}
    for s in (1, 2):
        hp = _hp(model_type=model_type, mesh_shape=tuple(mesh_shape),
                 scan_steps=s, epochs=2, **kw)
        model = build_model(hp, _dataset().word_vectors, device=CPU)
        best, mse = train_complete(hp, model, _dataset())
        out[s] = {"mse": mse, "params": {k: v.numpy() for k, v in
                                         full_params(model, best).items()}}
    return out


def case_resume(mesh_shape, log_dir, **kw):
    """train_complete 2 epochs with a checkpoint, against 1 epoch and a
    resumed second (whole tables and Adam state through the file): the
    best params (whole) and the val MSE of each."""
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.parallel.mesh import full_params
    from reviews4rec_torch.train.checkpoint import checkpoint_path
    from reviews4rec_torch.train.loop import train_complete
    out = {}
    for tag, runs in (("whole", [dict(epochs=2)]),
                      ("resumed", [dict(epochs=1),
                                   dict(epochs=2, resume=True)])):
        where = os.path.join(log_dir, tag)
        for run in runs:
            hp = _hp(mesh_shape=tuple(mesh_shape), save_model=True,
                     log_dir=where, model_dir=where, **kw).replace(**run)
            model = build_model(hp, _dataset().word_vectors, device=CPU)
            best, mse = train_complete(hp, model, _dataset(),
                                       checkpoint_path=checkpoint_path(hp))
        out[tag] = {"mse": mse, "params": {k: v.numpy() for k, v in
                                           full_params(model, best).items()}}
    return out


def case_hft(mesh_shape, **kw):
    """run_hft on the mesh and on one device, in float64."""
    from reviews4rec_torch.models.hft import run_hft
    hp = _hp(model_type="HFT", **kw)
    got = run_hft(hp.replace(mesh_shape=tuple(mesh_shape)), _dataset(),
                  device=CPU, dtype=torch.float64)
    want = run_hft(hp, _dataset(), device=CPU, dtype=torch.float64)
    return {"mesh": got[0], "single": want[0],
            "ucm_keys": (sorted(got[1]), sorted(want[1]))}


CASES = {"lookup": case_lookup, "seq": case_seq, "step": case_step,
         "run": case_run, "scan": case_scan, "resume": case_resume,
         "hft": case_hft}


def main() -> None:
    init_file, world, rank, cases_file, out_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    from reviews4rec_torch.parallel import distributed
    assert distributed.initialize(f"file://{init_file}", world, rank,
                                  device="cpu")
    assert distributed.is_primary() == (rank == 0)
    with open(cases_file) as f:
        cases = json.load(f)
    results = {}
    for case in cases:
        kw = dict(case)
        name, kind = kw.pop("name"), kw.pop("kind")
        try:
            results[name] = CASES[kind](**kw)
        except Exception:
            results[name] = {"exception": traceback.format_exc()}
            raise
    every = [None] * world
    torch.distributed.all_gather_object(every, results)
    if rank == 0:
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            pickle.dump(every, f)
    distributed.shutdown()


if __name__ == "__main__":
    main()
