"""The port's meshes (`reviews4rec_torch/parallel/`) on gloo ranks on the
CPU, against the JAX package's `reviews4rec_tpu/parallel/` on its 8
virtual CPU devices and against the port's own single-device runs.

Each world size is spawned once a test session (`tests/_torch_mesh_worker.py`,
one process a rank, a `file://` rendezvous under the session's tmp path;
under xdist the first worker to need a world runs it and the others read
its results) and runs a list of cases; each case is its own test reading
the fixture's results.

- The lookups (`sharded_lookup`, `sharded_lookup_a2a` through
  `make_lookup`, "gspmd" on a model axis) on (2, 2) and (1, 4), flat and
  [B, C] ids with duplicates and every owner's rows: value and table
  gradient bitwise `table[ids]`'s and JAX's (the gradient is not scaled
  by the model-axis size).
- `textcnn_pool_seq` at windows 1, 3 and 5 on model axes of 2 and 4:
  value and kernel gradient within 1e-6 (relative and absolute) of
  JAX's and of the plain single-device op; the chunk-shorter-than-halo
  assertion; JAX's `ValueError`s word for word.
- One sharded step of MF_dot and deepconn on (2, 2) from JAX's init at
  dropout 0 against JAX's sharded step: loss 1e-5 relative, params 1e-5.
- `api.run` on a mesh against the port's single-device run at the
  default dropout (the masks are drawn at the global batch's shape),
  also under CE and BPR and for transnet++, NARRE and MPCN:
  MSE within 3e-4, HR@k equal, the same count-map keys, the same
  metrics on every rank; `scan_steps` 2 bitwise its per-step mesh run;
  HFT in float64; the checkpoint written whole by rank 0 alone.
- Two processes through the CLI's `--coordinator/--num_processes/
  --process_id`: both print the single-process metrics; only rank 0
  writes.
"""

import fcntl
import json
import os
import pickle
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.parallel import distributed
from reviews4rec_torch.parallel.embedding import make_lookup
from reviews4rec_torch.parallel.mesh import mesh_from_hp
from reviews4rec_torch.train import loop
from reviews4rec_torch.weights import params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.parallel import embedding as jax_embedding
from reviews4rec_tpu.parallel.mesh import make_mesh as jax_mesh
from reviews4rec_tpu.parallel.mesh import mesh_from_hp as jax_mesh_from_hp
from reviews4rec_tpu.parallel.mesh import shard_batch, shard_params
from reviews4rec_tpu.parallel.sequence import textcnn_pool_seq
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
STEP = dict(batch_size=16, input_length=64, latent_size=8, dropout=0.0)

LOOKUPS = [dict(mesh_shape=m, strategy=s, shape=shape)
           for m in ([2, 2], [1, 4])
           for s in ("psum", "a2a", "owner", "gspmd")
           for shape in ([24], [5, 6])]
SEQS = [dict(mesh_shape=m, window=w) for m in ([2, 2], [1, 4])
        for w in (1, 3, 5)]
RUNS4 = {
    "MF_dot_2x2": dict(mesh_shape=[2, 2], model_type="MF_dot", epochs=2,
                       batch_size=32),
    "deepconn_2x2": dict(mesh_shape=[2, 2], model_type="deepconn"),
    "psum_2x2": dict(mesh_shape=[2, 2], model_type="MF_dot", epochs=2,
                     batch_size=32, embedding_lookup="psum",
                     ref=dict(embedding_lookup="gspmd")),
    "a2a_2x2": dict(mesh_shape=[2, 2], model_type="MF_dot", epochs=2,
                    batch_size=32, embedding_lookup="a2a",
                    ref=dict(embedding_lookup="gspmd")),
}
RUNS2 = {
    "MF_dot_2x1": dict(mesh_shape=[2, 1], model_type="MF_dot", epochs=2,
                       batch_size=32),
    "seq_parallel_1x2": dict(mesh_shape=[1, 2], model_type="deepconn",
                             seq_parallel=True,
                             ref=dict(seq_parallel=False)),
    "doc_cache_2x1": dict(mesh_shape=[2, 1], model_type="deepconn++",
                          cache_doc_embeds=True),
    "entity_cache_2x1": dict(mesh_shape=[2, 1], model_type="deepconn++",
                             cache_doc_embeds=True, cache_entity=True,
                             pallas_fuse_rows=True),
    # the ranking losses' normalisers over the data axis
    "MF_dot_CE_2x1": dict(mesh_shape=[2, 1], model_type="MF_dot", loss="CE",
                          epochs=2, batch_size=32),
    "MF_dot_BPR_2x1": dict(mesh_shape=[2, 1], model_type="MF_dot",
                           loss="BPR", epochs=2, batch_size=32),
    # transnet's transform loss (normalised and, in eval, summed over the
    # data axis), NARRE's per-review towers, MPCN's Gumbel draws
    "transnet++_2x1": dict(mesh_shape=[2, 1], model_type="transnet++"),
    "NARRE_2x1": dict(mesh_shape=[2, 1], model_type="NARRE"),
    "MPCN_2x1": dict(mesh_shape=[2, 1], model_type="MPCN", mpcn_dmax=4,
                     mpcn_smax=8),
}
SCANS = {"MF_dot": dict(model_type="MF_dot"),
         "entity_deepconn++": dict(model_type="deepconn++",
                                   cache_doc_embeds=True, cache_entity=True)}


def _once(tmp_path_factory, name, make):
    """`make(dir)`'s result, made once a test session: the xdist workers
    share the session's tmp root, and a lock file lets one of them make
    it while the others wait, then read it."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / f"torch_mesh_{name}"
    out.mkdir(exist_ok=True)
    done = out / "results.pkl"
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            result = make(out / "work")
            with open(out / "partial.pkl", "wb") as f:
                pickle.dump(result, f)
            os.replace(out / "partial.pkl", done)
    with open(done, "rb") as f:
        return pickle.load(f)


def _launch(world, cases, tmp):
    """Run `cases` on a gloo world of `world` CPU ranks; every rank's
    results, in rank order."""
    tmp.mkdir(parents=True, exist_ok=True)
    cases_file = tmp / "cases.json"
    cases_file.write_text(json.dumps(cases))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / "rendezvous"), str(world),
         str(rank), str(cases_file), str(tmp)],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    with open(tmp / "results.pkl", "rb") as f:
        return pickle.load(f)


def _jax_hp(dataset, mt, **kw):
    return dataset.apply_to(JaxHP(model_type=mt, **{**STEP, **kw}))


@pytest.fixture(scope="module")
def step_refs(dataset, tmp_path_factory):
    """JAX's init params (bridged to the port's names), one batch, and
    JAX's sharded step on (2, 2) from them, for MF_dot and deepconn."""
    return _once(tmp_path_factory, "step",
                 lambda tmp: _step_refs(dataset, tmp))


def _step_refs(dataset, tmp):
    tmp.mkdir(parents=True, exist_ok=True)
    refs = {}
    for mt in ("MF_dot", "deepconn"):
        hp = _jax_hp(dataset, mt)
        model = jax_build(hp, dataset.word_vectors)
        batch = next(iter(Batcher(dataset.materialize(hp, "train"),
                                  hp.batch_size)))
        rng = jax.random.PRNGKey(0)
        params = model.init({"params": rng, "dropout": rng}, batch,
                            train=False)["params"]
        torch.save(params_from_flax(params), tmp / f"{mt}.pt")
        np.savez(tmp / f"{mt}.npz", **batch)
        optimizer = jax_loop.make_optimizer(hp)
        step = jax_loop.make_train_step(make_apply_fn(model), optimizer, mt)
        mesh = jax_mesh((2, 2))
        with jax.set_mesh(mesh):
            p = shard_params(params, mesh)
            st = jax_loop.TrainState(p, optimizer.init(p),
                                     jnp.zeros((), jnp.int32))
            out, m = step(st, shard_batch(batch, mesh), jax.random.PRNGKey(1))
        refs[mt] = {"loss": float(m["loss"]),
                    "params": {k: v.numpy() for k, v in
                               params_from_flax(out.params).items()},
                    "files": (str(tmp / f"{mt}.pt"), str(tmp / f"{mt}.npz"))}
    return refs


@pytest.fixture(scope="module")
def world4(step_refs, tmp_path_factory):
    cases = [dict(name=f"lookup{j}", kind="lookup", **c)
             for j, c in enumerate(LOOKUPS)]
    cases += [dict(name=f"seq{j}", kind="seq", **c)
              for j, c in enumerate(SEQS)]
    cases.append(dict(name="short_chunk", kind="seq", mesh_shape=[1, 4],
                      window=5, t=8))
    cases += [dict(name=f"step_{mt}", kind="step", mesh_shape=[2, 2],
                   model_type=mt, params_file=r["files"][0],
                   batch_file=r["files"][1]) for mt, r in step_refs.items()]
    cases += [dict(name=name, kind="run", **c) for name, c in RUNS4.items()]

    def make(tmp):
        cases.append(dict(name="checkpoint", kind="run", mesh_shape=[2, 2],
                          model_type="MF_dot", batch_size=32,
                          save_model=True, ref=False,
                          log_dir=str(tmp / "out")))
        cases.append(dict(name="resume", kind="resume", mesh_shape=[2, 2],
                          model_type="MF_dot", batch_size=32,
                          log_dir=str(tmp / "resume")))
        return _launch(4, cases, tmp)

    return _once(tmp_path_factory, "world4", make)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [dict(name=name, kind="run", **c) for name, c in RUNS2.items()]
    cases += [dict(name=f"scan_{name}", kind="scan", mesh_shape=[2, 1], **c)
              for name, c in SCANS.items()]
    cases.append(dict(name="hft", kind="hft", mesh_shape=[2, 1],
                      latent_size=4, hft_em_iters=3, hft_grad_iters=5,
                      batch_size=32))
    return _once(tmp_path_factory, "world2",
                 lambda tmp: _launch(2, cases, tmp))


# ---------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------
def _jax_lookup(case):
    """JAX's value and table gradient for a lookup case (same inputs as
    the worker's)."""
    mesh = jax_mesh(tuple(case["mesh_shape"]))
    rows, dim, shape = 64, 16, tuple(case["shape"])
    rng = np.random.default_rng(2)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, size=shape).reshape(-1)
    ids[:8] = [0, 0, 63, 63, 17, 17, 5, 5]
    ids = jnp.asarray(ids.reshape(shape).astype(np.int32))
    w = jnp.asarray(rng.normal(size=shape + (dim,)).astype(np.float32))
    sharded = jax.device_put(jnp.asarray(table),
                             NamedSharding(mesh, P("model", None)))
    if case["strategy"] == "owner":
        lk = lambda t, i: jax_embedding.sharded_lookup(t, i, mesh)
    else:
        lk = jax_embedding.make_lookup(case["strategy"], mesh)
    value, grad = jax.jit(lambda t: (lk(t, ids), jax.grad(
        lambda u: jnp.sum(lk(u, ids) * w))(t)))(sharded)
    return np.asarray(value), np.asarray(grad)


@pytest.mark.parametrize("j", range(len(LOOKUPS)),
                         ids=[f"{c['strategy']}-{c['mesh_shape']}-"
                              f"{c['shape']}" for c in LOOKUPS])
def test_lookup_bitwise_gather_and_jax(world4, j):
    got = world4[0][f"lookup{j}"]
    assert got["value_equal"] and got["grad_equal"]
    for rank in world4[1:]:
        assert np.array_equal(rank[f"lookup{j}"]["value"], got["value"])
        assert np.array_equal(rank[f"lookup{j}"]["grad"], got["grad"])
    value, grad = _jax_lookup(LOOKUPS[j])
    assert np.array_equal(got["value"], value)
    assert np.array_equal(got["grad"], grad)


def _jax_seq(case, t=64):
    mesh = jax_mesh((1, case["mesh_shape"][1]))
    w, b, e, f = case["window"], 4, 8, 12
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(b, t, e)), jnp.float32)
    kernel = jnp.asarray(rng.normal(size=(w * e, f)), jnp.float32)
    bias = jnp.asarray(rng.normal(size=(f,)), jnp.float32)
    value, dk = jax.jit(lambda k: (textcnn_pool_seq(x, k, bias, w, mesh),
                                   jax.grad(lambda u: jnp.sum(textcnn_pool_seq(
                                       x, u, bias, w, mesh) ** 2))(k)))(kernel)
    return np.asarray(value), np.asarray(dk)


@pytest.mark.parametrize("j", range(len(SEQS)),
                         ids=[f"w{c['window']}-m{c['mesh_shape'][1]}"
                              for c in SEQS])
def test_seq_matches_jax_and_plain(world4, j):
    got = world4[0][f"seq{j}"]
    value, dk = _jax_seq(SEQS[j])

    def close(a, b):
        # 1e-6 relative to each element and to the tensor's largest: a
        # gradient element that sums terms of opposite sign (to a value
        # far below its terms) keeps their f32 rounding
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))

    close(got["value"], value)
    close(got["dk"], dk)
    close(got["value"], got["plain_value"])
    close(got["dk"], got["plain_dk"])
    # the halo's backward returns each halo row's gradient to its owner
    close(got["db"], got["plain_db"])
    close(got["dx"], got["plain_dx"])


def test_seq_chunk_shorter_than_halo(world4):
    mesh = jax_mesh((1, 4))
    x = jnp.zeros((2, 8, 3))
    with pytest.raises(AssertionError) as jax_err:
        textcnn_pool_seq(x, jnp.zeros((15, 4)), jnp.zeros(4), 5, mesh)
    for rank in world4:
        assert rank["short_chunk"] == {"error": str(jax_err.value)}


@pytest.mark.parametrize("strategy,shape", [
    ("psum", None), ("a2a", {"data": 8, "model": 1}),
    ("bogus", {"data": 2, "model": 4})])
def test_lookup_errors_are_jax_s(strategy, shape):
    want_mesh = None if shape is None else jax_mesh(tuple(shape.values()))
    with pytest.raises(ValueError) as want:
        jax_embedding.make_lookup(strategy, want_mesh)
    mesh = None if shape is None else types.SimpleNamespace(
        shape=dict(shape), index={"data": 0, "model": 0})
    with pytest.raises(ValueError) as got:
        make_lookup(strategy, mesh)
    assert str(got.value) == str(want.value)


def test_mesh_from_hp_errors():
    """None at one device; JAX's batch-size error word for word; without
    a process group of the mesh's size, an error naming `initialize`."""
    assert mesh_from_hp(PortHP()) is None
    with pytest.raises(ValueError) as want:
        jax_mesh_from_hp(JaxHP(mesh_shape=(8, 1), batch_size=12))
    with pytest.raises(ValueError) as got:
        mesh_from_hp(PortHP(mesh_shape=(8, 1), batch_size=12))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"parallel\.distributed\."
                       r"initialize.*--coordinator/--num_processes"):
        mesh_from_hp(PortHP(mesh_shape=(2, 2), batch_size=16))


def test_initialize_without_flags_is_a_no_op():
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()


def test_per_example_cache_across_hosts_is_jax_s_refusal(monkeypatch):
    """JAX refuses the per-example cache on a multi-process mesh; the
    port refuses it on a mesh spanning hosts (one host's ranks shard it),
    in JAX's words."""
    monkeypatch.setattr(loop, "host_count", lambda: 2)
    hp = PortHP(model_type="deepconn", cache_doc_embeds=True)
    with pytest.raises(ValueError, match="^per-example cache_doc_embeds "
                       r"\+ multi-host is unsupported \(one global device "
                       r"array per split\); use cache_entity=True \(entity "
                       r"tables replicate per host\) or drop the cache$"):
        loop._cache_mode(hp, mesh=object())
    loop._cache_mode(hp.replace(cache_entity=True), mesh=object())


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------
@pytest.mark.parametrize("mt", ["MF_dot", "deepconn"])
def test_sharded_step_matches_jax(world4, step_refs, mt):
    want = step_refs[mt]
    for rank in world4:
        got = rank[f"step_{mt}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["params"]) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                       rtol=0, err_msg=k)


def _metrics(m):
    return {k: v for k, v in m.items() if k != "train_examples_per_s"}


def _check_run(results, name):
    got, want = results[0][name]["mesh"], results[0][name]["single"]
    for rank in results[1:]:
        assert _metrics(rank[name]["mesh"]["metrics"]) == \
            _metrics(got["metrics"])
    g, w = got["metrics"], want["metrics"]
    assert set(g) == set(w)
    assert np.isclose(g["MSE"], w["MSE"], atol=3e-4)
    for k in w:
        if k.startswith(("HR@", "NDCG@")) or k == "dataset":
            assert g[k] == w[k], k
    assert set(got["ucm"]) == set(want["ucm"])
    assert got["icm_keys"] == want["icm_keys"]
    for c in want["ucm"]:
        np.testing.assert_allclose(got["ucm"][c], want["ucm"][c],
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", list(RUNS4))
def test_api_run_on_2x2_matches_single_device(world4, name):
    _check_run(world4, name)


@pytest.mark.parametrize("name", list(RUNS2))
def test_api_run_on_two_ranks_matches_single_device(world2, name):
    _check_run(world2, name)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_steps_on_mesh_is_bitwise_per_step(world2, name):
    for rank in world2:
        got = rank[f"scan_{name}"]
        assert got[2]["mse"] == got[1]["mse"]
        for k, v in got[1]["params"].items():
            assert np.array_equal(got[2]["params"][k], v), k


def test_hft_on_mesh_matches_single_device(world2):
    got = world2[0]["hft"]
    assert np.isclose(got["mesh"]["MSE"], got["single"]["MSE"], atol=3e-4)
    assert got["mesh"]["HR@1"] == got["single"]["HR@1"]
    assert got["ucm_keys"][0] == got["ucm_keys"][1]
    assert world2[1]["hft"]["mesh"] == got["mesh"]


def test_checkpoint_is_whole_and_written_by_rank_zero(world4, dataset):
    hp = dataset.apply_to(JaxHP(model_type="MF_dot"))
    got = [rank["checkpoint"] for rank in world4]
    assert got[0]["files"] and not any(r["files"] for r in got[1:])
    shapes = got[0]["saved_shapes"]
    assert shapes["user_embedding"] == (hp.num_user_rows, 8)
    assert shapes["item_bias"] == (hp.num_item_rows,)


def test_resume_on_mesh_is_bitwise_an_uninterrupted_run(world4):
    """The checkpoint holds whole tables and Adam moments; each rank
    takes its rows of them back, so 1 epoch + a resumed second equal 2
    epochs bit for bit."""
    for rank in world4:
        got = rank["resume"]
        assert got["resumed"]["mse"] == got["whole"]["mse"]
        for k, v in got["whole"]["params"].items():
            assert np.array_equal(got["resumed"]["params"][k], v), k


# ---------------------------------------------------------------------
# two processes through the CLI
# ---------------------------------------------------------------------
CLI_RUNS = {
    "MF_dot": ["--model_type", "MF_dot", "--epochs", "2", "--batch_size",
               "32", "--latent_size", "8", "--save_predictions"],
    "entity_deepconn++": ["--model_type", "deepconn++", "--epochs", "1",
                          "--batch_size", "32", "--latent_size", "8",
                          "--input_length", "64", "--cache_doc_embeds",
                          "true", "--cache_entity", "true",
                          "--save_model", "false"],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_runs(dataset, tmp_path_factory):
    """Each CLI_RUNS entry as two processes over localhost on a (2, 1)
    mesh (per-rank log and model dirs) and as one process."""
    return _once(tmp_path_factory, "cli", lambda root: _cli_runs(dataset,
                                                                 root))


def _cli_runs(dataset, root):
    root.mkdir(parents=True, exist_ok=True)
    dataset.save(str(root / "data" / "synthetic" / "5_core"))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}

    def argv(name, tag, flags):
        out = root / name / tag
        return [sys.executable, "-m", "reviews4rec_torch", "--dataset",
                "synthetic", "--data_root", str(root / "data"), "--log_dir",
                str(out / "logs"), "--model_dir", str(out / "models"),
                "--device", "cpu", "--json", *flags]

    procs = {}
    for name, flags in CLI_RUNS.items():
        port = _free_port()
        for rank in (0, 1):
            procs[name, rank] = subprocess.Popen(
                argv(name, f"rank{rank}", flags + [
                    "--mesh_shape", "2,1", "--coordinator",
                    f"localhost:{port}", "--num_processes", "2",
                    "--process_id", str(rank)]),
                cwd=str(root), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        procs[name, "single"] = subprocess.Popen(
            argv(name, "single", flags), cwd=str(root), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, f"{key} failed:\n{stdout}\n{stderr}"
            tag = "single" if key[1] == "single" else f"rank{key[1]}"
            out[key] = {"stdout": stdout,
                        "metrics": json.loads(stdout.strip().splitlines()[-1]),
                        "files": _files(root / key[0] / tag)}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def _files(path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*")
                  if p.is_file()) if path.exists() else []


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_two_processes_match_one(cli_runs, name):
    r0, r1 = cli_runs[name, 0], cli_runs[name, 1]
    single = cli_runs[name, "single"]
    assert _metrics(r0["metrics"]) == _metrics(r1["metrics"])
    g, w = r0["metrics"], single["metrics"]
    assert set(g) == set(w)
    assert np.isclose(g["MSE"], w["MSE"], atol=3e-4)
    assert g["HR@1"] == w["HR@1"] and g["HR@10"] == w["HR@10"]
    # only rank 0 prints beyond its metrics line, and only it writes
    assert r1["stdout"].strip().splitlines() == [
        json.dumps(r1["metrics"])]
    assert r0["files"] == single["files"]
    assert r0["files"] and not r1["files"]
