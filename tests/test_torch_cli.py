"""The port's training CLI, `python -m reviews4rec_torch`, on the CPU
(`--device cpu`), as tests/test_cli.py drives the JAX package's: end to
end, `--save_predictions`, a missing corpus, the flag types (every
`HyperParams` field, parsed as JAX's parser parses it), the refused
multi-host flags, and deepconn's metrics equal to `api.run`'s. Also
`serve.recommend` against the JAX package's on the same weights."""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.__main__ import build_parser, hp_from_args, main
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.serve import recommend
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu.__main__ import build_parser as jax_parser
from reviews4rec_tpu.__main__ import hp_from_args as jax_hp_from_args
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.serve import recommend as jax_recommend

torch.set_num_threads(1)
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data_root(dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    dataset.save(str(root / "synthetic" / "5_core"))
    return root


def _argv(data_root, tmp_path, *extra):
    return ["--dataset", "synthetic", "--data_root", str(data_root),
            "--log_dir", str(tmp_path / "logs"),
            "--model_dir", str(tmp_path / "models"), "--device", "cpu",
            *extra]


def test_cli_end_to_end(tmp_path, data_root, capsys):
    rc = main(_argv(data_root, tmp_path, "--model_type", "MF_dot",
                    "--epochs", "1", "--batch_size", "32",
                    "--latent_size", "8", "--json"))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    metrics = json.loads(out[-1])
    assert "MSE" in metrics and "HR@1" in metrics
    assert metrics["dataset"] == "synthetic"
    assert list((tmp_path / "models").glob("*.ckpt.pt"))


def test_cli_banner_without_json(tmp_path, data_root, capsys):
    rc = main(_argv(data_root, tmp_path, "--model_type", "bias_only",
                    "--epochs", "1"))
    assert rc == 0
    out = capsys.readouterr().out
    assert "FINAL (bias_only on synthetic): MSE = " in out
    assert "log: " in out and ".ckpt.pt" in out
    assert "end of epoch 1" in out


def test_cli_save_predictions(tmp_path, data_root, capsys):
    rc = main(_argv(data_root, tmp_path, "--model_type", "bias_only",
                    "--epochs", "1", "--batch_size", "32",
                    "--save_predictions", "--json"))
    assert rc == 0
    results = list((tmp_path / "logs").glob("*_results"))
    assert len(results) == 3  # train/test/val prediction artifacts
    for p in results:
        assert len(open(p).readline().split()) == 2
    err = capsys.readouterr().err
    assert "predictions[test]:" in err


def test_cli_save_predictions_neighbor_family(tmp_path, data_root, capsys):
    rc = main(_argv(data_root, tmp_path, "--model_type", "baseline",
                    "--surprise_epochs", "1", "--save_predictions",
                    "--json"))
    assert rc == 0
    assert "not supported for the 'neighbor' family" in \
        capsys.readouterr().err


def test_cli_missing_corpus(tmp_path, capsys):
    rc = main(["--model_type", "bias_only", "--dataset", "nope",
               "--data_root", str(tmp_path), "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "python -m reviews4rec_torch.data.preprocess" in err


def test_cli_flag_types():
    argv = ["--model_type", "NARRE", "--mesh_shape", "4,2",
            "--save_model", "false", "--eval_ks", "1,5,10",
            "--lr", "0.01", "--out_of_core", "yes", "--mesh_axes", "a,b",
            "--eval_num_negs", "99"]
    hp = hp_from_args(build_parser().parse_args(argv))
    assert hp.mesh_shape == (4, 2)
    assert hp.save_model is False and hp.out_of_core is True
    assert hp.eval_ks == (1, 5, 10)
    assert hp.lr == 0.01 and hp.eval_num_negs == 99
    assert hp.model_type == "NARRE" and hp.mesh_axes == ("a", "b")
    want = jax_hp_from_args(jax_parser().parse_args(argv))
    assert dataclasses.asdict(hp) == dataclasses.asdict(want)
    # one flag per field, as JAX's parser; the same model choices
    flags = {a.dest for a in build_parser()._actions}
    assert {f.name for f in dataclasses.fields(PortHP)} <= flags
    assert flags ^ {a.dest for a in jax_parser()._actions} == {"device"}
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--model_type", "nope"])


@pytest.mark.parametrize("flags,match", [
    (["--coordinator", "localhost:1234"],
     r"missing \['--num_processes', '--process_id'\]"),
    (["--num_processes", "2"], r"missing \['--coordinator', '--process_id'\]"),
    (["--process_id", "0"], r"missing \['--coordinator', '--num_processes'\]"),
    (["--coordinator", "localhost:1234", "--num_processes", "2",
      "--process_id", "2"], r"--process_id 2 must lie in \[0, "),
])
def test_cli_multihost_flags_raise(tmp_path, flags, match):
    """The multi-process flags reach `parallel.distributed.initialize`
    (tests/test_torch_parallel.py runs two processes through them): a
    partial set, or a rank outside the world, raises before any process
    group is brought up."""
    with pytest.raises(ValueError, match=match):
        main(["--model_type", "bias_only", "--data_root", str(tmp_path),
              "--device", "cpu"] + flags)


def test_cli_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--model_type", "bias_only", "--data_root", str(tmp_path)])


def test_cli_deepconn_metrics_equal_api_run(tmp_path, data_root, dataset,
                                            capsys):
    flags = ["--model_type", "deepconn", "--input_length", "64",
             "--epochs", "1", "--batch_size", "32", "--latent_size", "8",
             "--use_pallas", "true", "--scan_steps", "2"]
    assert main(_argv(data_root, tmp_path, *flags, "--json")) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    hp = hp_from_args(build_parser().parse_args(
        _argv(data_root, tmp_path / "api", *flags)))
    want, _, _ = port_api.run(hp, PortDataset.load(hp.data_dir()),
                              device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "train_examples_per_s":
            assert got[k] == v, k


def test_cli_module_runs(tmp_path, data_root):
    """`python -m reviews4rec_torch ... --device cpu` in a process of
    its own."""
    out = subprocess.run(
        [sys.executable, "-m", "reviews4rec_torch",
         *_argv(data_root, tmp_path, "--model_type", "bias_only",
                "--epochs", "1", "--json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "HR@1" in json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mt", ["MF_dot", "deepconn"])
def test_recommend_matches_jax(dataset, data_root, mt):
    """`serve.recommend` on JAX's init weights: the same top-k ids,
    scores within 1e-5, seen items excluded and not."""
    geom = dict(model_type=mt, input_length=64, latent_size=8,
                batch_size=32, dropout=0.0)
    jh = dataset.apply_to(JaxHP(**geom))
    pd = PortDataset.load(str(data_root / "synthetic" / "5_core"))
    ph = pd.apply_to(PortHP(**geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(5)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, pd.word_vectors, device="cpu")
    load_flax_params(tm, params)
    users = np.array([0, 3, 17, 39])
    for kw in (dict(k=5), dict(k=4, exclude_seen=False, item_chunk=7),
               dict(k=3, items=np.array([2, 9, 4, 28, 11]))):
        want_ids, want_s = jax_recommend(jh, dataset, users, params=params,
                                         model=jm, **kw)
        ids, scores = recommend(ph, pd, users, model=tm, device="cpu", **kw)
        assert np.array_equal(ids, np.asarray(want_ids)), kw
        np.testing.assert_allclose(scores, np.asarray(want_s), atol=1e-5,
                                   rtol=0)
