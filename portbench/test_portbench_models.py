"""The harness's model files (`portbench/models/<model>.py`): every
configuration finds its file; the check's numbers and the counts are
the ones the harness gave before its model-specific code moved into
those files (recorded from that tree at these sizes, on the CPU at one
thread, as `float.hex`); a new model is taken from a new file alone;
ranking's forward bound counts the towers a call requires; NARRE's
ranking scores are its forward on each pair; and a model without a
file, or a ranking cell on a model without ranking scores, fails at
set-up and says what it missed."""

import math
import shutil

import numpy as np
import pytest
import torch

from portbench import corpus, counts, drivers, models, run, weights
from portbench.conftest import SEED, shrink, with_held_out
from portbench.reference import Reference, rows_doc
from reviews4rec_torch.train import profiler

CPU = torch.device("cpu")

# run.check_numbers at the shrunk cells and SEED, a window of one unit
# (so that the call a rank run samples is the same on any CPU): (the
# program's, the control's)
BEFORE = {
    "deepconn.train": (
        {"loss_gap": "0x1.82e529db39a12p-23",
         "moment_gap": "0x1.95fb3c0b914efp-22",
         "moment_median_gap": "0x1.c0b2e98af0beep-24",
         "update_gap": "0x1.000034952baaap-17",
         "update_median_gap": "0x1.b21921f2b17eap-24"},
        {"loss_gap": "0x1.197f0a59e8d87p-12",
         "moment_gap": "0x1.e858ca0b62779p-10",
         "moment_median_gap": "0x1.6b617fa2d0f58p-11",
         "update_gap": "0x1.5e398fb9f65a8p-11",
         "update_median_gap": "0x1.e640097c626bap-14"}),
    "deepconn.rank": (
        {"score_gap": "0x1.3bb6357400000p-21", "rank_metric_gap": "0x0.0p+0"},
        {"score_gap": "0x1.cd5978f260000p-12",
         "rank_metric_gap": "0x0.0p+0"}),
    "narre.train": (
        {"loss_gap": "0x1.c1040c6d41efdp-25",
         "moment_gap": "0x1.ec3288769eca7p-22",
         "moment_median_gap": "0x1.b7046cf57849ap-24",
         "update_gap": "0x1.2ab35c6da0ccbp-19",
         "update_median_gap": "0x1.b764af8d26c20p-25"},
        {"loss_gap": "0x1.9faa3bcbd6105p-18",
         "moment_gap": "0x1.7f55447421159p-10",
         "moment_median_gap": "0x1.0b180728abf7bp-12",
         "update_gap": "0x1.cb38e46396926p-11",
         "update_median_gap": "0x1.7642ecf0f056ap-15"}),
}
# at full size: train_flop_per_example, rank_flop(256 users, 9,700
# items, 25,600 pairs), a training step's forward bound
COUNTS = {
    "deepconn-videogames5": (77044743.0, 383114513960.0,
                             "0x1.4dda09d378c88p-15"),
    "narre-videogames5": (79252383.0, 390393805200.0,
                          "0x1.53d95b3f829e2p-15"),
}
# drivers.Train's step forward bound at the shrunk cells
STEP_BOUND = {"deepconn.train": "0x1.c37a095f6e33bp-23",
              "narre.train": "0x1.13d39f124deeap-21"}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(bench, name):
    conf = next(c for c in bench["configs"] if c["name"] == name)
    return run.load_json(run.ROOT, conf["file"])


def _numbers(bench, cell, monkeypatch, cut=shrink):
    """The run's result and every number `run.check_numbers` gave it
    (the program's, then the control's), as `float.hex`."""
    got, check_numbers = [], run.check_numbers

    def recorded(*a, **kw):
        out = check_numbers(*a, **kw)
        got.append({k: float(v).hex() for k, v in out.items()})
        return out

    monkeypatch.setattr(run, "check_numbers", recorded)
    result = run.run_cell(bench, cell, SEED, 0.0, False, CPU, 0.0,
                          control=True, shrink=cut, log=lambda *a, **k: None)
    return result, tuple(got)


def _session(bench, cell):
    _, cfg, traffic, _ = run.cell_files(bench, cell)
    shrink(cfg, traffic)
    data = corpus.generate(cfg, SEED, CPU)
    w = weights.make(cfg, data.num_users, data.num_items, SEED, CPU)
    return cfg, traffic, data, w


@pytest.mark.parametrize("name", [c["name"] for c in with_held_out(
    run.load_json(run.ROOT, "BENCHMARK.json"))["configs"]])
def test_each_configuration_finds_its_model_file(bench_all, name):
    cfg = _config(bench_all, name)
    entries = {run.load_json(run.HERE, "traffic", w["traffic"] + ".json")
               ["entry"] for w in bench_all["workloads"]
               if w["config"] == name}
    needs = sum((drivers.ENTRIES[e].needs for e in sorted(entries)), ())
    mod = models.load(cfg["model"], needs)
    assert mod.__file__ == models.path(cfg["model"])
    assert models.path(cfg["model"]).endswith(f"/{cfg['model']}.py")
    assert isinstance(mod.LEFT_OUT, set)
    assert all(callable(getattr(mod, n)) for n in models.REQUIRED + needs
               if n != "LEFT_OUT")


def test_a_model_name_outside_the_file_characters_is_written_with_underscores():
    assert models.path("transnet++").endswith("/transnet__.py")
    assert models.path("deepconn").endswith("/deepconn.py")


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_check_numbers_are_bitwise_the_parent_trees(bench, cell, monkeypatch,
                                                    one_thread):
    result, got = _numbers(bench, cell, monkeypatch)
    assert result["correct"] is True
    assert got == BEFORE[cell]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_the_parent_trees(bench_all, name):
    cfg = _config(bench_all, name)
    flop, rank, step = COUNTS[name]
    assert counts.train_flop_per_example(cfg) == flop
    assert counts.rank_flop(cfg, 256, 9700, 25600) == rank
    assert (2 * counts.towers_fwd_bound_s(cfg, cfg["hp"]["batch_size"])
            == float.fromhex(step))


@pytest.mark.parametrize("cell", sorted(STEP_BOUND))
def test_train_step_bound_is_the_parent_trees(bench, cell):
    session = drivers.Train(*_session(bench, cell), SEED, CPU)
    assert session.step_fwd_bound_s == float.fromhex(STEP_BOUND[cell])


def test_a_new_model_is_taken_from_a_new_file_alone(bench, tmp_path,
                                                    monkeypatch, one_thread):
    shutil.copy(models.path("deepconn"), tmp_path / "deepconn_copy.py")
    monkeypatch.setattr(models, "DIR", str(tmp_path))

    def as_copy(cfg, traffic):
        cfg["model"] = "deepconn_copy"
        shrink(cfg, traffic)

    result, got = _numbers(bench, "deepconn.train", monkeypatch, as_copy)
    assert models.load("deepconn_copy").__file__ == str(
        tmp_path / "deepconn_copy.py")
    assert result["correct"] is True
    assert got == BEFORE["deepconn.train"]


def test_rank_bound_counts_the_towers_a_call_requires(bench, monkeypatch):
    session = drivers.Rank(*_session(bench, "deepconn.rank"), SEED, CPU)
    try:
        cfg, gb = session.cfg, session.traffic["grid_batch"]
        for bytes_s in (counts.HBM_BYTES_S, math.inf):
            # with the bytes term out, a bound is linear in the docs
            monkeypatch.setattr(counts, "HBM_BYTES_S", bytes_s)
            monkeypatch.setattr(profiler, "counters", {})
            session.fwd_bound_s = 0.0
            session.unit()
            recs = session.records(session.done[-1])
            users = len(np.unique(recs["user"][:, 0]))
            items = len(np.unique(recs["item"]))
            assert session.fwd_bound_s == (
                counts.towers_fwd_bound_s(cfg, users)
                + counts.towers_fwd_bound_s(cfg, items))
        rows, c = recs["item"].shape
        grid = -(-rows // gb) * (counts.towers_fwd_bound_s(cfg, gb)
                                 + counts.towers_fwd_bound_s(cfg, gb * c))
        share = (profiler.counters["score_grid.towers"]
                 / profiler.counters["score_grid.tower_slots"])
        assert share < 1
        assert session.fwd_bound_s / grid == pytest.approx(share, rel=1e-12)
    finally:
        session.close()


def test_a_model_without_a_file_fails_at_set_up(bench):
    def as_unknown(cfg, traffic):
        shrink(cfg, traffic)
        cfg["model"] = "no_such_model"

    with pytest.raises(FileNotFoundError, match=r"no_such_model\.py"):
        run.run_cell(bench, "deepconn.train", SEED, 0.2, False, CPU, 0.0,
                     shrink=as_unknown, log=lambda *a, **k: None)


def test_a_rank_cell_on_a_model_without_rank_scores_fails_at_set_up(
        bench, monkeypatch):
    cfg, traffic, data, w = _session(bench, "narre.rank")
    monkeypatch.delattr(models.load("NARRE"), "rank_scores")
    with pytest.raises(AttributeError, match="NARRE.py defines no rank_scores"):
        drivers.Rank(cfg, traffic, data, w, SEED, CPU)


def test_narre_rank_scores_are_its_forward_on_each_pair(bench):
    """The factorized ranking scores (each distinct entity encoded once)
    equal NARRE's own forward run on every grid pair, no dropout and no
    row masked."""
    cfg, traffic, data, w = _session(bench, "narre.rank")
    ref = Reference(cfg, data, w, CPU)
    users, grid = drivers.rank_grids(data, traffic, SEED)
    users, grid = users[:3], grid[:3]
    got = ref.rank_scores(users, grid)
    pu = np.repeat(users, grid.shape[1])
    pi = grid.reshape(-1)
    u = [rows_doc(data.user_reviews[x], data.u_to_i[x], ref.R, ref.T,
                  data.num_items + 1) for x in pu]
    it = [rows_doc(data.item_reviews[x], data.i_to_u[x], ref.R, ref.T,
                   data.num_users + 1) for x in pi]
    inp = {"udoc": ref._t(np.stack([d for d, _ in u])),
           "uctx": ref._t(np.stack([x for _, x in u])),
           "idoc": ref._t(np.stack([d for d, _ in it])),
           "ictx": ref._t(np.stack([x for _, x in it])),
           "uskip": None, "iskip": None}
    want = ref.forward(ref.w, pu, pi, inp, None).reshape(grid.shape)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)
