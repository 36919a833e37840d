"""`score_grid`'s factorized path (`train/evaluate.py`): over entity
tables, off a mesh, a model that splits its towers from its head
(deepconn, deepconn++: `entity_towers`, `pair_head`) encodes each
distinct user and item of the call once, then runs the head on each
pair's two tower vectors.

- Its scores equal the joint path's within 1e-5 (the joint path reached
  by the same call on the model with its split hidden), on grids that
  repeat items across rows, name one user in two rows and end in a
  partial batch; `positive_ranks` and `eval_ranking`'s metrics are
  identical.
- Its scores equal, bitwise, the per-batch-placement arithmetic it
  replaced (`chip_smoke._score_per_batch`, which the `rank_async` phase
  holds it against on the card), for one batch, several and a partial
  last batch; it places the call once and copies no batch.
- The counters: `score_grid.tower_slots` (grid rows + pairs) on either
  path; `score_grid.towers` the distinct ids on the factorized path,
  the slots on the joint one; `score_grid.batches` on both;
  `score_grid.placements` one a call on the factorized path, one a
  batch on the joint one.
- Every other case keeps the joint path, bitwise: NARRE and transnet(++)
  over entity tables, MPCN and deepconn on host-doc grids, and a model
  laid out on a mesh (a one-rank stand-in; the two-rank run is
  `tests/test_torch_parallel.py`'s `entity_cache_2x1`).
"""

import numpy as np
import pytest
import torch

import chip_smoke

from reviews4rec_torch.config import HyperParams
from reviews4rec_torch.data.batcher import Batcher
from reviews4rec_torch.data.synthetic import make_synthetic
from reviews4rec_torch.models import build_model
from reviews4rec_torch.train import evaluate, loop, profiler
from reviews4rec_torch.utils.device import to_device

CPU = torch.device("cpu")
ROWS, CANDS, BATCH = 10, 5, 4       # 3 batches, the last of 2 rows
GEOM = dict(input_length=32, batch_size=16, latent_size=8,
            narre_num_reviews=4, narre_num_words=16, mpcn_dmax=4,
            mpcn_smax=8, save_model=False)
ENTITY = dict(cache_doc_embeds=True, cache_entity=True)
# (model, options): the split models over every kind of entity table
SPLIT = {"deepconn": ("deepconn", {}),
         "deepconn++": ("deepconn++", {}),
         "deepconn_ids": ("deepconn", dict(cache_sides="ids")),
         "deepconn++_item": ("deepconn++", dict(cache_sides="item")),
         "deepconn_bf16": ("deepconn", dict(compute_dtype="bfloat16"))}


@pytest.fixture(scope="module")
def corpus():
    return make_synthetic(num_users=30, num_items=25, vocab=100, seed=3)


def _setup(ds, mt, **kw):
    hp = ds.apply_to(HyperParams(model_type=mt, **GEOM, **kw))
    model = build_model(hp, ds.word_vectors, device=CPU)
    return hp, model


def _grid(ds):
    """[ROWS, CANDS] id-only records: user 1's row twice, 50 item slots
    over 25 items."""
    rng = np.random.default_rng(5)
    users = rng.choice(ds.num_users, ROWS, replace=False)
    users[3] = users[1]
    items = rng.integers(0, ds.num_items, (ROWS, CANDS))
    return {"user": np.repeat(users[:, None], CANDS, axis=1).astype(np.int32),
            "item": items.astype(np.int32),
            "rating": np.zeros((ROWS, CANDS), np.float32)}


def _counted(monkeypatch, fn):
    monkeypatch.setattr(profiler, "counters", {})
    out = fn()
    return out, dict(profiler.counters)


def _joint(model, recs, tables=None, words=0):
    """The joint path written out: each batch's grid assembled and the
    whole forward run on it."""
    model.eval()
    outs, weights = [], []
    with torch.inference_mode():
        for batch in Batcher(recs, BATCH):
            placed = to_device(batch, CPU)
            if tables is not None:
                placed = evaluate.assemble_entity_grid(placed, tables, words)
            outs.append(evaluate.source_pred(model(placed)).numpy())
            weights.append(batch["weight"].astype(bool))
    return np.concatenate([o[w] for o, w in zip(outs, weights)])


def test_grid_covers_repeats_and_a_partial_batch(corpus):
    recs = _grid(corpus)
    users = recs["user"][:, 0]
    assert len(np.unique(users)) == ROWS - 1
    assert len(np.unique(recs["item"])) < recs["item"].size
    assert ROWS % BATCH


@pytest.mark.parametrize("case", list(SPLIT))
def test_factorized_scores_equal_the_joint_path(case, corpus, monkeypatch):
    mt, kw = SPLIT[case]
    hp, model = _setup(corpus, mt, **ENTITY, **kw)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    recs = _grid(corpus)
    got, c_got = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU, tables))
    m_got = evaluate.eval_ranking(model, recs, hp, BATCH, CPU, tables)

    monkeypatch.setattr(model, "entity_towers", None, raising=False)
    want, c_want = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU, tables))
    m_want = evaluate.eval_ranking(model, recs, hp, BATCH, CPU, tables)

    assert got.shape == want.shape == (ROWS, CANDS)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(evaluate.positive_ranks(got),
                                  evaluate.positive_ranks(want))
    assert m_got == m_want
    slots = ROWS + ROWS * CANDS
    distinct = len(np.unique(recs["user"][:, 0])) + len(np.unique(
        recs["item"]))
    batches = -(-ROWS // BATCH)
    assert c_got == {"score_grid.tower_slots": slots,
                     "score_grid.towers": distinct,
                     "score_grid.batches": batches,
                     "score_grid.placements": 1}
    assert c_want == {"score_grid.tower_slots": slots,
                      "score_grid.towers": slots,
                      "score_grid.batches": batches,
                      "score_grid.placements": batches}


# grid rows a batch: one batch, several whole ones, a partial last one,
# a row each
BATCHES = [ROWS, ROWS // 2, BATCH, 1]


@pytest.mark.parametrize("batch_size", BATCHES)
@pytest.mark.parametrize("case", list(SPLIT))
def test_factorized_scores_are_the_per_batch_placement_bitwise(
        case, batch_size, corpus):
    mt, kw = SPLIT[case]
    hp, model = _setup(corpus, mt, **ENTITY, **kw)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    recs = _grid(corpus)
    got = evaluate.score_grid(model, recs, batch_size, CPU, tables)
    want = chip_smoke._score_per_batch(torch, model, recs, batch_size, CPU,
                                       tables)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_size", BATCHES)
def test_factorized_call_places_once(batch_size, corpus, monkeypatch):
    """One placement a call whatever its batch count, and no batch
    copied through `to_device`."""
    hp, model = _setup(corpus, "deepconn++", **ENTITY)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    recs = _grid(corpus)

    def copied(*a, **k):
        raise AssertionError("a factorized batch went through to_device")

    monkeypatch.setattr(evaluate, "to_device", copied)
    got, counted = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, batch_size, CPU, tables))
    assert got.shape == (ROWS, CANDS)
    assert counted["score_grid.batches"] == -(-ROWS // batch_size)
    assert counted["score_grid.placements"] == 1


@pytest.mark.parametrize("mt", ["deepconn", "deepconn++"])
def test_split_is_the_forward_arithmetic(mt, corpus):
    """`entity_towers` then `pair_head` give the eval forward's ratings
    on the same rows bitwise (same ops on the same docs)."""
    hp, model = _setup(corpus, mt, **ENTITY)
    model.eval()
    tables = loop.build_entity_tables(hp, corpus, CPU)
    users = torch.tensor([0, 7, 7, 29], dtype=torch.int32)
    items = torch.tensor([3, 3, 11, 24], dtype=torch.int32)
    with torch.inference_mode():
        u = model.entity_towers("user", tables["user_doc"], users)
        i = model.entity_towers("item", tables["item_doc"], items)
        got = model.pair_head(u, i, users, items)
        want = model({"user": users, "item": items,
                      "user_doc__table": tables["user_doc"],
                      "item_doc__table": tables["item_doc"]})
    assert u.shape == i.shape == (4, hp.latent_size)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mt", ["NARRE", "transnet", "transnet++"])
def test_entity_grids_without_the_split_stay_joint(mt, corpus, monkeypatch):
    hp, model = _setup(corpus, mt, **ENTITY)
    assert not evaluate._splits_towers(model)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    words = evaluate.grid_this_doc_words(hp)
    recs = _grid(corpus)
    got, counted = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU, tables, words))
    np.testing.assert_array_equal(got, _joint(model, recs, tables, words))
    assert counted["score_grid.towers"] == \
        counted["score_grid.tower_slots"] == ROWS + ROWS * CANDS


@pytest.mark.parametrize("mt", ["deepconn", "MPCN"])
def test_host_doc_grids_stay_joint(mt, corpus, monkeypatch):
    hp, model = _setup(corpus, mt)
    recs = corpus.materialize_negs(hp)
    assert "item_doc" in recs
    got, counted = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU))
    np.testing.assert_array_equal(got, _joint(model, recs))
    assert counted["score_grid.towers"] == \
        counted["score_grid.tower_slots"] == recs["item"].shape[0] \
        + recs["item"].size


class _OneRankMesh:
    """A stand-in for a mesh of one data rank: what `score_grid` reads
    of one."""
    data_axis = "data"
    shape = {"data": 1, "model": 1}

    def all_gather(self, t, axis):
        return t[None]


def test_a_model_on_a_mesh_stays_joint(corpus, monkeypatch):
    hp, model = _setup(corpus, "deepconn++", **ENTITY)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    monkeypatch.setattr(model, "mesh", _OneRankMesh(), raising=False)
    recs = _grid(corpus)
    got, counted = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU, tables))
    np.testing.assert_array_equal(got, _joint(model, recs, tables))
    assert counted["score_grid.towers"] == counted["score_grid.tower_slots"]


def test_an_empty_grid_gives_no_scores(corpus, monkeypatch):
    hp, model = _setup(corpus, "deepconn", **ENTITY)
    tables = loop.build_entity_tables(hp, corpus, CPU)
    recs = {k: v[:0] for k, v in _grid(corpus).items()}
    got, counted = _counted(monkeypatch, lambda: evaluate.score_grid(
        model, recs, BATCH, CPU, tables))
    assert got.shape == (0, CANDS)
    assert counted == {"score_grid.tower_slots": 0, "score_grid.towers": 0,
                       "score_grid.batches": 0}


def test_tower_share_reader_reads_the_counters(monkeypatch):
    """`portbench/metrics/entry.tower_share.py`: 100 x towers / slots,
    nothing without the counters (the parent program's case)."""
    from portbench import run
    read = run.reader("entry.tower_share.rank").read
    record = {"trace": {"window_s": 0.27, "host": {}},
              "slice": {"units": 10, "steps": 10}}
    monkeypatch.setattr(profiler, "counters", {})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters", {"scan.captures": 1})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters",
                        {"score_grid.tower_slots": 25856})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters",
                        {"score_grid.tower_slots": 25856,
                         "score_grid.towers": 9960})
    assert read(record) == pytest.approx(100.0 * 9960 / 25856)
    monkeypatch.delattr(profiler, "counters")
    assert read(record) is None


def test_traced_rank_run_reports_the_tower_share(monkeypatch):
    """A shrunk CPU traced run of the ranking cell reports the share: 8
    grid rows of 1 + 9 candidates over 40 items name 88 towers, and the
    factorized calls encode fewer."""
    from portbench import run
    from portbench.conftest import SEED, shrink
    monkeypatch.setattr(profiler, "counters", {})
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    result = run.run_cell(bench, "deepconn.rank", SEED, 0.2, True, CPU, 0.0,
                          shrink=shrink, log=lambda *a, **k: None)
    assert result["correct"]
    share = result["metrics"]["entry.tower_share.rank"]
    assert share["unit"] == "%" and 0 < share["value"] < 100


def test_placements_per_batch_reader_reads_the_counters(monkeypatch):
    """`portbench/metrics/entry.placements_per_batch.py`: placements
    over batches, nothing without the counters (the parent program's
    case)."""
    from portbench import run
    read = run.reader("entry.placements_per_batch.rank").read
    record = {"trace": {"window_s": 0.27, "host": {}},
              "slice": {"units": 10, "steps": 10}}
    monkeypatch.setattr(profiler, "counters", {})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters",
                        {"score_grid.tower_slots": 25856,
                         "score_grid.towers": 9960})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters", {"score_grid.batches": 8})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters", {"score_grid.batches": 0,
                                               "score_grid.placements": 0})
    assert read(record) is None
    monkeypatch.setattr(profiler, "counters", {"score_grid.batches": 8,
                                               "score_grid.placements": 1})
    assert read(record) == 0.125
    monkeypatch.setattr(profiler, "counters", {"score_grid.batches": 8,
                                               "score_grid.placements": 8})
    assert read(record) == 1.0
    monkeypatch.delattr(profiler, "counters")
    assert read(record) is None


def test_traced_rank_run_reports_one_placement_a_call(monkeypatch):
    """A shrunk CPU traced run of the ranking cell: calls of 8 grid rows
    in batches of 4 read one placement over 2 batches."""
    from portbench import run
    from portbench.conftest import SEED, shrink
    monkeypatch.setattr(profiler, "counters", {})
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    result = run.run_cell(bench, "deepconn.rank", SEED, 0.2, True, CPU, 0.0,
                          shrink=shrink, log=lambda *a, **k: None)
    assert result["correct"]
    got = result["metrics"]["entry.placements_per_batch.rank"]
    assert got == {"value": 0.5, "unit": "ratio"}
