"""The port's spans and counters (`reviews4rec_torch/train/profiler.py`):

- with no profiler recording, `annotate` creates no `record_function`
  and makes no NVTX call;
- under a CPU `torch.profiler.profile`, `train_epoch` with a CPU
  `ScanSteps` and `eval_ranking` over entity tables give their spans
  with their nesting, each leaf span without a child span, and return
  what the same calls return unprofiled;
- `count` adds to `counters`.
"""

import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams
from reviews4rec_torch.data.batcher import Batcher
from reviews4rec_torch.data.synthetic import make_synthetic
from reviews4rec_torch.models import build_model
from reviews4rec_torch.train import evaluate, loop, profiler

CPU = torch.device("cpu")
STEPS = 5
SPANS = {"train_epoch", "train_group", "train_step", "scan.ring_wait",
         "scan.stage", "scan.capture", "scan.replay", "eval_ranking",
         "score_grid.place", "score_grid.assemble", "score_grid.forward",
         "score_grid.fetch", "score_grid.towers"}
LEAVES = {"scan.ring_wait", "scan.stage", "scan.replay",
          "score_grid.place", "score_grid.assemble", "score_grid.fetch",
          "score_grid.towers"}


@pytest.fixture(scope="module")
def corpus():
    ds = make_synthetic(num_users=30, num_items=25, vocab=100, seed=3)
    hp = ds.apply_to(HyperParams(
        model_type="deepconn", input_length=32, batch_size=16,
        latent_size=8, dropout=0.5, shuffle_data_every_epoch=True,
        cache_doc_embeds=True, cache_entity=True, save_model=False))
    return hp, ds


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in SPANS]


def _parent_span(event):
    p = event.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return None if p is None else p.name


def _names(spans, name):
    return [e for e in spans if e.name == name]


def _train(corpus):
    """One epoch of `train_epoch` with a CPU `ScanSteps` of `STEPS`: its
    result, the parameters after it and the number of batches."""
    hp, ds = corpus
    model = build_model(hp, ds.word_vectors, device=CPU)
    opt = loop.make_optimizer(hp, model)
    cache = loop.EntityCache(
        {k: torch.from_numpy(v)
         for k, v in ds.materialize_entity(hp, "train").items()},
        loop.build_entity_tables(hp, ds, CPU))
    batcher = Batcher({"row": np.arange(len(cache.example["rating"]))},
                      hp.batch_size, shuffle=True, seed=hp.seed)
    scan = loop.ScanSteps(model, opt, STEPS, CPU, cache)
    out = loop.train_epoch(model, opt, batcher,
                           loop.epoch_generator(hp.seed, 1, CPU), CPU,
                           cache, scan)
    return out, model.state_dict(), len(batcher)


def _rank(corpus):
    """`eval_ranking` and `score_grid` over id-only grids of 1 + 4
    candidates, 4 grid rows a batch: (metrics, scores, batches)."""
    hp, ds = corpus
    model = build_model(hp, ds.word_vectors, device=CPU)
    tables = loop.build_entity_tables(hp, ds, CPU)
    rng = np.random.default_rng(5)
    rows = 10
    users = rng.integers(0, ds.num_users, rows)
    items = rng.integers(0, ds.num_items, (rows, 5))
    recs = {"user": np.repeat(users[:, None], 5, axis=1).astype(np.int32),
            "item": items.astype(np.int32),
            "rating": np.zeros((rows, 5), np.float32)}
    metrics = evaluate.eval_ranking(model, recs, hp, 4, CPU, tables)
    scores = evaluate.score_grid(model, recs, 4, CPU, tables)
    return metrics, scores, -(-rows // 4)


def test_unrecorded_span_creates_no_range_and_no_nvtx(corpus, monkeypatch):
    """No NVTX call at all; no `record_function` of a program span (torch's
    optimizer opens its own, which is not the program's to gate)."""
    def refused(*a, **kw):
        raise AssertionError("NVTX called")

    for name in ("range", "range_push", "range_pop", "mark"):
        monkeypatch.setattr(torch.cuda.nvtx, name, refused)
    opened = []
    for mod in (torch.profiler, torch.autograd.profiler):
        def spy(name, *a, _real=mod.record_function, **kw):
            opened.append(name)
            return _real(name, *a, **kw)
        monkeypatch.setattr(mod, "record_function", spy)
    assert not profiler._recording()
    with profiler.annotate("outer"):
        with profiler.annotate("inner"):
            pass
    assert _train(corpus)[0]["MSE"] > 0
    assert _rank(corpus)[1].shape == (10, 5)
    assert not set(opened) & (SPANS | {"outer", "inner"})
    assert opened, "the spy sees torch's own ranges"


def test_train_epoch_spans_and_nesting(corpus):
    want, want_params, batches = _train(corpus)
    assert batches > STEPS and batches % STEPS, "full groups and a tail"
    (got, params, _), spans = _profiled(lambda: _train(corpus))
    assert got["MSE"] == want["MSE"]
    assert set(params) == set(want_params)
    for k in params:
        assert torch.equal(params[k], want_params[k]), k

    groups = batches // STEPS
    epoch = _names(spans, "train_epoch")
    assert len(epoch) == 1 and _parent_span(epoch[0]) is None
    assert [_parent_span(e) for e in _names(spans, "train_group")] == \
        ["train_epoch"] * groups
    assert [_parent_span(e) for e in _names(spans, "train_step")] == \
        ["train_epoch"]
    assert [_parent_span(e) for e in _names(spans, "scan.stage")] == \
        ["train_group"] * groups
    for name in ("scan.ring_wait", "scan.capture", "scan.replay"):
        assert not _names(spans, name), "no graph and no ring on the CPU"
    assert not [e for e in spans if _parent_span(e) in LEAVES]


def test_eval_ranking_spans_and_nesting(corpus):
    want_metrics, want_scores, batches = _rank(corpus)
    (metrics, scores, _), spans = _profiled(lambda: _rank(corpus))
    assert metrics == want_metrics
    np.testing.assert_array_equal(scores, want_scores)

    calls = _names(spans, "eval_ranking")
    assert len(calls) == 1 and _parent_span(calls[0]) is None
    start, end = calls[0].time_range.start, calls[0].time_range.end
    inside = [e for e in spans if start <= e.time_range.start <= end]
    outside = [e for e in spans if e.time_range.start > end]
    for name in ("score_grid.place", "score_grid.assemble",
                 "score_grid.forward"):
        assert [_parent_span(e) for e in _names(inside, name)] == \
            ["eval_ranking"] * batches, name
        # the direct score_grid call: the same spans, under no call span
        assert [_parent_span(e) for e in _names(outside, name)] == \
            [None] * batches, name
    assert [_parent_span(e) for e in _names(inside, "score_grid.fetch")] \
        == ["eval_ranking"]
    # deepconn over entity tables: its towers once a call, before the
    # call's batches
    towers = _names(inside, "score_grid.towers")
    assert [_parent_span(e) for e in towers] == ["eval_ranking"]
    assert towers[0].time_range.end <= min(
        e.time_range.start for e in _names(inside, "score_grid.place"))
    assert [_parent_span(e) for e in _names(outside, "score_grid.towers")] \
        == [None]
    assert not [e for e in spans if _parent_span(e) in LEAVES]


def test_count_adds_to_counters(monkeypatch):
    monkeypatch.setattr(profiler, "counters", {})
    profiler.count("scan.captures")
    profiler.count("scan.captures")
    profiler.count("other", 5)
    assert profiler.counters == {"scan.captures": 2, "other": 5}
