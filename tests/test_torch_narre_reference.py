"""The port's NARRE against the benchmark's plain reference
(`portbench.reference.Reference`: float64, plain torch, no JAX), on the
CPU at a small size, through the path the benchmark's `narre.train`
cell takes: the entity cache of per-review tables and one `ScanSteps`
group (`portbench.drivers.Train.first_steps`), checked by
`portbench.check.train_numbers`.

- The corpus (the benchmark's generator, cut by `portbench.conftest
  .shrink`) holds entities with fewer than R reviews (whole zero rows and
  pad neighbor ids, repeated), reviews shorter than W words, and pairs
  whose own review row lies inside R (the skip row).
- The repaired semantics: where a gradient is routed, the forward's idx
  is the float64 first argmax at a max-pool near-tie
  (`ops.textcnn.refine_ties`), also where f32 rounding makes the two
  windows equal.
- The review counters (`train.loop.review_counts`) exactly, against
  counts taken from the corpus's own review lists, and NARRE's spans
  only under a profiler.
"""

import numpy as np
import pytest
import torch

from portbench import check, corpus, drivers, run, weights
from portbench.conftest import shrink
from reviews4rec_torch.data.batcher import Batcher
from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.train import loop, profiler

CPU = torch.device("cpu")
SEEDS = (3200000108, 3200000107, 2 ** 31 + 977)
# float32 against float64 over one group of 10 Adam steps at the shrunk
# size: the readings are 1e-8 to 1e-6 (losses and moments: f32 sums of a
# few hundred terms; updates: Adam's first steps are lr * sign(g), so a
# leaf's update norm moves only where its f32 moment rounds near zero).
# The limits sit 10-100 times above them and under the benchmark's own
# (1e-3, 1e-2, 5e-3 and 1e-4 for the medians): a wrong window, a wrong
# row or a missing skip reads 1e-3 or more.
LIMITS = {"loss_gap": 1e-5, "moment_gap": 1e-4, "moment_median_gap": 1e-5,
          "update_gap": 1e-4, "update_median_gap": 1e-5}


def _cell(seed):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, cfg, traffic, _ = run.cell_files(bench, "narre.train")
    shrink(cfg, traffic)
    data = corpus.generate(cfg, seed, CPU)
    w = weights.make(cfg, data.num_users, data.num_items, seed, CPU)
    return cfg, traffic, data, w


@pytest.fixture(scope="module", params=SEEDS)
def group(request):
    """One seed's first group through the benchmark's train entry, and
    the numbers `correct` compares."""
    seed = request.param
    cfg, traffic, data, w = _cell(seed)
    session = drivers.Train(cfg, traffic, data, w, seed, CPU)
    out = dict(session.outputs)
    numbers = run.check_numbers(cfg, traffic, data, w, CPU, out, LIMITS,
                                tf32=False)
    return cfg, data, session, numbers


def test_corpus_has_the_patterns_of_the_card_fault():
    cfg, _, data, _ = _cell(SEEDS[0])
    R, W = cfg["hp"]["narre_num_reviews"], cfg["hp"]["narre_num_words"]
    counts = np.array([len(r) for r in data.user_reviews])
    assert (counts < R).any() and (counts >= R).any()
    lens = np.concatenate([[len(x) for x in r] for r in data.user_reviews])
    assert (lens < W).any() and (lens > W).any()
    tu, ti, _ = data.splits["train"]
    own = np.array([data.this_index[(int(u), int(i))][0]
                    for u, i in zip(tu, ti)])
    assert (own < R).any()
    # an entity with fewer than R reviews repeats the pad neighbor id
    short = int(np.flatnonzero(counts < R)[0])
    assert R - counts[short] >= 2


def test_group_matches_the_float64_reference(group):
    _, _, _, numbers = group
    ok, checks, _ = check.judge(numbers, LIMITS)
    assert ok, checks


def test_group_ran_one_scan_group_over_per_review_tables(group):
    cfg, _, session, _ = group
    R = cfg["hp"]["narre_num_reviews"]
    assert session.scan is not None and session.scan.steps == 4
    assert len(session.outputs["rows"]) == session.scan.steps
    doc = session.cache.tables["user_doc"]
    assert doc.shape[1] == R and "users_who_gave" in session.cache.tables


def _tie_case():
    """x, K and b where windows 2 (word rows 0-2) and 12 (rows 10-12)
    differ only by 2^-23 in one element: float64 puts window 12 ahead by
    2^-33 for filter 0, while f32 rounds both sums alike (values near 1,
    an ulp of 1.2e-7), so its first argmax is window 2."""
    t, e, f, w = 20, 8, 4, 3
    gen = torch.Generator().manual_seed(7)
    k = torch.rand((w * e, f), generator=gen) * 0.2 + 0.01
    k[:, 0] = 2.0 ** -5
    k[0, 0] = 2.0 ** -10
    x = torch.rand((2, t, e), generator=gen) * 0.1 - 0.05
    x[:, 0:3] = 1.0
    x[:, 10:13] = 1.0
    x[:, 10, 0] = 1.0 + 2.0 ** -23
    b = torch.full((f,), 0.01)
    return x, k, b, w


def test_near_tie_takes_the_float64_window():
    x, k, b, w = _tie_case()
    out, idx, sec = textcnn.textcnn_pool_reference(x, k, b, w, second=True)
    _, idx64 = textcnn.textcnn_pool_reference(x.double(), k.double(),
                                              b.double(), w)
    assert torch.equal(idx[:, 0], torch.tensor([2, 2], dtype=idx.dtype))
    assert torch.equal(idx64[:, 0], torch.tensor([12, 12],
                                                 dtype=idx64.dtype))
    assert torch.equal(sec[:, 0], out[:, 0]), "f32 sees an exact tie"
    kk = k.clone().requires_grad_(True)
    got_out, got_idx = textcnn.textcnn_pool(x, kk, b, w)
    assert torch.equal(got_out, out)
    assert torch.equal(got_idx[:, 0], idx64[:, 0].to(got_idx.dtype))
    # the gradient goes through window 12, as float64's does
    got_out[:, 0].sum().backward()
    _, want_dk, _ = textcnn.textcnn_pool_backward_reference(
        x, k, torch.ones_like(out) * (torch.arange(4) == 0), got_idx, w)
    assert torch.equal(kk.grad, want_dk)
    # without a gradient to route, the op keeps the f32 first argmax
    assert torch.equal(textcnn.textcnn_pool(x, k, b, w)[1], idx)


@pytest.mark.parametrize("case", ["swapped", "far", "zero_window", "skip"])
def test_refine_ties_rules(case):
    """A near-tie whose idx names the rival is put right (inside a skip
    span's doc too, the span read as zeros); a (b, f) whose best and
    second values lie further than TIE_TOL apart keeps its idx, as does
    one whose max is the all-zero window's value."""
    gen = torch.Generator().manual_seed(11)
    bsz, t, e, f, w = 40, 12, 4, 6, 3
    x = torch.randn((bsz, t, e), generator=gen) * 0.3
    k = torch.randn((w * e, f), generator=gen) * 0.3
    b = torch.randn(f, generator=gen) * 0.05
    b[1] = b[1].abs() + 0.01
    skip = None
    if case == "skip":
        skip = torch.zeros((bsz, 2), dtype=torch.int32)
        skip[:, 0], skip[:, 1] = 3, 4
    out, idx, sec = textcnn.textcnn_pool_reference(x, k, b, w, skip,
                                                   second=True)
    _, idx64 = textcnn.textcnn_pool_reference(x.double(), k.double(),
                                              b.double(), w, skip)
    idx64 = idx64.to(idx.dtype)
    assert torch.equal(idx, idx64)
    rival = torch.where(idx64 == 0, 1, idx64 - 1)
    at = tuple(int(v) for v in (out > 0.1).nonzero()[0])
    if case in ("swapped", "skip"):
        # claim a near-tie with the wrong window: refined back
        wrong, near = idx.clone(), sec.clone()
        wrong[at] = rival[at]
        near[at] = out[at]
        got = textcnn.refine_ties(x, k, b, w, skip, out, wrong, near)
        assert torch.equal(got, idx64)
    elif case == "far":
        got = textcnn.refine_ties(x, k, b, w, None, out, rival, sec)
        far = out - sec > textcnn.TIE_TOL * out.clamp(min=1.0)
        assert far.any()
        assert torch.equal(got[far], rival[far])
    else:
        wrong, near, zero_out = idx.clone(), sec.clone(), out.clone()
        wrong[5, 1] = rival[5, 1]
        zero_out[5, 1] = torch.relu(b[1])
        near[5, 1] = zero_out[5, 1]
        got = textcnn.refine_ties(x, k, b, w, None, zero_out, wrong, near)
        assert got[5, 1] == wrong[5, 1]


def _expected_counts(cfg, data, rows):
    """The four counters for train example rows `rows`, from the corpus's
    review lists: each side's first R reviews, W words each, less the
    pair's own review row."""
    R, W = cfg["hp"]["narre_num_reviews"], cfg["hp"]["narre_num_words"]
    tu, ti, _ = data.splits["train"]
    live_rows = live_words = 0
    for r in rows:
        u, i = int(tu[r]), int(ti[r])
        own = data.this_index[(u, i)]
        for revs, skip in ((data.user_reviews[u], own[0]),
                           (data.item_reviews[i], own[1])):
            for j, rev in enumerate(revs[:R]):
                if j != skip and len(rev):
                    live_rows += 1
                    live_words += min(len(rev), W)
    n = len(rows)
    return {"narre.review_rows": n * 2 * R,
            "narre.review_rows_live": live_rows,
            "narre.review_words": n * 2 * R * W,
            "narre.review_words_live": live_words}


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_review_counters_are_exact(monkeypatch, scan_steps):
    cfg, traffic, data, w = _cell(SEEDS[0])
    session = drivers.Session(cfg, traffic, data, w, SEEDS[0], CPU)
    hp = session.hp
    recs = session.dataset.materialize_entity(hp, "train")
    cache = loop.EntityCache({k: torch.from_numpy(v)
                              for k, v in recs.items()},
                             loop.build_entity_tables(hp, session.dataset,
                                                      CPU))
    opt = loop.make_optimizer(hp, session.model)
    scan = (loop.ScanSteps(session.model, opt, scan_steps, CPU, cache)
            if scan_steps > 1 else None)
    # 9 batches: two full groups of 4 and a trailing step, the last batch
    # padded (its padding rows gather row 0, and are encoded)
    rows = np.random.default_rng(3).permutation(len(recs["rating"]))[:135]
    monkeypatch.setattr(profiler, "counters", {})
    loop.train_epoch(session.model, opt, Batcher({"row": rows}, 16),
                     loop.epoch_generator(1, 1, CPU), CPU, cache, scan)
    encoded = np.concatenate([rows, np.zeros(9 * 16 - len(rows), int)])
    want = _expected_counts(cfg, data, encoded)
    assert {k: profiler.counters[k] for k in want} == want
    assert want["narre.review_rows_live"] < want["narre.review_rows"]


def test_review_counts_are_none_off_per_review_tables():
    cfg, traffic, data, w = _cell(SEEDS[0])
    session = drivers.Session(cfg, traffic, data, w, SEEDS[0], CPU)
    hp = session.hp
    tables = loop.build_entity_tables(hp, session.dataset, CPU)
    val = loop.EntityCache({k: torch.from_numpy(v) for k, v in
                            session.dataset.materialize_entity(
                                hp, "val").items()}, tables)
    assert loop.review_counts(val) is None
    assert loop.review_counts(None) is None


def test_narre_spans_only_under_a_profiler(monkeypatch):
    cfg, traffic, data, w = _cell(SEEDS[0])
    session = drivers.Session(cfg, traffic, data, w, SEEDS[0], CPU)
    hp = session.hp
    recs = session.dataset.materialize_entity(hp, "train")
    cache = loop.EntityCache({k: torch.from_numpy(v)
                              for k, v in recs.items()},
                             loop.build_entity_tables(hp, session.dataset,
                                                      CPU))
    opt = loop.make_optimizer(hp, session.model)
    names = {"narre.towers", "narre.attend", "narre.head",
             "cache.gather_rows"}
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    batches = Batcher({"row": np.arange(32)}, 16)
    loop.train_epoch(session.model, opt, batches,
                     loop.epoch_generator(1, 1, CPU), CPU, cache)
    assert not set(opened) & names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loop.train_epoch(session.model, opt, batches,
                         loop.epoch_generator(1, 2, CPU), CPU, cache)
    spans = [e for e in prof.events() if e.name in names]
    for name in names:
        assert len([e for e in spans if e.name == name]) == 2, name
    parents = {e.name: e.cpu_parent.name for e in spans
               if e.name.startswith("narre.")}
    assert set(parents.values()) <= {"train_step"}


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_capturable_adam_takes_float64_bias_corrections(steps):
    """`train.loop.Adam`'s capturable step (the one the card runs, here on
    CPU tensors) against Adam written out in float64: from a zero
    parameter the first steps move it by about lr, so f32 bias corrections
    (1 - f32(0.999) is 1.3e-5 off 1e-3, torch's capturable form) would read
    some 6e-6 lr off; f32 rounding of the rest reads under 1e-6 lr."""
    lr, wd, (b1, b2), eps = 2e-3, 1e-6, (0.9, 0.999), 1e-8
    gen = torch.Generator().manual_seed(5)
    grads = [torch.randn(4000, generator=gen) * 1e-3 for _ in range(steps)]
    p = torch.nn.Parameter(torch.zeros(4000))
    opt = loop.Adam([p], lr=lr, weight_decay=wd, capturable=True)
    w = torch.zeros(4000, dtype=torch.float64)
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    for t, g in enumerate(grads, 1):
        p.grad = g.clone()
        opt.step()
        g64 = g.double() + wd * w
        m = b1 * m + (1 - b1) * g64
        v = b2 * v + (1 - b2) * g64 * g64
        w = w - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    assert float((p.detach().double() - w).abs().max()) < 1e-6 * lr
    assert opt.state[p]["step"].dtype == torch.float32
