"""The general traffic driver: the one generator every traffic mix's
data file parameterises, and the program's entries the cells drive.

A traffic file `portbench/traffic/<mix>.json` names its `entry`:

- "train": `train.loop.train_epoch` over the entity cache with the
  configuration's `ScanSteps`, built as `train_complete` builds them;
  one unit is one epoch of every train row in seeded shuffled order
  (closed loop). Before the window one epoch warms up and captures the
  graph; then the parameters and Adam's state go back to their start
  in place, and one group of `scan_steps` batches of distinct rows runs
  through the same call, a replay of that graph: what the check
  compares.
- "rank": `train.evaluate.eval_ranking` over the entity tables; one unit
  is one call of `rows_per_call` grid rows, `grid_batch` rows a batch.
  A grid row is a test user's held-out positive and `negatives` items
  drawn uniformly, without repeats, from items the user never rated.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from reviews4rec_torch.config import HyperParams
from reviews4rec_torch.data.batcher import Batcher
from reviews4rec_torch.data.corpus import ReviewDataset, Split
from reviews4rec_torch.models import build_model
from reviews4rec_torch.train import evaluate, loop
from reviews4rec_torch.utils.device import to_device

from . import counts, models
from .corpus import stream, torch_seed


def to_dataset(corpus) -> ReviewDataset:
    splits = {s: Split(*a) for s, a in corpus.splits.items()}
    return ReviewDataset.build(
        num_users=corpus.num_users, num_items=corpus.num_items,
        num_words=corpus.vocab, splits=splits,
        user_reviews=corpus.user_reviews, item_reviews=corpus.item_reviews,
        u_to_i=corpus.u_to_i, i_to_u=corpus.i_to_u,
        this_index=corpus.this_index, test_reviews={},
        neg_users=np.zeros(0, np.int32),
        neg_cands=np.zeros((0, 6), np.int32),
        word_vectors=corpus.word_vectors)


def hyper_params(cfg: Dict, seed: int) -> HyperParams:
    kw = dict(cfg["hp"])
    kw["eval_ks"] = tuple(kw.get("eval_ks", (1, 10)))
    return HyperParams(**kw, dataset=cfg["name"], seed=int(seed),
                       save_model=False)


def load_model(hp: HyperParams, dataset: ReviewDataset,
               weights: Dict[str, torch.Tensor], device: torch.device,
               left_out: Set[str]):
    """The program's model with the benchmark's weights, which leave out
    the state-dict keys `left_out` (the model file's `LEFT_OUT`)."""
    model = build_model(hp, dataset.word_vectors, device=device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or set(missing) != set(left_out):
        raise ValueError(f"weights do not fit the model: missing {missing}, "
                         f"unexpected {unexpected}")
    return model


class Session:
    """One cell's program state. `unit()` runs one unit of the window and
    returns its work in the entry's unit (examples, pairs, calls);
    `outputs` holds what the check compares."""

    needs: Tuple[str, ...] = ()   # what the entry asks of the model's file

    def __init__(self, cfg, traffic, corpus, weights, seed, device):
        self.cfg, self.traffic, self.corpus = cfg, traffic, corpus
        self.seed, self.device = seed, device
        self.arch = models.load(cfg["model"], self.needs)
        self.dataset = to_dataset(corpus)
        self.hp = self.dataset.apply_to(hyper_params(cfg, seed))
        self.model = load_model(self.hp, self.dataset, weights, device,
                                self.arch.LEFT_OUT)
        self.outputs: Dict = {}
        self.flop = 0.0        # required FLOP of the units run so far
        self.fwd_bound_s = 0.0  # least time of their forward launches
        self.steps_per_unit = 1


class Train(Session):
    def __init__(self, *a):
        super().__init__(*a)
        hp, dev = self.hp, self.device
        self.opt = loop.make_optimizer(hp, self.model)
        recs = self.dataset.materialize_entity(hp, "train")
        tables = loop.build_entity_tables(hp, self.dataset, dev)
        if loop.fuse_rows_for(hp):
            tables = loop._fuse_tables(tables)
        self.cache = loop.EntityCache(to_device(recs, dev), tables)
        self.scan = (loop.ScanSteps(self.model, self.opt, hp.scan_steps, dev,
                                    self.cache, hp.loss, hp.hinge_margin)
                     if hp.scan_steps > 1 else None)
        self.n = len(recs["rating"])
        self.batcher = Batcher({"row": np.arange(self.n)}, hp.batch_size,
                               shuffle=hp.shuffle_data_every_epoch,
                               seed=hp.seed)
        self.epoch = 0
        self.steps_per_unit = len(self.batcher)
        # the forward work of a step: two sides' towers of B examples
        self.step_fwd_bound_s = 2 * counts.towers_fwd_bound_s(
            self.cfg, hp.batch_size)
        params = dict(self.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        self.unit()       # warm-up epoch: builds kernels, captures the graph
        self.first_steps(p0)
        self.flop = self.fwd_bound_s = 0.0

    def _epoch(self, batcher, gen) -> None:
        loop.train_epoch(self.model, self.opt, batcher, gen, self.device,
                         self.cache, self.scan, self.hp.loss,
                         self.hp.hinge_margin)

    def first_steps(self, p0: Dict[str, torch.Tensor]) -> None:
        """The first steps from the seed's state, through the window's
        call and graph: the parameters go back to `p0` and Adam's state
        to zero in place (the graph captured in the warm-up keeps its
        addresses), then one group of `scan_steps` batches of distinct
        rows runs as one replay, its dropout from a generator seeded
        from the run's seed. Keeps the rows, the generator's seed, the
        group's mean loss (the program's own squared-error sums), Adam's
        first moment and the parameters after the group."""
        if self.scan is None:
            raise ValueError("the train entry checks a ScanSteps group: "
                             "the configuration needs scan_steps > 1")
        b, steps = self.hp.batch_size, self.scan.steps
        rows = stream(self.seed, "check-rows").permutation(self.n)[:b * steps]
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(p0[k])
            for state in self.opt.state.values():
                for v in state.values():
                    if torch.is_tensor(v):
                        v.zero_()
        seed = torch_seed(self.seed, "dropout-check")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._epoch(Batcher({"row": rows}, b), gen)
        n = float(self.scan.n)   # 0 where no step ran: no loss to compare
        self.outputs = {
            "rows": [rows[s * b:(s + 1) * b] for s in range(steps)],
            "gen_seed": seed,
            "loss": float(self.scan.sq_sum) / n if n else float("nan"),
            "exp_avg": {k: self.opt.state[p]["exp_avg"].detach().clone()
                        for k, p in params.items() if p in self.opt.state},
            "p_end": {k: v.detach().clone() for k, v in params.items()}}

    def unit(self) -> int:
        self.epoch += 1
        gen = loop.epoch_generator(self.hp.seed, self.epoch, self.device)
        self._epoch(self.batcher, gen)
        self.flop += self.n * counts.train_flop_per_example(self.cfg)
        self.fwd_bound_s += self.steps_per_unit * self.step_fwd_bound_s
        return self.n


def rank_grids(corpus, traffic: Dict, seed: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(users [M], item grids [M, 1 + negatives]), a row a test user:
    the user's first held-out test item, then `negatives` items drawn
    uniformly without repeats from those the user never rated (the first
    distinct unrated ones of a larger seeded draw)."""
    users, items, _ = corpus.splits["test"]
    first = np.unique(users, return_index=True)[1]
    gu, pos = users[first], items[first]
    rated = np.unique(np.concatenate(
        [u.astype(np.int64) * corpus.num_items + i
         for u, i, _ in corpus.splits.values()]))
    rng = stream(seed, "rank-grids")
    negs, draw = traffic["negatives"], 2 * traffic["negatives"] + 64
    cand = rng.integers(0, corpus.num_items, (len(gu), draw))
    key = gu[:, None].astype(np.int64) * corpus.num_items + cand
    pos_in = np.searchsorted(rated, key).clip(max=len(rated) - 1)
    ok = rated[pos_in] != key
    srt = np.sort(cand, axis=1)
    order = np.argsort(cand, axis=1, kind="stable")
    dup = np.zeros_like(ok)
    dup_sorted = np.concatenate([np.zeros((len(gu), 1), bool),
                                 srt[:, 1:] == srt[:, :-1]], axis=1)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    ok &= ~dup
    if (ok.sum(axis=1) < negs).any():
        raise RuntimeError("too few unrated items drawn for a grid row")
    pick = np.argsort(~ok, axis=1, kind="stable")[:, :negs]
    grid = np.concatenate([pos[:, None],
                           np.take_along_axis(cand, pick, axis=1)], axis=1)
    return gu.astype(np.int32), grid.astype(np.int32)


class Rank(Session):
    needs = ("rank_scores",)

    def __init__(self, *a):
        super().__init__(*a)
        self.model.eval()
        self.tables = loop.build_entity_tables(self.hp, self.dataset,
                                               self.device)
        self.users, self.grid = rank_grids(self.corpus, self.traffic,
                                           self.seed)
        per = self.traffic["rows_per_call"]
        self.calls = len(self.users) // per
        self.order = stream(self.seed, "rank-order").permutation(self.calls)
        self.hp_call = self.hp.replace(eval_ks=tuple(self.traffic["ks"]))
        self.done: List[int] = []
        self.scores: List[np.ndarray] = []
        self.metrics: List[Dict] = []
        self._score_grid = evaluate.score_grid
        evaluate.score_grid = self._recording
        for _ in range(2):      # warm-up: the calls' one batch shape
            self.unit()
        self.done, self.scores, self.metrics = [], [], []
        self.flop = self.fwd_bound_s = 0.0

    def _recording(self, *a, **kw):
        out = self._score_grid(*a, **kw)
        self.scores.append(out)
        return out

    def records(self, call: int) -> Dict[str, np.ndarray]:
        per = self.traffic["rows_per_call"]
        sl = slice(call * per, (call + 1) * per)
        items = self.grid[sl]
        users = np.repeat(self.users[sl][:, None], items.shape[1], axis=1)
        return {"user": users, "item": items,
                "rating": np.zeros(items.shape, np.float32)}

    def unit(self) -> int:
        call = int(self.order[len(self.done) % self.calls])
        recs = self.records(call)
        self.metrics.append(evaluate.eval_ranking(
            self.model, recs, self.hp_call, self.traffic["grid_batch"],
            self.device, self.tables))
        self.done.append(call)
        items = recs["item"]
        pairs = items.size
        n_users = len(np.unique(recs["user"][:, 0]))
        n_items = len(np.unique(items))
        self.flop += counts.rank_flop(self.cfg, n_users, n_items, pairs)
        # the towers the call requires: each distinct user and item once
        self.fwd_bound_s += (counts.towers_fwd_bound_s(self.cfg, n_users)
                             + counts.towers_fwd_bound_s(self.cfg, n_items))
        return pairs

    def close(self) -> None:
        evaluate.score_grid = self._score_grid


ENTRIES = {"train": Train, "rank": Rank}
