"""The port's data layer against the JAX package's: one synthetic corpus
built by the JAX package and saved to an npz, then loaded by each
package. Every record tensor must be byte-identical (same dtype, shape
and bytes), and the Batcher must give the same batches in the same
order."""

import dataclasses

import numpy as np
import pytest

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import Batcher as PortBatcher
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.utils.io import load_npz, save_npz
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher as JaxBatcher
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset
from reviews4rec_tpu.data.synthetic import make_synthetic


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_synthetic(num_users=30, num_items=25, vocab=90, seed=4).save(str(d))
    return JaxDataset.load(str(d)), PortDataset.load(str(d))


def _hps(**kw):
    return JaxHP(**kw), PortHP(**kw)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_config_copy_has_every_field_and_tag():
    jf = {f.name: f.default for f in dataclasses.fields(JaxHP)}
    pf = {f.name: f.default for f in dataclasses.fields(PortHP)}
    assert pf == jf
    for mt in ("deepconn", "deepconn++", "NARRE", "HFT", "MF_dot", "SVD"):
        jh, ph = _hps(model_type=mt, total_users=37, total_items=12,
                      percent_reviews_to_keep=50)
        assert ph.run_tag() == jh.run_tag()
        assert ph.model_path() == jh.model_path()
        assert ph.data_dir() == jh.data_dir()
        assert ph.family == jh.family
        assert (ph.num_user_rows, ph.num_item_rows) == \
            (jh.num_user_rows, jh.num_item_rows)


@pytest.mark.parametrize("model_type", ["deepconn", "NARRE"])
@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_materialize_byte_identical(corpora, model_type, split):
    jd, pd = corpora
    jh, ph = _hps(model_type=model_type, input_length=48,
                  narre_num_reviews=4, narre_num_words=12)
    _same(jd.materialize(jd.apply_to(jh), split),
          pd.materialize(pd.apply_to(ph), split))


def test_candidate_grids_byte_identical(corpora):
    jd, pd = corpora
    jh, ph = _hps(model_type="deepconn++", input_length=40)
    jh, ph = jd.apply_to(jh), pd.apply_to(ph)
    _same(jd.materialize_negs(jh), pd.materialize_negs(ph))
    _same(jd.materialize_wide_negs(jh, 12, seed=3),
          pd.materialize_wide_negs(ph, 12, seed=3))
    users = np.array([0, 4, 9, 29])
    items = np.array([1, 3, 24, 0, 7])
    _same(jd.candidate_grid_records(jh, users, items),
          pd.candidate_grid_records(ph, users, items))
    _same({"m": jd.train_pair_mask(users[:, None], items[None])},
          {"m": pd.train_pair_mask(users[:, None], items[None])})


def test_batcher_order_and_padding(corpora):
    jd, pd = corpora
    jh, ph = _hps(model_type="deepconn", input_length=32)
    jr = jd.materialize(jd.apply_to(jh), "train")
    pr = pd.materialize(pd.apply_to(ph), "train")
    jb = JaxBatcher(jr, 48, shuffle=True, seed=5)
    pb = PortBatcher(pr, 48, shuffle=True, seed=5)
    assert len(jb) == len(pb)
    for _ in range(2):                     # two epochs, two permutations
        batches = list(zip(jb, pb))
        assert len(batches) == len(pb)
        for a, b in batches:
            _same(a, b)
    assert batches[-1][1]["weight"].min() == 0.0   # padded tail


def test_npz_io_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "a.npz")
    save_npz(path, x=np.arange(5, dtype=np.int64), y=np.ones((2, 3)))
    got = load_npz(path)
    assert got["x"].tolist() == [0, 1, 2, 3, 4] and got["y"].shape == (2, 3)


def test_out_of_core_is_not_ported(corpora, tmp_path):
    """The out-of-core store is ported now: `hp.out_of_core` gives the
    in-RAM records, memory-mapped (tests/test_torch_out_of_core.py)."""
    jd, pd = corpora
    jh, ph = _hps(model_type="deepconn", input_length=32,
                  data_root=str(tmp_path))
    disk = pd.materialize(pd.apply_to(ph).replace(out_of_core=True), "test")
    assert all(isinstance(v, np.memmap) for v in disk.values())
    _same(jd.materialize(jd.apply_to(jh), "test"), disk)
