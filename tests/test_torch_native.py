"""The port's native (C++/OpenMP) materializer: its records equal the
port's numpy materializer's and the JAX package's `materialize`, byte
for byte, for every doc layout (deepconn's concatenated doc, NARRE's and
MPCN's review rows, transnet's `this_doc`), every split and the
candidate grids; it builds from the port's own source into `build/`."""

import numpy as np
import pytest

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import native
from reviews4rec_torch.data.corpus import ReviewDataset as PortDataset
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset
from reviews4rec_tpu.data.synthetic import make_synthetic

GEOM = dict(input_length=48, narre_num_reviews=4, narre_num_words=12,
            mpcn_dmax=5, mpcn_smax=7)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_synthetic(num_users=30, num_items=25, vocab=90, seed=6).save(str(d))
    return JaxDataset.load(str(d)), PortDataset.load(str(d))


def _hps(jd, pd, mt):
    return (jd.apply_to(JaxHP(model_type=mt, **GEOM)),
            pd.apply_to(PortHP(model_type=mt, **GEOM)))


def _numpy_only(monkeypatch, pd):
    """The port's dataset with the native path off: `_text_records`
    falls back to the numpy materializer."""
    monkeypatch.setattr(PortDataset, "_native_text",
                        staticmethod(lambda *a, **k: None))
    pd._cache.clear()


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), \
            f"{k}: first diff at {np.argwhere(x != y)[:3]}"


def test_native_builds_from_the_port_s_own_source():
    assert native.available()
    assert native.SOURCE.name == "materialize.cc"
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parent.parent.name == "reviews4rec_torch"
    lib = native.library_path()
    assert lib.exists() and lib.parent.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("mt", ["deepconn", "NARRE", "transnet", "MPCN"])
@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_native_equals_numpy_equals_jax(corpora, monkeypatch, mt, split):
    jd, pd = corpora
    jh, ph = _hps(jd, pd, mt)
    pd._cache.clear()
    nat = {k: v.copy() for k, v in pd.materialize(ph, split).items()}
    assert pd.materializer == "native"
    if mt == "transnet":
        assert nat["this_doc"].any() and nat["this_doc"].ndim == 2
    _same(nat, jd.materialize(jh, split))
    _numpy_only(monkeypatch, pd)
    _same(nat, pd.materialize(ph, split))
    assert pd.materializer == "numpy"
    pd._cache.clear()


@pytest.mark.parametrize("mt", ["deepconn++", "NARRE"])
def test_native_grids_equal(corpora, monkeypatch, mt):
    """Ranking grids (the stored 1+5 sets, the wide 1+12 sets, the
    ranking loss's train grids with their leakage removal) and a
    serving grid."""
    jd, pd = corpora
    jh, ph = _hps(jd, pd, mt)

    def grids(ds, hp):
        return [ds.materialize_negs(hp),
                ds.materialize_wide_negs(hp, 12, seed=3),
                ds.materialize_train_negs(hp, "train", seed=2),
                ds.candidate_grid_records(hp, np.array([0, 5, 29]),
                                          np.array([3, 0, 24, 7]))]

    pd._cache.clear()
    nat = [{k: v.copy() for k, v in g.items()} for g in grids(pd, ph)]
    assert pd.materializer == "native"
    for got, want in zip(nat, grids(jd, jh)):
        _same(got, want)
    _numpy_only(monkeypatch, pd)
    for got, want in zip(nat, grids(pd, ph)):
        _same(got, want)
    pd._cache.clear()


def test_native_threads_and_empty_call(corpora):
    assert native.num_threads() >= 1
    _, pd = corpora
    empty = np.zeros(0, np.int32)
    out = native.materialize_records(pd._flat(), empty, empty, empty, empty,
                                     empty, 1, 16, 10, 31, 26)
    assert out["user_doc"].shape == (0, 1, 16)
    assert out["items_reviewed"].shape == (0, 10)
