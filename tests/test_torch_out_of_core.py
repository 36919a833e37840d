"""The port's out-of-core record store (`hp.out_of_core`): the records
built chunk by chunk into memory-mapped .npy files are byte-identical to
the in-RAM ones and to the JAX package's store, stream through the
Batcher, and train and evaluate to the in-RAM run's metrics, exactly,
on the pointwise and the ranking-loss paths and from the doc cache."""

import warnings

import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import Batcher
from reviews4rec_torch.data.corpus import ReviewDataset as PortDataset
from reviews4rec_torch.train.loop import build_doc_cache
from reviews4rec_torch.utils.device import to_device
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset

torch.set_num_threads(1)
CPU = torch.device("cpu")
GEOM = dict(batch_size=32, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16)


@pytest.fixture(scope="module")
def corpora(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return JaxDataset.load(str(d)), PortDataset.load(str(d))


def _hp(pd, tmp_path, **kw):
    return pd.apply_to(PortHP(**dict(GEOM, **kw),
                              data_root=str(tmp_path / "data"),
                              log_dir=str(tmp_path / "logs"),
                              model_dir=str(tmp_path / "models")))


def _same(ram, disk):
    assert set(ram) <= set(disk)
    for k in ram:
        assert isinstance(disk[k], np.memmap), k
        assert not disk[k].flags.writeable, k
        assert disk[k].dtype == ram[k].dtype, k
        assert np.array_equal(np.asarray(disk[k]), ram[k]), k


def test_disk_store_matches_ram(tmp_path, corpora):
    _, pd = corpora
    hp = _hp(pd, tmp_path, model_type="deepconn", materialize_chunk_rows=3)
    ram = pd.materialize(hp, "train")
    disk = pd.materialize_to_disk(hp, "train", root=str(tmp_path / "r"))
    assert set(disk) == set(ram)
    _same(ram, disk)
    # reopening reads the store back, no rebuild
    pd.materializer = None
    _same(ram, pd.materialize_to_disk(hp, "train", root=str(tmp_path / "r")))
    assert pd.materializer is None
    # hp.out_of_core routes materialize to the store under data_dir()
    _same(ram, pd.materialize(hp.replace(out_of_core=True), "train"))
    assert (tmp_path / "data" / "synthetic" / "5_core" / "records").is_dir()


@pytest.mark.parametrize("mt,split", [("NARRE", "val"), ("transnet", "test"),
                                      ("MPCN", "train")])
def test_layouts_disk_match_ram_and_jax(tmp_path, corpora, mt, split):
    jd, pd = corpora
    hp = _hp(pd, tmp_path, model_type=mt, materialize_chunk_rows=5,
             mpcn_dmax=3, mpcn_smax=6)
    ram = pd.materialize(hp, split)
    disk = pd.materialize_to_disk(hp, split, root=str(tmp_path / "port"))
    _same(ram, disk)
    jh = jd.apply_to(JaxHP(**{f: getattr(hp, f) for f in (
        "model_type", "input_length", "narre_num_reviews", "narre_num_words",
        "mpcn_dmax", "mpcn_smax", "materialize_chunk_rows")}))
    jdisk = jd.materialize_to_disk(jh, split, root=str(tmp_path / "jax"))
    assert sorted(jdisk) == sorted(disk)
    for k in disk:
        a = (tmp_path / "port").glob(f"*/{k}.npy")
        b = (tmp_path / "jax").glob(f"*/{k}.npy")
        assert next(a).read_bytes() == next(b).read_bytes(), k


def test_batcher_streams_memmap(tmp_path, corpora):
    _, pd = corpora
    hp = _hp(pd, tmp_path, model_type="deepconn", materialize_chunk_rows=4)
    ram = pd.materialize(hp, "train")
    disk = pd.materialize_to_disk(hp, "train", root=str(tmp_path / "r"))
    for br, bd in zip(Batcher(ram, 8, shuffle=True, seed=3),
                      Batcher(dict(disk), 8, shuffle=True, seed=3)):
        for k in br:
            assert np.array_equal(br[k], bd[k]), k


def test_read_only_records_place_without_warning(tmp_path, corpora):
    """Placing memory-mapped records copies them (torch tensors are
    writable): no warning, the same values, the store untouched."""
    _, pd = corpora
    hp = _hp(pd, tmp_path, model_type="deepconn", out_of_core=True)
    disk = pd.materialize(hp, "val")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        placed = to_device(dict(disk), CPU)
        staged = to_device({k: v[:5] for k, v in disk.items()}, CPU)
        cache = build_doc_cache(dict(disk), pd.word_vectors, torch.float32,
                                CPU, chunk_words=100)
    for k, v in disk.items():
        assert np.array_equal(placed[k].numpy(), v), k
        assert np.array_equal(staged[k].numpy(), v[:5]), k
    want = torch.from_numpy(pd.word_vectors)[torch.from_numpy(
        np.array(disk["user_doc"])).long()]
    assert torch.equal(cache["user_doc"], want)


def test_grids_disk_match_ram(tmp_path, corpora):
    """The stored 1+5 sets, the wide 1+12 sets and the ranking loss's
    train grids (leakage removal included) from the store, user side at
    lead (M, 1), item side at (M, C)."""
    _, pd = corpora
    hp = _hp(pd, tmp_path, model_type="NARRE", materialize_chunk_rows=7)
    ooc = hp.replace(out_of_core=True)
    _same(pd.materialize_negs(hp), pd.materialize_negs(ooc))
    _same(pd.materialize_wide_negs(hp, 12, seed=3),
          pd.materialize_wide_negs(ooc, 12, seed=3))
    ram = pd.materialize_train_negs(hp, "train", seed=4)
    disk = pd.materialize_train_negs(ooc, "train", seed=4)
    _same(ram, disk)
    assert disk["user_doc"].shape[1] == 1 and disk["user_doc"].ndim == 4
    assert disk["item_doc"].shape[1] == hp.num_negs + 1
    again = pd.materialize_train_negs(ooc, "train", seed=4)
    assert np.array_equal(np.asarray(again["item_doc"]), ram["item_doc"])


@pytest.mark.parametrize("flags", [
    dict(),
    dict(loss="BPR", batch_size=16),
    dict(cache_doc_embeds=True),
    dict(use_pallas=True, pallas_fuse_gather=True, scan_steps=3),
], ids=["pointwise", "bpr", "doc_cache", "fused_scan"])
def test_api_run_out_of_core_equals_ram(tmp_path, corpora, flags):
    _, pd = corpora
    hp = _hp(pd, tmp_path, model_type="deepconn", epochs=1, **flags)
    m_ram, _, _ = port_api.run(hp, pd, device=CPU)
    m_disk, _, _ = port_api.run(hp.replace(out_of_core=True,
                                           materialize_chunk_rows=16),
                                pd, device=CPU)
    for k in ("MSE", "HR@1", "HR@10"):
        assert m_disk[k] == m_ram[k], k
