"""The port's preprocessing against the JAX package's on the same raw
records: tokenizer and vocabulary, k-core filter, negative sets, the
whole pipeline's `corpus.npz` (integer arrays bitwise, word vectors
within 1e-6 on the numpy SGNS backend), corpora crossing between the two
`ReviewDataset.load`s, `encode_text`, RateBeer parsing, the CLI, the
torch SGNS body on JAX's own random draws (within 1e-5 of
`_train_sgns_jax` after 2 epochs) and `make_synthetic`."""

import json

import jax
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import make_synthetic as port_synthetic
from reviews4rec_torch.data import preprocess as pp
from reviews4rec_torch.data import tokenizer as ptok
from reviews4rec_torch.data.corpus import ReviewDataset as PortDataset
from reviews4rec_torch.data.corpus import Split as PortSplit
from reviews4rec_torch.utils.io import load_npz
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data import preprocess as jpp
from reviews4rec_tpu.data import tokenizer as jtok
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset
from reviews4rec_tpu.data.corpus import Split as JaxSplit
from reviews4rec_tpu.data.synthetic import make_synthetic as jax_synthetic

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUIET = dict(verbose=lambda *_: None)
GOLDEN = {
    "I LOVED it! Don't you?": ["i", "loved", "it", "don", "t", "you"],
    "great-sounding strings, really": ["great", "sounding", "strings",
                                       "really"],
    "": [],
    "win 100 strings now!": ["win", "strings", "now"],
    "5-star product, A+ quality": ["star", "product", "a", "quality"],
    "it's the BEST (really)": ["it", "s", "the", "best", "really"],
    "won't    break": ["won", "t", "break"],
    "2020": [],
    "caf\xe9 \xfcber na\xefve": ["caf", "ber", "na", "ve"],
}


def _raw_corpus(num_users=30, num_items=20, per_user=8, seed=0):
    """Amazon-style records, as tests/test_preprocess.py builds them."""
    rng = np.random.default_rng(seed)
    words = ["guitar", "strings", "sound", "great", "cheap", "broke",
             "love", "quality", "bad", "amp"]
    recs = []
    for u in range(num_users):
        items = rng.choice(num_items, size=per_user, replace=False)
        for i in items:
            recs.append({
                "reviewerID": f"u{u}",
                "asin": f"i{i}",
                "overall": float(rng.integers(1, 6)),
                "reviewText": " ".join(rng.choice(words, size=12)),
            })
    return recs


def _random_text(rng, n):
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJ0123456789 ,.'!-")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(0, 60))))
            for _ in range(n)]


def _same_arrays(a, b, float_tol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k == "word_vectors":
            np.testing.assert_allclose(x, y, atol=float_tol, rtol=0,
                                       err_msg=k)
        else:
            assert np.array_equal(x, y), k


def test_tokenizer_equal_on_golden_and_random_text():
    for text, want in GOLDEN.items():
        assert ptok.tokenize(text) == jtok.tokenize(text) == want, text
    for text in _random_text(np.random.default_rng(0), 300):
        assert ptok.tokenize(text) == jtok.tokenize(text), text


@pytest.mark.parametrize("cap", [1, 2, 7, 50000])
def test_build_vocab_equal(cap):
    rng = np.random.default_rng(cap)
    words = [f"w{j}" for j in range(40)]
    zipf = 1.0 / np.arange(1, 41)
    lists = [list(rng.choice(words, size=int(rng.integers(0, 30)),
                             p=zipf / zipf.sum())) for _ in range(50)]
    assert ptok.build_vocab(lists, cap=cap) == jtok.build_vocab(lists,
                                                                cap=cap)
    assert ptok.build_vocab([], cap=cap) == jtok.build_vocab([], cap=cap)


@pytest.mark.parametrize("k_core", [2, 3, 5])
def test_k_core_filter_equal(k_core):
    recs = _raw_corpus(num_users=25, num_items=40, per_user=6, seed=k_core)
    recs = recs[:-17]   # some users and items fall below the core
    assert pp.k_core_filter(recs, k_core) == jpp.k_core_filter(recs, k_core)


def test_build_negatives_equal():
    rng = np.random.default_rng(3)
    n = 400
    triples = np.stack([rng.integers(0, 30, n), rng.integers(0, 50, n),
                        rng.choice([1.0, 2.0, 3.0, 4.0, 5.0], n)], 1)
    for num_negs, seed in ((5, 0), (3, 7)):
        got = pp.build_negatives(PortSplit.from_triples(triples),
                                 num_negs=num_negs, seed=seed)
        want = jpp.build_negatives(JaxSplit.from_triples(triples),
                                   num_negs=num_negs, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    empty = pp.build_negatives(PortSplit.from_triples([]))
    assert [a.shape for a in empty] == [(0,), (0, 6)]


@pytest.mark.parametrize("percent", [100, 40])
def test_preprocess_numpy_corpus_equal(tmp_path, percent):
    """Every array of the saved corpus: integers bitwise, word vectors
    within 1e-6."""
    recs = _raw_corpus(num_users=40, num_items=25, per_user=10)
    kw = dict(k_core=3, percent_reviews_to_keep=percent, w2v_epochs=2,
              seed=1)
    pp.preprocess(recs, w2v_backend="numpy", **kw, **QUIET).save(
        str(tmp_path / "port"))
    jpp.preprocess(recs, w2v_backend="numpy", **kw, **QUIET).save(
        str(tmp_path / "jax"))
    _same_arrays(load_npz(str(tmp_path / "port" / "corpus.npz")),
                 load_npz(str(tmp_path / "jax" / "corpus.npz")), 1e-6)


def test_corpus_files_cross_between_packages(tmp_path):
    """A corpus the port writes loads in the JAX package and the other
    way round, with the same records and vocabulary."""
    recs = _raw_corpus(num_users=40, num_items=25, per_user=10, seed=2)
    pp.preprocess(recs, k_core=3, w2v_epochs=1, w2v_backend="numpy",
                  **QUIET).save(str(tmp_path / "port"))
    jpp.preprocess(recs, k_core=3, w2v_epochs=1, **QUIET).save(
        str(tmp_path / "jax"))
    for d in ("port", "jax"):
        jd = JaxDataset.load(str(tmp_path / d))
        pd = PortDataset.load(str(tmp_path / d))
        assert pd.vocab == jd.vocab and pd.vocab
        for mt in ("deepconn", "NARRE"):
            geom = dict(model_type=mt, input_length=40,
                        narre_num_reviews=3, narre_num_words=8)
            jr = jd.materialize(jd.apply_to(JaxHP(**geom)), "train")
            pr = pd.materialize(pd.apply_to(PortHP(**geom)), "train")
            for k in jr:
                assert np.array_equal(jr[k], pr[k]), (d, mt, k)
    # a port-written corpus re-saved by JAX is the same archive
    JaxDataset.load(str(tmp_path / "port")).save(str(tmp_path / "again"))
    _same_arrays(load_npz(str(tmp_path / "port" / "corpus.npz")),
                 load_npz(str(tmp_path / "again" / "corpus.npz")))


def test_encode_text_equal(tmp_path):
    recs = _raw_corpus(num_users=40, num_items=25, per_user=10)
    jpp.preprocess(recs, k_core=3, w2v_epochs=1, **QUIET).save(
        str(tmp_path))
    jd, pd = JaxDataset.load(str(tmp_path)), PortDataset.load(str(tmp_path))
    texts = list(GOLDEN) + ["Great GUITAR, cheap amp; broke zzz"] + \
        _random_text(np.random.default_rng(1), 50)
    for text in texts:
        got, want = pd.encode_text(text), jd.encode_text(text)
        assert got.dtype == want.dtype and np.array_equal(got, want), text
    assert pd.encode_text("great zzzunknownzzz GREAT").tolist() == \
        [pd.vocab["great"], 0, pd.vocab["great"]]
    pd.vocab = None
    with pytest.raises(ValueError, match="vocabulary"):
        pd.encode_text("great")


def test_load_ratebeer_equal(tmp_path):
    raw = (
        "beer/name: Test Ale\n"
        "beer/beerId: 101\n"
        "review/profileName: alice\n"
        "review/overall: 13/20\n"
        "review/text: pours a hazy caf\xe9 amber\n"
        "\n"
        "beer/beerId: 102\n"
        "review/profileName: bob\n"
        "review/overall: 20/20\n"
        "review/text: perfect: just perfect\n"
        "\n"
        "beer/beerId: 103\n"
        "review/overall: 7/20\n"
        "\n"
        "beer/beerId: 104\n"
        "review/profileName: carol\n"
        "review/overall: 7/20\n"
    )
    p = tmp_path / "beer.txt"
    p.write_bytes(raw.encode("latin-1"))
    got = pp.load_ratebeer(str(p))
    assert got == jpp.load_ratebeer(str(p))
    assert [r["asin"] for r in got] == ["101", "102", "104"]
    assert got[0]["reviewText"] == "pours a hazy caf\xe9 amber"
    assert got[1]["reviewText"] == "perfect: just perfect"
    assert got[2] == {"asin": "104", "reviewerID": "carol",
                      "overall": 7.0, "reviewText": ""}


@pytest.mark.parametrize("gz", [False, True])
def test_cli_writes_jax_s_corpus(tmp_path, capsys, gz):
    """`python -m reviews4rec_torch.data.preprocess ... --device cpu`:
    the output path and every array of JAX's CLI on the same dump."""
    import gzip
    raw = tmp_path / ("raw.json.gz" if gz else "raw.json")
    opener = gzip.open if gz else open
    with opener(raw, "wt") as f:
        for r in _raw_corpus(num_users=35, num_items=20, per_user=9):
            f.write(json.dumps(r) + "\n")
        f.write("\n")
    argv = ["mini", str(raw), "--k-core", "3", "--w2v-epochs", "1",
            "--percent", "50"]
    pp.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    out = tmp_path / "port" / "mini" / "3_core" / "50_percent"
    said = capsys.readouterr().out.strip().splitlines()
    assert said[-1] == f"saved {out}/corpus.npz"
    jpp.main(argv + ["--out", str(tmp_path / "jax")])
    assert capsys.readouterr().out.strip().splitlines()[:-1] == said[:-1]
    _same_arrays(load_npz(str(out / "corpus.npz")),
                 load_npz(str(tmp_path / "jax" / "mini" / "3_core" /
                              "50_percent" / "corpus.npz")), 1e-6)


def test_cli_device_defaults_to_the_card(tmp_path):
    raw = tmp_path / "raw.json"
    raw.write_text("")
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pp.main(["mini", str(raw), "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        pp.main(["mini", str(raw), "--w2v-backend", "jax"])


class JaxDraws:
    """The permutations and uniforms `_train_sgns_jax` draws: per epoch
    `key, pk, nk = split(key, 3)`, `permutation(pk, N)`, and per batch i
    `uniform(fold_in(nk, i), (bs, negatives))`."""

    def __init__(self, seed, epochs, n_pad, n_batches, bs, negatives):
        key = jax.random.PRNGKey(seed)
        self.perms, self.unis = [], []
        for _ in range(epochs):
            key, pk, nk = jax.random.split(key, 3)
            self.perms.append(np.array(jax.random.permutation(pk, n_pad)))
            self.unis.append([np.array(jax.random.uniform(
                jax.random.fold_in(nk, i), (bs, negatives)))
                for i in range(n_batches)])

    def permutation(self, epoch, n):
        assert n == len(self.perms[epoch])
        return torch.as_tensor(self.perms[epoch].astype(np.int64))

    def uniform(self, epoch, batch, shape):
        u = self.unis[epoch][batch]
        assert u.shape == tuple(shape)
        return torch.as_tensor(u)


def sgns_case(n=2000, vocab=60, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    centers = 1 + rng.choice(vocab, size=n, p=zipf / zipf.sum())
    contexts = 1 + rng.choice(vocab, size=n, p=zipf / zipf.sum())
    freq = np.bincount(contexts, minlength=vocab + 1).astype(np.float64)
    probs = freq ** 0.75
    probs[0] = 0.0
    probs /= probs.sum()
    vec_in0 = ((rng.random((vocab + 1, dim), np.float32) - 0.5) / dim)
    return centers, contexts, probs, vec_in0


@pytest.mark.parametrize("n,negatives", [(2000, 5), (700, 16)])
def test_sgns_torch_body_matches_jax_on_jax_draws(n, negatives):
    centers, contexts, probs, vec_in0 = sgns_case(n=n)
    # lr 0.5 (10x the default) moves the table enough to test the body
    dim, epochs, lr, seed = vec_in0.shape[1], 2, 0.5, 0
    want = jpp._train_sgns_jax(centers, contexts, probs, vec_in0, dim,
                               epochs, negatives, lr, seed)
    bs, n_batches = pp.sgns_batching(n)
    draws = JaxDraws(seed, epochs, n_batches * bs, n_batches, bs, negatives)
    got = pp._train_sgns_torch(centers, contexts, probs, vec_in0, dim,
                               epochs, negatives, lr, seed, device=CPU,
                               draws=draws)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - vec_in0).max() > 1e-3      # it trained
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sgns_torch_backend_is_seeded():
    centers, contexts, probs, vec_in0 = sgns_case(n=900)
    args = (centers, contexts, probs, vec_in0, 16, 2, 5, 0.05)
    a = pp._train_sgns_torch(*args, 3, device=CPU)
    b = pp._train_sgns_torch(*args, 3, device=CPU)
    c = pp._train_sgns_torch(*args, 4, device=CPU)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_sgns_torch_backend_learns_signal():
    """Two word communities whose sequences never mix end up more
    similar within than across (JAX's test of its jax backend)."""
    rng = np.random.default_rng(0)
    k = 100
    seqs = []
    for _ in range(400):
        base = 1 + rng.integers(0, 2) * k
        seqs.append(base + rng.integers(0, k, size=30))
    vecs = pp.train_word2vec(seqs, num_words=2 * k, epochs=20,
                             backend="torch", seed=0, device=CPU)
    assert vecs.shape == (2 * k + 1, 64)
    assert np.all(vecs[0] == 0.0) and np.isfinite(vecs).all()
    v = vecs[1:]
    vc = v - v.mean(0)
    nv = vc / (np.linalg.norm(vc, axis=1, keepdims=True) + 1e-9)
    sim = nv @ nv.T
    within = (sim[:k, :k].mean() + sim[k:, k:].mean()) / 2
    across = sim[:k, k:].mean()
    assert within > across + 0.1, (within, across)


def test_train_word2vec_backends():
    seqs = [np.arange(1, 20), np.arange(5, 30)]
    a = pp.train_word2vec(seqs, 30, dim=8, epochs=1, backend="numpy")
    b = jpp.train_word2vec(seqs, 30, dim=8, epochs=1, backend="numpy")
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="auto, numpy or torch"):
        pp.train_word2vec(seqs, 30, backend="jax")
    # no pair at all: the centered init table, as JAX
    np.testing.assert_array_equal(
        pp.train_word2vec([np.array([3])], 5, dim=4, backend="torch",
                          device=CPU),
        jpp.train_word2vec([np.array([3])], 5, dim=4, backend="jax"))


@pytest.mark.parametrize("seed", [0, 7])
def test_make_synthetic_equal(tmp_path, seed):
    kw = dict(num_users=30, num_items=25, vocab=90, seed=seed)
    port_synthetic(**kw).save(str(tmp_path / "port"))
    jax_synthetic(**kw).save(str(tmp_path / "jax"))
    _same_arrays(load_npz(str(tmp_path / "port" / "corpus.npz")),
                 load_npz(str(tmp_path / "jax" / "corpus.npz")))
