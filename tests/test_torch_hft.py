"""The port's HFT (`reviews4rec_torch.models.hft`) against the JAX
package's on the synthetic corpus, JAX's own test setup (latent 4, 3 EM
iterations of 8 L-BFGS iterations), both on the CPU in float32.

- `build_hft_data`: the token stream, dictionary and counts bitwise.
- The E-step from JAX's Gumbel draws (`jax.random.gumbel` of the key
  `jax.random.categorical` is given): the count tables equal.
- Energy within 1e-5 relative and its gradient within 1e-5 of the
  gradient's largest element, at a random point.
- One M-step of 8 iterations from the same counts: the value at the
  start of each iteration within 1e-4 relative in float32 (f32 sums in
  another order; the line search takes the same branches), within 1e-9
  in float64, params too.
- `run_hft` with JAX's draws fed in, both in float64: metrics equal, the
  artifact files line for line (numbers within 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import hft as port_hft
from reviews4rec_torch.train import lbfgs
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.models import hft as jax_hft

torch.set_num_threads(1)
CPU = "cpu"
SETUP = dict(model_type="HFT", latent_size=4, hft_em_iters=3,
             hft_grad_iters=8, batch_size=32, input_length=64)


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


@pytest.fixture(scope="module")
def setup(dataset, port_dataset):
    jh = dataset.apply_to(JaxHP(**SETUP))
    ph = port_dataset.apply_to(PortHP(**SETUP))
    return (jh, ph, jax_hft.build_hft_data(jh, dataset),
            port_hft.build_hft_data(ph, port_dataset, device=CPU))


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _to_port(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def test_build_hft_data_bitwise(setup):
    jh, ph, jd, pd = setup
    for key in ("users", "items", "ratings", "tok_word", "tok_item",
                "item_words", "neg_users", "neg_items", "votes_per_user",
                "votes_per_item", "vote_weight", "tok_weight"):
        np.testing.assert_array_equal(_np(getattr(pd, key)),
                                      np.asarray(getattr(jd, key)), key)
    assert (pd.num_users, pd.num_items, pd.num_words) == \
        (jd.num_users, jd.num_items, jd.num_words)
    for s, trio in jd.eval_sets.items():
        for a, b in zip(pd.eval_sets[s], trio):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_vocab_cap(port_dataset):
    hp = port_dataset.apply_to(PortHP(model_type="HFT"))
    data = port_hft.build_hft_data(hp, port_dataset, vocab_cap=20, device=CPU)
    assert data.num_words <= 20 and int(data.tok_word.max()) < 20


def test_init_and_e_step_counts_equal(setup):
    jh, ph, jd, pd = setup
    jp, jbg = jax_hft.init_params(jd, jh, lambda *_: None)
    pp, pbg = port_hft.init_params(pd, ph, lambda *_: None)
    for k in jp:
        np.testing.assert_allclose(_np(pp[k]), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_np(pbg), np.asarray(jbg), rtol=1e-6)
    # a point where the topic logits differ per token and topic
    rng = np.random.default_rng(0)
    jp = {**jp, "gamma_i": jnp.asarray(rng.normal(size=jp["gamma_i"].shape)
                                       .astype(np.float32)),
          "topic_words": jnp.asarray(
              rng.normal(size=jp["topic_words"].shape).astype(np.float32))}
    key = jax.random.PRNGKey(5)
    want = jax_hft.e_step(jp, jbg, jd.tok_word, jd.tok_item, jh.latent_size,
                          key)
    g = jax.random.gumbel(key, (jd.tok_word.shape[0], jh.latent_size),
                          jnp.float32)
    got = port_hft.e_step(_to_port(jp), pbg, pd.tok_word, pd.tok_item,
                          ph.latent_size, gumbel=torch.from_numpy(
                              np.array(g)))
    for k in ("word_topic", "item_topic", "topic_counts"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), k)
    assert float(got["item_topic"].sum()) == pd.tok_word.shape[0]


def _point(jd, jh):
    params, _ = jax_hft.init_params(jd, jh, lambda *_: None)
    keys = jax.random.split(jax.random.PRNGKey(1), 7)
    return {
        "alpha": jnp.asarray(0.3), "kappa": jnp.asarray(0.7),
        **{k: 0.1 * jax.random.normal(keys[j], params[k].shape)
           for j, k in enumerate(("beta_u", "beta_i", "gamma_u", "gamma_i",
                                  "topic_words"))}}


@pytest.mark.parametrize("latent_reg", [0.0, 4.0])
def test_energy_and_gradient(setup, latent_reg):
    jh, ph, jd, pd = setup
    jh, ph = (h.replace(latent_reg=latent_reg) for h in (jh, ph))
    params = _point(jd, jh)
    _, bg = jax_hft.init_params(jd, jh, lambda *_: None)
    counts = jax_hft.e_step(params, bg, jd.tok_word, jd.tok_item,
                            jh.latent_size, jax.random.PRNGKey(2))
    jv, jg = jax.value_and_grad(jax_hft.make_energy(jd, jh))(params, counts,
                                                             bg)
    penergy = port_hft.make_energy(pd, ph)
    pc = _to_port(counts)
    pv, pg = lbfgs.value_and_grad(
        lambda p: penergy(p, pc, torch.from_numpy(np.asarray(bg))),
        _to_port(params))
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-5)
    for k in jg:
        scale = max(1.0, float(jnp.abs(jg[k]).max()))
        np.testing.assert_allclose(_np(pg[k]), np.asarray(jg[k]),
                                   atol=1e-5 * scale, err_msg=k)


def _jax_m_step_values(jd, jh, params, counts, bg):
    fn = lambda p: jax_hft.make_energy(jd, jh)(p, counts, bg)
    opt = optax.lbfgs()
    state = opt.init(params)
    vg = optax.value_and_grad_from_state(fn)
    values = []
    for _ in range(jh.hft_grad_iters):
        value, grad = vg(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=fn)
        params = optax.apply_updates(params, updates)
        values.append(float(value))
    return {k: np.asarray(v) for k, v in params.items()}, values


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_m_step_values_per_iteration(setup, dtype):
    """In float32 the values agree within 1e-4 relative and the params
    within 1e-3 (4.0e-4 measured on beta_i: f32 rounding of the sums in
    another order, carried through 8 iterations along flat directions);
    in float64 (JAX under `enable_x64`) both agree within 1e-9, the
    algorithm itself."""
    import dataclasses
    jh, ph, jd, pd = setup
    params, bg = jax_hft.init_params(jd, jh, lambda *_: None)
    counts = jax_hft.e_step(params, bg, jd.tok_word, jd.tok_item,
                            jh.latent_size, jax.random.PRNGKey(0))
    np_dt = np.dtype(dtype)
    params, counts, bg = ({k: np.asarray(v, np_dt) for k, v in t.items()}
                          for t in (params, counts, {"bg": bg}))
    bg = bg["bg"]
    with jax.enable_x64(dtype == "float64"):
        jd64 = dataclasses.replace(
            jd, ratings=jnp.asarray(np.asarray(jd.ratings, np_dt)),
            vote_weight=jnp.asarray(np.asarray(jd.vote_weight, np_dt)))
        jp, jvals = _jax_m_step_values(
            jd64, jh, {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in counts.items()}, jnp.asarray(bg))
    t_dt = getattr(torch, dtype)
    pd64 = dataclasses.replace(pd, ratings=pd.ratings.to(t_dt),
                               vote_weight=pd.vote_weight.to(t_dt))
    penergy = port_hft.make_energy(pd64, ph)
    pc = {k: torch.from_numpy(v.copy()) for k, v in counts.items()}
    pbg = torch.from_numpy(bg.copy())
    p0 = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pp, pvals = lbfgs.minimize(lambda p: penergy(p, pc, pbg), p0,
                               ph.hft_grad_iters)
    exact = dtype == "float64"
    np.testing.assert_allclose([float(v) for v in pvals], jvals,
                               rtol=1e-9 if exact else 1e-4)
    for k in jp:
        assert pp[k].dtype == t_dt
        np.testing.assert_allclose(_np(pp[k]), jp[k], rtol=0,
                                   atol=1e-9 if exact else 1e-3, err_msg=k)
    out, last = port_hft.make_m_step(penergy, ph.hft_grad_iters)(p0, pc, pbg)
    assert float(last) == float(pvals[-1])


def _read(path):
    with open(path) as f:
        return [line.split() for line in f]


def _gumbels(jh, data, n, dtype):
    """JAX's Gumbel noise of the fit's first n E-steps: the keys
    `HFTTrainer.fit` splits, drawn as `jax.random.categorical` draws in
    the logits' type."""
    shape = (data.tok_word.shape[0], jh.latent_size)
    rng = jax.random.PRNGKey(jh.seed)
    out = []
    for _ in range(n):
        rng, r = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(r, shape, dtype)))
    return out


def test_run_hft_metrics_and_artifacts(setup, dataset, port_dataset,
                                       tmp_path):
    """Both in float64 (JAX under `enable_x64`, the port's data in
    float64; the JAX package keeps its data f32, whose values are exact
    in f64), where the M-steps agree to rounding (1e-13) and the E-steps
    draw the same topics. In float32 the two runs part at the first
    E-step: a token whose two best topics are closer than the M-steps'
    f32 difference (about 1e-4) may take the other one, and EM carries
    that on (test MSE 0.6937 against 0.6911 after 3 iterations)."""
    jh, ph, jd, pd = setup
    jh = jh.replace(log_dir=str(tmp_path / "jax"), eval_num_negs=20)
    ph = ph.replace(log_dir=str(tmp_path / "port"), eval_num_negs=20)
    with jax.enable_x64(True):
        want = jax_hft.run_hft(jh, dataset)
        gumbels = _gumbels(jh, jd, jh.hft_em_iters + 1, jnp.float64)
    got = port_hft.run_hft(ph, port_dataset, device=CPU, gumbels=gumbels,
                           dtype=torch.float64)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        assert abs(got[0][k] - want[0][k]) <= 1e-4, k
    for gmap, wmap in zip(got[1:], want[1:]):
        assert sorted(gmap) == sorted(wmap)
        for c in wmap:
            np.testing.assert_allclose(gmap[c], wmap[c], atol=1e-4)
    tag = jh.run_tag()
    assert ph.run_tag() == tag
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        if name.endswith(".log"):
            continue
        jl = _read(tmp_path / "jax" / name)
        pl = _read(tmp_path / "port" / name)
        assert len(pl) == len(jl), name
        for a, b in zip(pl, jl):
            assert len(a) == len(b), name
            np.testing.assert_allclose(np.asarray(a, float),
                                       np.asarray(b, float), atol=1e-4)


def test_api_run_dispatches_hft(port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(**SETUP)).replace(
        hft_em_iters=1, hft_grad_iters=2, log_dir=str(tmp_path))
    metrics, ucm, icm = port_api.run(hp, port_dataset, device=CPU)
    assert set(metrics) == {"MSE", "HR@1", "dataset"} and ucm and icm
    assert os.path.exists(os.path.join(str(tmp_path),
                                       hp.run_tag() + "_saved_metrics.txt"))


def test_mesh_is_refused(port_dataset):
    """HFT on a mesh runs on the process group of its ranks
    (tests/test_torch_parallel.py); without one it never runs as one
    process: the ValueError naming `parallel.distributed.initialize`."""
    hp = port_dataset.apply_to(PortHP(**SETUP)).replace(mesh_shape=(2, 1))
    with pytest.raises(ValueError, match="parallel.distributed.initialize"):
        port_hft.HFTTrainer(hp, port_dataset, device=CPU)


def test_hft_params_carry_across(setup):
    """`weights.hft_params` brings JAX's params and background over as
    the port's tensors: the energy at them equals JAX's."""
    from reviews4rec_torch.weights import hft_params
    jh, ph, jd, pd = setup
    params = _point(jd, jh)
    _, bg = jax_hft.init_params(jd, jh, lambda *_: None)
    counts = jax_hft.e_step(params, bg, jd.tok_word, jd.tok_item,
                            jh.latent_size, jax.random.PRNGKey(3))
    pp, pbg = hft_params(params, bg, device=CPU)
    assert pp["gamma_i"].dtype == torch.float32 and pbg.shape == bg.shape
    want = float(jax_hft.make_energy(jd, jh)(params, counts, bg))
    got = float(port_hft.make_energy(pd, ph)(pp, _to_port(counts), pbg))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lambda_zero_init_takes_jax_gammas(setup):
    """At lambda 0 the gammas start U(0, 1): JAX's draws handed over as
    `gamma_init` give JAX's init; the port's own draws lie in [0, 1)."""
    jh, ph, jd, pd = setup
    jh, ph = jh.replace(lamda=0.0), ph.replace(lamda=0.0)
    jp, _ = jax_hft.init_params(jd, jh, lambda *_: None)
    pp, _ = port_hft.init_params(pd, ph, lambda *_: None,
                                 gamma_init=(jp["gamma_u"], jp["gamma_i"]))
    for k in jp:
        np.testing.assert_allclose(_np(pp[k]), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    own, _ = port_hft.init_params(pd, ph, lambda *_: None)
    g = own["gamma_i"]
    assert float(g.min()) >= 0.0 and float(g.max()) < 1.0
    assert not torch.equal(g, pp["gamma_i"])
