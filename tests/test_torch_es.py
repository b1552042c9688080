"""Port parity: the ES pieces — noise, member perturbations, the update,
fitness shaping, the caps, prompt sampling and the in-step health metrics.

The JAX package's noise draws are handed to the port
(``weights.from_jax.tree_from_numpy``); inputs come from a numpy seed.
Bound rtol/atol 1e-5; measured max abs error ≤ 3.0e-7. Constant rewards
must give exactly zero fitness on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.es import caps as jcaps
from hyperscalees_t2i_tpu.es import noiser as jnoiser
from hyperscalees_t2i_tpu.es import sampling as jsampling
from hyperscalees_t2i_tpu.es import scoring as jscoring
from hyperscalees_t2i_tpu.lora import FactoredDelta as JFD
from hyperscalees_t2i_tpu.models import nn as jnn
from hyperscalees_t2i_tpu.obs import es_health as jhealth
from hyperscalees_t2i_tpu.ops.quant import quantize_kernel as jquantize
from hyperscalees_t2i_tpu_torch.es import caps, noiser, sampling, scoring
from hyperscalees_t2i_tpu_torch.lora import FactoredDelta, slice_layer
from hyperscalees_t2i_tpu_torch.models import nn as tnn
from hyperscalees_t2i_tpu_torch.obs import es_health
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
POP, RANK = 5, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _theta(seed=0):
    """A flat adapter with a 2D and a stacked 3D target (Sana's shapes)."""
    r = np.random.default_rng(seed)
    f = lambda *s: jnp.asarray(r.normal(size=s) * 0.1, jnp.float32)  # noqa: E731
    return {"blocks/attn1/to_q": {"a": f(2, 12, 4), "b": f(2, 4, 10)},
            "proj_out": {"a": f(12, 4), "b": f(4, 6)}}


def _cfgs(noise_dtype="float32", antithetic=True):
    kw = dict(sigma=0.05, lr_scale=1.5, rank=RANK, antithetic=antithetic, noise_dtype=noise_dtype)
    return jnoiser.EggRollConfig(**kw), noiser.EggRollConfig(**kw)


def _assert_tree_close(t, j):
    for p in j:
        for f in j[p]:
            np.testing.assert_allclose(t[p][f].float().numpy(), np.asarray(j[p][f], np.float32), **TOL)


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
def test_sample_noise_shapes_and_dtypes(noise_dtype):
    theta = adapter_from_jax(_np(_theta()), "cpu")
    theta["conv"] = {"a": torch.zeros(3, 3, 4, 2), "b": torch.zeros(2, 5)}
    _, cfg = _cfgs(noise_dtype)
    noise = noiser.sample_noise(threefry.prng_key(0, "cpu"), theta, POP, cfg)
    base = noiser.base_pop_size(POP, True)
    dt = getattr(torch, noise_dtype)
    q = noise["blocks/attn1/to_q"]["a"]
    assert isinstance(q, noiser.LowRankNoise)
    assert tuple(q.U.shape) == (base, 2, 12, RANK) and tuple(q.V.shape) == (base, 2, 4, RANK)
    assert tuple(noise["proj_out"]["b"].U.shape) == (base, 4, RANK)
    assert isinstance(noise["conv"]["a"], noiser.DenseNoise)
    assert tuple(noise["conv"]["a"].E.shape) == (base, 3, 3, 4, 2)
    assert all(t.dtype == dt for n in noise.values() for node in n.values() for t in node)


@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
def test_sample_noise_matches_jax_from_the_same_key(noise_dtype):
    """The JAX key tree, leaf by leaf: one key per θ leaf, split into
    (ku, kv) for the factored leaves. f32 draws within 1e-6; the bf16 store
    within one bf16 rounding of them (a draw 1e-6 from a rounding boundary
    may round the other way)."""
    jtheta = dict(_theta(), conv={"a": jnp.zeros((3, 3, 4, 2)), "b": jnp.zeros((2, 5))})
    jcfg, cfg = _cfgs(noise_dtype)
    j = jnoiser.sample_noise(jax.random.PRNGKey(4), jtheta, POP, jcfg)
    t = noiser.sample_noise(threefry.prng_key(4, "cpu"), adapter_from_jax(_np(jtheta), "cpu"), POP, cfg)
    jl = jax.tree_util.tree_leaves(j)
    tl = [x for n in (t[k][f] for k in sorted(t) for f in sorted(t[k])) for x in n]
    assert len(jl) == len(tl)
    tol = dict(rtol=0, atol=1e-6) if noise_dtype == "float32" else dict(rtol=2 ** -8, atol=1e-6)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), **tol)


@pytest.mark.parametrize("pop", [1, 4, 5])
@pytest.mark.parametrize("antithetic", [True, False])
def test_member_layout_matches_jax(pop, antithetic):
    js, jb = jnoiser.member_signs_and_bases(pop, antithetic)
    ts, tb = noiser.member_signs_and_bases(pop, antithetic)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tb, jb)
    assert noiser.base_pop_size(pop, antithetic) == jnoiser.base_pop_size(pop, antithetic)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def es_pair(request):
    jcfg, tcfg = _cfgs(request.param)
    theta = _theta()
    noise = jnoiser.sample_noise(jax.random.PRNGKey(3), theta, POP, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, theta=theta, noise=noise,
                ttheta=adapter_from_jax(_np(theta), "cpu"), tnoise=tree_from_numpy(_np(noise), "cpu"))


@pytest.mark.parametrize("k", [0, 2, 4])
def test_perturb_member_matches_jax(es_pair, k):
    s = es_pair
    j = jnoiser.perturb_member(s["theta"], s["noise"], k, POP, s["jcfg"])
    t = noiser.perturb_member(s["ttheta"], s["tnoise"], k, POP, s["tcfg"])
    _assert_tree_close(t, j)


@pytest.mark.parametrize("base", ["float", "int8"])
def test_factored_member_theta_through_dense_matches_jax(es_pair, base):
    """Member 3's factored adapter applied at one dense site (the stacked
    target's layer 1) through ``nn.dense``, against the JAX ``nn.dense``."""
    s = es_pair
    r = np.random.default_rng(7)
    w = jnp.asarray(r.normal(size=(12, 10)) / np.sqrt(12), jnp.float32)
    node = {"kernel": w} if base == "float" else {"kernel_q8": jquantize(w)}
    x = r.normal(size=(2, 5, 12)).astype(np.float32)
    jm = jnoiser.factored_member_theta(s["theta"], s["noise"], 3, POP, s["jcfg"])
    tm = noiser.factored_member_theta(s["ttheta"], s["tnoise"], 3, POP, s["tcfg"])
    assert isinstance(tm["proj_out"]["a"], FactoredDelta)
    jleaf = {f: JFD(q.w[1], q.u[1], q.v[1], q.c) for f, q in jm["blocks/attn1/to_q"].items()}
    j = jnn.dense(node, jnp.asarray(x), jleaf, 2.0)
    t = tnn.dense(tree_from_numpy(_np(node), "cpu"), torch.from_numpy(x),
                  slice_layer(tm["blocks/attn1/to_q"], 1), 2.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_fitness_coeffs_and_es_update_match_jax(es_pair):
    s = es_pair
    fit = np.random.default_rng(1).normal(size=POP).astype(np.float32)
    jc = jnoiser.fitness_coeffs(jnp.asarray(fit), POP, s["jcfg"])
    tc = noiser.fitness_coeffs(torch.from_numpy(fit), POP, s["tcfg"])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    j = jnoiser.es_update(s["theta"], s["noise"], jnp.asarray(fit), POP, s["jcfg"])
    t = noiser.es_update(s["ttheta"], s["tnoise"], torch.from_numpy(fit), POP, s["tcfg"])
    _assert_tree_close(t, j)


def test_noise_tree_mismatch_raises(es_pair):
    s = es_pair
    wrong = dict(s["tnoise"])
    wrong.pop("proj_out")
    with pytest.raises(ValueError, match="does not match theta"):
        noiser.es_update(s["ttheta"], wrong, torch.zeros(POP), POP, s["tcfg"])


REWARD_CASES = {
    "plain": [0.3, 0.1, 0.7, 0.2, 0.5],
    "nan_members": [0.3, float("nan"), 0.7, float("inf"), 0.5],
    "constant": [0.25] * 5,
    "odd_pop": [1.0, 2.0, 4.0],
    "one_finite": [float("nan"), 0.5, float("nan")],
}


@pytest.mark.parametrize("case", sorted(REWARD_CASES))
def test_fitness_shaping_matches_jax(case):
    r = np.asarray(REWARD_CASES[case], np.float32)
    jf, jn = jscoring.standardize_fitness_masked(jnp.asarray(r))
    tf, tn = scoring.standardize_fitness_masked(torch.from_numpy(r))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    assert int(tn) == int(jn)
    if np.isfinite(r).all():
        np.testing.assert_allclose(scoring.standardize_fitness(torch.from_numpy(r)).numpy(),
                                   np.asarray(jscoring.standardize_fitness(jnp.asarray(r))), **TOL)
    if case == "constant":
        assert (tf.numpy() == 0).all() and (np.asarray(jf) == 0).all()


@pytest.mark.parametrize("kind", ["random", "constant_per_prompt", "odd_pop"])
def test_prompt_normalized_scores_match_jax(kind):
    r = np.random.default_rng(2)
    S = r.normal(size=(5 if kind == "odd_pop" else 4, 3)).astype(np.float32)
    if kind == "constant_per_prompt":
        S = np.tile(r.normal(size=(1, 3)).astype(np.float32), (4, 1))
    j = jscoring.prompt_normalized_scores(jnp.asarray(S))
    t = scoring.prompt_normalized_scores(torch.from_numpy(S))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if kind == "constant_per_prompt":
        assert (t[0].numpy() == 0).all() and (np.asarray(j[0]) == 0).all()


@pytest.mark.parametrize("limit", [None, 0.0, 0.5, 100.0])
def test_caps_match_jax(limit):
    theta = _theta(1)
    after = jax.tree_util.tree_map(lambda x: x * 1.7 + 0.05, theta)
    tt, ta = adapter_from_jax(_np(theta), "cpu"), adapter_from_jax(_np(after), "cpu")
    np.testing.assert_allclose(float(caps.global_norm(tt)), float(jcaps.global_norm(theta)), **TOL)
    j, js = jcaps.cap_theta_norm(theta, limit)
    t, ts = caps.cap_theta_norm(tt, limit)
    _assert_tree_close(t, j)
    np.testing.assert_allclose(float(ts), float(js), **TOL)
    j, js = jcaps.cap_step_norm(theta, after, limit)
    t, ts = caps.cap_step_norm(tt, ta, limit)
    _assert_tree_close(t, j)
    np.testing.assert_allclose(float(ts), float(js), **TOL)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_epoch_key_matches_jax(seed):
    for epoch in (0, 1, 99):
        np.testing.assert_array_equal(sampling.epoch_key(seed, epoch, "cpu").numpy(),
                                      np.asarray(jax.random.key_data(jsampling.epoch_key(seed, epoch))))


def test_prompt_sampling_and_seeds_match_jax():
    for seed, total, k in ((0, 8, 4), (3, 8, 8), (11, 20, 5)):
        assert sampling.sample_indices_unique(seed, total, k) == jsampling.sample_indices_unique(seed, total, k)
    assert sampling.repeat_batches([3, 1], 3) == jsampling.repeat_batches([3, 1], 3)
    for args in ((0, 1, 2), (2**31, 7, 99), (12345, 0, 0)):
        assert sampling.mix_seed(*args) == jsampling.mix_seed(*args)


@pytest.mark.parametrize("case", ["plain", "nan_members", "odd_pop"])
def test_es_health_metrics_match_jax(case):
    r = np.asarray(REWARD_CASES[case], np.float32)
    pop = r.shape[0]
    delta, prev = _theta(4), _theta(5)
    fit = np.array(jscoring.standardize_fitness_masked(jnp.asarray(r))[0])
    kw = dict(cap_theta_scale=0.9, cap_step_scale=1.0, pop_size=pop, antithetic=True)
    j = jhealth.es_health_metrics(opt_scores=jnp.asarray(r), fitness=jnp.asarray(fit), delta=delta,
                                  prev_delta=prev, **kw)
    t = es_health.es_health_metrics(opt_scores=torch.from_numpy(r), fitness=torch.from_numpy(fit),
                                    delta=adapter_from_jax(_np(delta), "cpu"),
                                    prev_delta=adapter_from_jax(_np(prev), "cpu"), **kw)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), **TOL)
