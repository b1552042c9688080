"""Port parity of the whole serving slice, and the port's own serving contracts.

- The JAX ``make_adapter_batch_generator`` against the port's at A=2, B=2
  over the tiny rung in f32 with an int8 base, JAX weights and prompt
  embeddings carried over, JAX noise injected. Bound 3e-4 (the golden
  bound); measured max abs error 6.9e-7.
- The port's ``ServeEngine`` on the CPU: 3 adapters, 5 requests; every
  request served in a batch equals the same request served alone.
- Nothing injected: the port's engine and the JAX engine, each building the
  tiny f32 backend from the same ``seed_params`` (weights, prompt
  embeddings), serve the same adapter and request seed; the images agree
  within 3e-4.
- Store, batcher and adapter digests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.sana_backend import SanaBackend as JSanaBackend
from hyperscalees_t2i_tpu.lora import stack_adapters as jstack
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.parallel.pop_eval import make_adapter_batch_generator as jmake_gen
from hyperscalees_t2i_tpu.rungs import sana_rung_model as jrung
from hyperscalees_t2i_tpu.serve import ServeConfig as JServeConfig
from hyperscalees_t2i_tpu.serve import ServeEngine as JServeEngine
from hyperscalees_t2i_tpu.serve import adapter_digest as jdigest
from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend, build_serve_backend
from hyperscalees_t2i_tpu_torch.lora import stack_adapters
from hyperscalees_t2i_tpu_torch.parallel.pop_eval import make_adapter_batch_generator
from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
from hyperscalees_t2i_tpu_torch.serve import (
    AdapterStore, QueueFullError, RequestQueue, ServeConfig, ServeEngine, ServeRequest, adapter_digest,
)
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, tree_from_numpy

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _f32_bcfg_pair():
    jb = jrung("tiny")["bcfg"]
    jb = dataclasses.replace(jb, model=dataclasses.replace(jb.model, compute_dtype=jnp.float32),
                             vae=dataclasses.replace(jb.vae, compute_dtype=jnp.float32))
    tb = sana_rung_model("tiny")["bcfg"]
    tb = dataclasses.replace(tb, model=dataclasses.replace(tb.model, compute_dtype=torch.float32),
                             vae=dataclasses.replace(tb.vae, compute_dtype=torch.float32))
    return jb, tb


@pytest.mark.parametrize("member_batch", [0, 1])
def test_adapter_batch_generator_matches_jax(member_batch):
    jb, tb = _f32_bcfg_pair()
    jback = JSanaBackend(jb)
    jback.setup()
    jback.params = jquantize_tree(jback.params, min_size=0)
    jback.vae_params = jquantize_tree(jback.vae_params, min_size=0)
    thetas = []
    for i in range(2):
        th = jback.init_theta(jax.random.PRNGKey(20 + i))
        thetas.append(jax.tree_util.tree_map(
            lambda x, i=i: x + 0.05 * jax.random.normal(jax.random.PRNGKey(30 + i), x.shape), th))
    stacked = jstack(thetas)
    A, B = 2, 2
    flat_ids = np.array([[0, 0], [0, 0]], np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (3, 4)])
    j = np.asarray(jax.jit(jmake_gen(jback.generate_p, A, B))(
        jback.frozen, jax.tree_util.tree_map(jnp.asarray, stacked), flat_ids, keys))
    noise = np.stack([np.array(jsana._per_image_normal(jnp.asarray(k), jnp.arange(B), B, (8, 8, 4)))
                      for k in keys])

    tback = SanaBackend(tb, "cpu", params=tree_from_numpy(_np_tree(jback.params), "cpu"),
                        vae_params=tree_from_numpy(_np_tree(jback.vae_params), "cpu"), prompts=jback.prompts)
    tback.setup()
    tback.prompt_embeds = torch.from_numpy(np.array(jback.prompt_embeds))
    gen = make_adapter_batch_generator(tback.generate_p, A, B, member_batch=member_batch)
    with torch.inference_mode():
        out = gen(adapter_from_jax(_np_tree(stacked), "cpu"), flat_ids,
                  torch.stack([threefry.prng_key(s, "cpu") for s in (3, 4)]), noise=torch.from_numpy(noise))
    assert out.shape == j.shape == (A, B, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), j, rtol=3e-4, atol=3e-4)


def test_served_image_from_a_seed_matches_jax_engine():
    jb, tb = _f32_bcfg_pair()
    jback = JSanaBackend(jb)
    jback.setup()
    theta = jax.tree_util.tree_map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(31), x.shape),
                                   jback.init_theta(jax.random.PRNGKey(30)))
    jeng = JServeEngine(jback, JServeConfig(adapter_batch=2, images_per_request=2))
    jeng.put_adapter("t", theta)
    j = np.asarray(jeng.generate("t", [0, 0], seed=5))
    tback = SanaBackend(tb, "cpu")
    tback.setup()
    eng = ServeEngine(tback, ServeConfig(adapter_batch=2, images_per_request=2, device="cpu"))
    eng.put_adapter("t", adapter_from_jax(_np_tree(theta), "cpu"))
    with torch.inference_mode():
        t = eng.generate("t", [0, 0], seed=5)
    assert t.shape == j.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(t, j, rtol=3e-4, atol=3e-4)
    assert np.abs(t[0] - t[1]).max() > 1e-4  # image j of a request folds j into its key


@pytest.fixture(scope="module")
def backend():
    return build_serve_backend(sana_rung_model("tiny")["bcfg"], "off", device="cpu",
                               prompts=["a red cube", "a blue sphere", "a green cone"])


def _adapters(backend, n):
    g = torch.Generator().manual_seed(9)
    out = {}
    for i in range(n):
        th = backend.init_theta(threefry.fold_in(threefry.prng_key(9, "cpu"), i))
        out[f"t{i}"] = {k: {f: v + 0.05 * torch.randn(v.shape, generator=g) for f, v in d.items()}
                        for k, d in th.items()}
    return out


def test_engine_batched_equals_solo(backend):
    eng = ServeEngine(backend, ServeConfig(adapter_batch=2, member_batch=0, device="cpu"))
    for aid, th in _adapters(backend, 3).items():
        eng.put_adapter(aid, th)
    assert eng.warmup() == ["serve_a2b1"]
    reqs = [eng.submit(f"t{i % 3}", [i % 3], seed=100 + i) for i in range(5)]
    res = eng.flush()
    assert [r.request.request_id for r in res] == [r.request_id for r in reqs]
    assert [r.batch_size for r in res] == [2, 2, 2, 2, 1]  # requests; the partial batch runs padded to 2 lanes
    for r in res:
        assert r.ok and r.images.shape == (1, 32, 32, 3)
        assert np.isfinite(r.images).all() and r.images.min() >= 0 and r.images.max() <= 1
        solo = eng.generate(r.request.adapter_id, r.request.prompt_ids, r.request.seed)
        np.testing.assert_allclose(solo, r.images, rtol=0, atol=1e-6)
    # tenants differ, and so do seeds
    assert np.abs(res[0].images - res[1].images).max() > 1e-4
    st = eng.stats()
    assert st["requests"] == 10 and st["store"]["resident"] == 3


def test_engine_refuses_unknown_adapter_and_bad_prompts(backend):
    eng = ServeEngine(backend, ServeConfig(adapter_batch=2, device="cpu", max_queue=1))
    eng.put_adapter("t0", _adapters(backend, 1)["t0"])
    with pytest.raises(KeyError):
        eng.submit("nope", [0], seed=0)
    with pytest.raises(ValueError):
        eng.submit("t0", [7], seed=0)
    eng.submit("t0", [0], seed=0)
    with pytest.raises(QueueFullError):
        eng.submit("t0", [0], seed=1)
    eng.store.evict("t0")
    (res,) = eng.flush()
    assert not res.ok and "not resident" in res.error


def test_store_lru_by_bytes_and_structure_check(backend):
    ads = _adapters(backend, 3)
    one = AdapterStore().put("x", ads["t0"]).nbytes
    store = AdapterStore(budget_bytes=2 * one, template=ads["t0"])
    store.put("a", ads["t0"])
    store.put("b", ads["t1"])
    store.get("a")
    store.put("c", ads["t2"])
    assert store.ids() == ["a", "c"] and store.evictions == 1
    bad = {k: dict(v) for k, v in ads["t0"].items()}
    bad.pop(sorted(bad)[0])
    with pytest.raises(ValueError):
        store.put("bad", bad)


def test_adapter_digest_matches_jax_for_the_same_bytes(backend):
    th = _adapters(backend, 1)["t0"]
    np_tree = {k: {f: v.numpy() for f, v in d.items()} for k, d in th.items()}
    assert adapter_digest(th) == jdigest(np_tree)


def test_batcher_coalesces_by_geometry():
    q = RequestQueue()
    for ids, g in [((0,), None), ((0, 1), None), ((1,), None), ((2,), 2.0), ((2,), None)]:
        q.submit(ServeRequest(adapter_id="a", prompt_ids=ids, seed=0, guidance=g))
    first = q.take_batch(2)
    assert [r.prompt_ids for r in first] == [(0,), (1,)]
    assert [r.prompt_ids for r in q.take_batch(4)] == [(0, 1)]
    assert [r.guidance for r in q.take_batch(4)] == [2.0]
    assert q.depth == 1


def test_stack_adapters_refuses_mismatch(backend):
    ads = _adapters(backend, 2)
    s = stack_adapters([ads["t0"], ads["t1"]])
    k = sorted(s)[0]
    assert s[k]["a"].shape[0] == 2
    bad = {kk: dict(v) for kk, v in ads["t1"].items()}
    bad[k]["a"] = bad[k]["a"][..., :1]
    with pytest.raises(ValueError):
        stack_adapters([ads["t0"], bad])
