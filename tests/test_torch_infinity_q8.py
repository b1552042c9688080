"""Port parity: the Infinity ES step on the int8 base and on the factored
member path (``pop_fuse``), tiny, f32.

The JAX package's ``make_es_step`` runs its tiny Infinity backend (the
step test's geometry: pop 4, 4 prompts with hash-fallback text, member_batch
2) in four configurations: {an int8 base from ``quantize_tree(min_size=512)``
(every stacked block projection and ``ada_lin``, the BSQ decoder's wide
convs; φ and the narrow layers stay float), a float base} × {``pop_fuse``
on, off}. Weights, text, adapter, CLIP tower and table are carried over;
the JAX ES noise and sampling noise are injected as in
``test_torch_infinity_step.py``.

- θ′, the opt scores, the reward rows and every metric within 3e-4
  (measured over the four: θ′ ≤ 3.1e-7, rows ≤ 1.2e-7, opt scores ≤
  1.5e-5, metrics ≤ 1.2e-5; the int8 base 8.9e-8, 8.9e-8, 1.1e-5, 1.1e-5).
- The sampled bits of every member equal the JAX package's on the same
  guided logits, and justifiably: at every bit the gap between its two
  ``lg + gumbel`` exceeds 100× the port's logit error against the JAX
  ``_blocks_step`` on the member's adapter (measured: logit error ≤
  1.2e-6, smallest gap 2.4e-4 on the float base, 8.9e-4 on the int8 one).
- ``cond6`` over an int8 ``ada_lin`` against the JAX einsum over
  ``resolve_kernel``, within 2e-7 (measured ≤ 4.5e-8); every block site
  takes K3's wrapper under ``pop_fuse`` and never the ``dequant_matmul``
  fallback (call counts); an int8 φ raises by name.
- ``maybe_quantize_tree`` resolves ``min_size`` as the JAX package does
  (explicit, ``HSES_BASE_QUANT_MIN_SIZE``, the default): the same
  ``kernel_q8`` paths in a tiny Sana and a tiny Infinity tree.
- K1-K3's plans at Infinity-2B's shapes: every grid dimension within the
  launch limits and every row offset inside 32 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.backends.base import make_frozen
from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackend as JBackend
from hyperscalees_t2i_tpu.backends.infinity_backend import InfinityBackendConfig as JConfig
from hyperscalees_t2i_tpu.es.noiser import factored_member_theta as jfactored_member_theta
from hyperscalees_t2i_tpu.es.noiser import member_maps as jmember_maps
from hyperscalees_t2i_tpu.es.noiser import perturb_member as jperturb_member
from hyperscalees_t2i_tpu.es.noiser import sample_noise as jsample_noise
from hyperscalees_t2i_tpu.models import clip as jclip
from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.ops import quant as jquant
from hyperscalees_t2i_tpu.rewards import suite as jsuite
from hyperscalees_t2i_tpu.train.config import TrainConfig as JTrainConfig
from hyperscalees_t2i_tpu.train.trainer import make_es_step as jmake_es_step
from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend
from hyperscalees_t2i_tpu_torch.models import bsq, infinity as tinf
from hyperscalees_t2i_tpu_torch.models import sana as tsana
from hyperscalees_t2i_tpu_torch.ops import fused_lora as tfl
from hyperscalees_t2i_tpu_torch.ops import fused_qlora as tfq
from hyperscalees_t2i_tpu_torch.ops import quant as tquant
from hyperscalees_t2i_tpu_torch.ops import quant_mm as tqm
from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
from hyperscalees_t2i_tpu_torch.rungs import infinity_rung_model
from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves_with_path
from hyperscalees_t2i_tpu_torch.weights.from_jax import adapter_from_jax, clip_from_jax, tree_from_numpy

from test_torch_infinity import _np, jax_gumbel, jax_guided_logits, tiny_cfg
from test_torch_var_step import _HostRows, _jax_clip_cfg

torch.set_num_threads(1)
TOL = dict(rtol=3e-4, atol=3e-4)
POP, M, SIGMA, MB = 4, 4, 0.01, 2
MIN_SIZE = 512
PROMPTS = ["a red square", "a blue circle", "a green cat", "a woman reading"]
CONFIGS = {"int8_fused": (True, True), "int8": (True, False), "float_fused": (False, True), "float": (False, False)}


def _q8_paths(tree, jax_tree: bool):
    """The ``/``-joined paths of a tree's ``kernel_q8/q8`` leaves."""
    if jax_tree:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in flat]
    else:
        paths = [p for p, _ in tree_leaves_with_path(tree)]
    return sorted(p for p in paths if p.endswith("kernel_q8/q8"))


class _Bits:
    """Wraps ``models.infinity.sample_bits``: keeps each call's guided
    logits, noise and bits."""

    def __init__(self):
        self.orig, self.calls = tinf.sample_bits, []

    def __enter__(self):
        def rec(lg, gumbel):
            bits = self.orig(lg, gumbel)
            self.calls.append((lg.clone(), gumbel.clone(), bits.clone()))
            return bits

        tinf.sample_bits = rec
        return self

    def __exit__(self, *exc):
        tinf.sample_bits = self.orig


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request, tmp_path_factory):
    int8, fuse = CONFIGS[request.param]
    path = tmp_path_factory.mktemp("inf") / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    jb = JBackend(JConfig(model=tiny_cfg(), prompts_txt_path=str(path)))
    jb.setup()
    jb.params = jax.tree_util.tree_map_with_path(
        lambda p, a: a if "kernel" in jax.tree_util.keystr(p)
        else a + 0.05 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), jb.params)
    if int8:
        jb.params = jquant.quantize_tree(jb.params, min_size=MIN_SIZE)
    ccfg = _jax_clip_cfg()
    cparams = jclip.init_clip(jax.random.PRNGKey(6), ccfg)
    table = jsuite.clip_text_embed_table(
        cparams, ccfg, jax.random.randint(jax.random.PRNGKey(7), (jb.num_items + 2, 8), 0, ccfg.vocab_size))
    theta = jb.init_theta(jax.random.PRNGKey(1))
    theta = jax.tree_util.tree_map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape), theta)
    jreward = _HostRows(jsuite.make_clip_reward_fn(cparams, ccfg, table))
    jtc = JTrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, prompts_per_gen=M, batches_per_gen=1,
                       member_batch=MB, promptnorm=True, pop_fuse=fuse)
    info = jb.step_info(0, M, 1)
    key = jax.random.PRNGKey(2)
    k_noise, k_gen = jax.random.split(key)
    step = jmake_es_step(jb, jreward, jtc, M, 1, donate=False)
    jtheta, jmetrics, jopt = step(make_frozen(jb, jreward), theta, jnp.asarray(info.flat_ids, jnp.int32), key)
    jax.effects_barrier()
    jrows = {k: np.concatenate([c[k].reshape(-1, M) for c in jreward.calls]) for k in jreward.calls[0]}
    noise = jsample_noise(k_noise, theta, POP, jtc.es_config())
    gen = jax_gumbel(k_gen, jb.cfg.model, M)

    backend = InfinityBackend(infinity_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(jb.params), "cpu"),
                              prompts=jb.prompts, text=(torch.from_numpy(np.array(jb.text_emb)),
                                                        torch.from_numpy(np.array(jb.text_mask))))
    backend.setup()
    reward = make_clip_reward_fn(clip_from_jax(_np(cparams), infinity_rung_model("tiny")["clip_b"], "cpu"),
                                 torch.from_numpy(np.array(table)))
    calls = []

    def recording_reward(images, ids):
        out = reward(images, ids)
        calls.append(out)
        return out

    tc = TrainConfig(pop_size=POP, sigma=SIGMA, egg_rank=4, member_batch=MB, pop_fuse=fuse)
    counts = {"fused_qlora": 0, "dequant_matmul": 0}
    real_k3, real_dq = tfq.fused_qlora_matmul, tfq.dequant_matmul

    def k3(*a, **kw):
        counts["fused_qlora"] += 1
        return real_k3(*a, **kw)

    def dq(*a, **kw):
        counts["dequant_matmul"] += 1
        return real_dq(*a, **kw)

    tfq.fused_qlora_matmul, tfq.dequant_matmul = k3, dq
    try:
        with _Bits() as rec:
            ptheta, pmetrics, popt = make_es_step(backend, recording_reward, tc, M, 1, device="cpu")(
                adapter_from_jax(_np(theta), "cpu"), info.flat_ids, threefry.prng_key(2, "cpu"),
                noise=tree_from_numpy(_np(noise), "cpu"), gen_noise=torch.from_numpy(gen))
    finally:
        tfq.fused_qlora_matmul, tfq.dequant_matmul = real_k3, real_dq
    prows = {k: torch.cat([c[k].reshape(-1, M) for c in calls]).numpy() for k in calls[0]}
    return dict(name=request.param, int8=int8, fuse=fuse, jb=jb, theta=theta, noise=noise, jtc=jtc, gen=gen,
                info=info, jout=(jtheta, jmetrics, jopt, jrows), pout=(ptheta, pmetrics, popt, prows),
                bits=rec.calls, counts=counts, backend=backend)


def test_step_matches_jax(run):
    jtheta, jmetrics, jopt, jrows = run["jout"]
    theta, metrics, opt, rows = run["pout"]
    for p in jtheta:
        for f in jtheta[p]:
            np.testing.assert_allclose(theta[p][f].numpy(), np.asarray(jtheta[p][f]), err_msg=p, **TOL)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), **TOL)
    for k in jrows:
        assert rows[k].shape == (POP, M)
        np.testing.assert_allclose(rows[k], jrows[k], **TOL)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(np.asarray(metrics[k], np.float64), np.asarray(jmetrics[k], np.float64),
                                   err_msg=k, **TOL)
    assert float(metrics["delta_norm"]) > 0
    # the int8 configurations really ran on an int8 base
    assert any(hasattr(m, "q8") for m in run["backend"].model.blocks.modules()) == run["int8"]


def _jax_member_theta(r, k):
    cfg = r["jtc"].es_config()
    if r["fuse"]:
        return jfactored_member_theta(r["theta"], r["noise"], jnp.int32(k), POP, cfg, jmember_maps(POP, cfg.antithetic))
    return jperturb_member(r["theta"], r["noise"], jnp.int32(k), POP, cfg)


def test_sampled_bits_match_jax_under_a_measured_margin(run):
    jb, cfg = run["jb"], run["jb"].cfg.model
    S, C = len(cfg.patch_nums), cfg.vq.bits
    ids = np.asarray(run["info"].flat_ids)
    emb, mask = np.asarray(jb.text_emb)[ids], np.asarray(jb.text_mask)[ids]
    params = jb.params
    ada = params["blocks"]["ada_lin"]
    # the JAX helper's einsum reads a float ada_lin: give it resolve_kernel's, as JAX's generate does
    params = dict(params, blocks=dict(params["blocks"], ada_lin={"kernel": jquant.resolve_kernel(ada, jnp.float32),
                                                                 "bias": ada["bias"]}))
    calls = run["bits"]
    assert len(calls) == S * POP // MB
    worst_err, smallest_gap = 0.0, np.inf
    for k in range(POP):
        chunk, lane = divmod(k, MB)
        mine = calls[chunk * S:(chunk + 1) * S]
        bits = np.concatenate([c[2][lane].reshape(M, -1, C).numpy() for c in mine], axis=1)
        port_lg = np.concatenate([c[0][lane].reshape(M, -1, C, 2).numpy() for c in mine], axis=1)
        jax_lg = jax_guided_logits(params, cfg, emb, mask, bits, jb.cfg.cfg_list, jb.cfg.tau_list,
                                   _jax_member_theta(run, k), jb.lora_scale)
        np.testing.assert_array_equal(bits, np.argmax(jax_lg + run["gen"], axis=-1), err_msg=f"member {k}")
        z = port_lg + run["gen"]
        worst_err = max(worst_err, float(np.abs(port_lg - jax_lg).max()))
        smallest_gap = min(smallest_gap, float(np.abs(z[..., 1] - z[..., 0]).min()))
    assert worst_err < 1e-5 and smallest_gap > 100 * worst_err, (worst_err, smallest_gap)


def test_every_block_site_takes_k3_under_pop_fuse(run):
    cfg = run["jb"].cfg.model
    calls = POP // MB
    sites = 6 * len(cfg.patch_nums) * cfg.depth + cfg.depth  # six a layer a scale, cross_kv once a layer
    want = {"fused_qlora": sites * calls if run["int8"] and run["fuse"] else 0, "dequant_matmul": 0}
    assert run["counts"] == want


def test_cond6_over_int8_ada_lin_matches_jax_einsum():
    cfg = tiny_cfg()
    params = jquant.quantize_tree(jinf.init_infinity(jax.random.PRNGKey(0), cfg), min_size=MIN_SIZE)
    ada = params["blocks"]["ada_lin"]
    assert "kernel_q8" in ada
    c = np.random.RandomState(3).randn(6, cfg.d_model).astype(np.float32)
    want = (jnp.einsum("bd,lde->lbe", jnp.asarray(c), jquant.resolve_kernel(ada, jnp.float32))
            + ada["bias"][:, None, :]).reshape(cfg.depth, 6, 6, cfg.d_model)
    model = InfinityBackend(infinity_rung_model("tiny")["bcfg"], "cpu", params=tree_from_numpy(_np(params), "cpu"),
                            prompts=PROMPTS)
    model.setup()
    got = model.model.cond6(torch.from_numpy(c))
    assert model.model.ada_lin.q8.dtype == torch.int8
    for i in range(cfg.depth):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-6, atol=2e-7)


def test_int8_phi_raises_by_name():
    params = tinf.init_infinity(infinity_rung_model("tiny")["bcfg"].model, threefry.prng_key(0, "cpu"))
    vq = tquant.quantize_tree(params["vq"], min_size=0)
    assert "kernel_q8" in vq["phi"]
    with pytest.raises(ValueError, match="φ must stay float"):
        bsq.BSQ(infinity_rung_model("tiny")["bcfg"].model.vq, vq)


@pytest.mark.parametrize("family", ["sana", "infinity"])
@pytest.mark.parametrize("env", [None, "300", "2000"])
def test_maybe_quantize_tree_resolves_min_size_as_jax(monkeypatch, family, env):
    if env is None:
        monkeypatch.delenv(tquant.MIN_SIZE_ENV, raising=False)
    else:
        monkeypatch.setenv(tquant.MIN_SIZE_ENV, env)
    assert tquant.MIN_SIZE_ENV == jquant.MIN_SIZE_ENV
    assert tquant.resolve_base_quant_min_size() == jquant.resolve_base_quant_min_size()
    assert tquant.resolve_base_quant_min_size(7) == jquant.resolve_base_quant_min_size(7) == 7
    if family == "sana":
        jcfg = jsana.SanaConfig(d_model=64, n_layers=2, n_heads=4, cross_n_heads=4, caption_dim=32, in_channels=4,
                                out_channels=4, compute_dtype=jnp.float32)
        jtree = jsana.init_sana(jax.random.PRNGKey(0), jcfg)
        tcfg = tsana.SanaConfig(d_model=64, n_layers=2, n_heads=4, cross_n_heads=4, caption_dim=32, in_channels=4,
                                out_channels=4, compute_dtype=torch.float32)
        ttree = tsana.init_sana(tcfg, threefry.prng_key(0, "cpu"))
    else:
        jtree = jinf.init_infinity(jax.random.PRNGKey(0), tiny_cfg())
        ttree = tinf.init_infinity(infinity_rung_model("tiny")["bcfg"].model, threefry.prng_key(0, "cpu"))
    jq, tq = jquant.maybe_quantize_tree(jtree, "int8"), tquant.maybe_quantize_tree(ttree, "int8")
    assert _q8_paths(tq, False) == _q8_paths(jq, True)
    assert bool(_q8_paths(tq, False)) == (env is not None)  # nothing in these trees reaches the default floor
    assert tquant.maybe_quantize_tree(ttree, "int8", min_size=10**9) is not ttree
    assert _q8_paths(tquant.maybe_quantize_tree(ttree, "int8", min_size=10**9), False) == []


# Infinity-2B's block sites (K, N) and the rows per lane of each scale: 8 CFG
# rows (1 lane × 4 images × cond/uncond) × pn²; cross_kv over 8 × 17 text rows
INF_SITES = {"qkv": (2048, 6144), "attn_proj": (2048, 2048), "fc1": (2048, 8192), "fc2": (8192, 2048)}
INF_ROWS = [8 * pn * pn for pn in tinf.PN_PRESETS["1M"]] + [8 * 17]
GRID_YZ = 65535


@pytest.mark.parametrize("site", sorted(INF_SITES))
def test_plans_at_infinity_2b_shapes(site):
    K, N = INF_SITES[site]
    tiles = {tqm.MMA_128x128: (128, 128), tqm.MMA_64x64: (64, 64), tqm.MMA_16x64: (16, 64)}
    for rows in INF_ROWS:
        assert rows * max(K, N) < 2**31  # every row offset and output index of a launch fits 32 bits
        p3 = tfq._plan(rows, 1, K, N, torch.bfloat16, 0, 0)
        bm, bn = tiles[p3.tile]
        assert (p3.bk, p3.a_vec, p3.b_vec) == (64, 8, 16)
        assert -(-N // bn) <= GRID_YZ and -(-rows // bm) < 2**31
        p2 = tfl._plan(rows, 1, K, N, torch.bfloat16, 0)
        assert p2.cols % 8 == 0 and tfl._MIN_COLS <= p2.cols <= tfl.MAX_COLS
        assert -(-rows // p2.rows) <= GRID_YZ and (p2.bk, p2.warps, p2.a_vec) == (64, tfl.WARPS, 8)
        blocks = -(-rows // p2.rows) * -(-N // p2.cols)
        assert blocks >= min(tfl._SMS // 2, -(-N // 64))  # the column groups fill what the row tiles leave
        p1 = tqm._plan(rows, K, N, torch.bfloat16, 0, 0)
        assert -(-N // tiles[p1.tile][1]) <= GRID_YZ
    # the largest launch: 32,768 rows, one lane
    assert tfq._plan(32768, 1, K, N, torch.bfloat16).tile == tqm.MMA_128x128
    assert tfl._plan(32768, 1, K, N, torch.bfloat16).cols == tfl.MAX_COLS


def test_k1_f32_plans_at_infinity_2b_f32_sites():
    """``word_embed`` (up to 16,384 rows, K 32 → 2048), ``text_proj`` (64
    rows, 2048 → 2048) and ``pool_proj`` (8 rows) take K1's f32 route."""
    for rows, K, N in [(4 * 64 * 64, 32, 2048), (4 * 16, 2048, 2048), (8, 2048, 2048)]:
        p = tqm._plan(rows, K, N, torch.float32)
        assert p.tile == (tqm.F32_ROWS8 if rows <= 8 else tqm.F32_TILE) and p.bk == 32
