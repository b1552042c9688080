"""Tensor parallelism of the port (``parallel/tp.py``, the plans
``models.nn.dense``/``Conv`` run, ``evaluate.run_benchmark --tp``) against
the JAX package's on the CPU.

- The per-leaf plans: for Sana, Z-Image, VAR and Infinity, float and int8
  trees, at tp 2, 4 and 8, the port's ``tp_sharding_tree`` gives each leaf
  the axis the JAX ``tp_sharding_tree``'s spec shards (or none), leaf for
  leaf, and ``count_tp_sharded`` the JAX count; int8 trees' ``kernel_q8``
  leaves stay replicated while their biases shard; a leaf whose axis tp
  does not divide stays replicated; ``shard_params_tp`` cuts each sharded
  leaf to its rank's chunk.
- The forward at tp 2 in a gloo launch of 2 CPU processes
  (``shard_module_tp`` on the built model, f32): Sana's DiT, Z-Image's DiT
  and Infinity's generation with QK-l2 and 2D RoPE (``tests/test_tp.py``'s
  cases), each within 1e-4 of the port unsharded and of the JAX package's
  forward (the errors measured are printed); every rank's output is the
  same, and each model's sharded-leaf count is the JAX count.
- ``run_benchmark --tp 2`` under that launch writes (rank 0) the images
  ``--tp 0`` writes, within one uint8 step.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.models import zimage as jzimage
from hyperscalees_t2i_tpu.ops.quant import quantize_tree as jquantize_tree
from hyperscalees_t2i_tpu.parallel import TP_AXIS, make_mesh as jmake_mesh
from hyperscalees_t2i_tpu.parallel import count_tp_sharded as jcount_tp_sharded
from hyperscalees_t2i_tpu.parallel import tp_sharding_tree as jtp_sharding_tree
from hyperscalees_t2i_tpu.parallel.tp import FAMILY_TP_RULES as JRULES
from hyperscalees_t2i_tpu_torch.models import sana, zimage
from hyperscalees_t2i_tpu_torch.parallel import tp

from _torch_gloo import run_workers
from test_torch_infinity import jax_gumbel, port_cfg as inf_port_cfg, tiny_vq
from test_torch_var import _jax_cfg as var_jax_cfg

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sana_cfgs(d=32):
    kw = dict(in_channels=4, out_channels=4, d_model=d, n_layers=2, n_heads=4, cross_n_heads=4, caption_dim=16,
              ff_ratio=2.0)
    return jsana.SanaConfig(**kw, compute_dtype=jnp.float32), sana.SanaConfig(**kw, compute_dtype=torch.float32)


def _zimage_cfgs(d=32, ff_ratio=2.0, n_heads=4):
    kw = dict(in_channels=4, patch_size=2, d_model=d, n_layers=2, n_heads=n_heads, caption_dim=12,
              ff_ratio=ff_ratio, num_steps=2)
    return jzimage.ZImageConfig(**kw, compute_dtype=jnp.float32), zimage.ZImageConfig(**kw, compute_dtype=torch.float32)


def _inf_cfg():
    return jinf.InfinityConfig(depth=2, d_model=16, n_heads=4, ff_ratio=2.0, text_dim=12, patch_nums=(1, 2),
                               vq=dataclasses.replace(tiny_vq(), patch_nums=(1, 2)), attn_l2_norm=True,
                               cross_attn_l2_norm=True, use_rope2d=True, compute_dtype=jnp.float32)


def _family_params(family):
    key = jax.random.PRNGKey(0)
    if family == "sana":
        return jsana.init_sana(key, _sana_cfgs()[0])
    if family == "zimage":
        return jzimage.init_zimage(key, _zimage_cfgs()[0])
    if family == "var":
        return jvar.init_var(key, var_jax_cfg())
    return jinf.init_infinity(key, _inf_cfg())


def _jax_axes(specs):
    """Each leaf's sharded axis in a JAX spec tree (``None``: replicated)."""
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            (list(s.spec).index(TP_AXIS) if s.spec != P() and TP_AXIS in list(s.spec) else None)
            for path, s in flat}


def _port_axes(plan, prefix=""):
    out = {}
    items = plan.items() if isinstance(plan, dict) else enumerate(plan)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        out.update(_port_axes(v, name) if isinstance(v, (dict, list, tuple)) else {name: v})
    return out


@pytest.mark.parametrize("quant", ["float", "int8"])
@pytest.mark.parametrize("family", ["sana", "zimage", "var", "infinity"])
def test_leaf_plans_equal_the_jax_specs(family, quant):
    params = _family_params(family)
    if quant == "int8":
        params = jquantize_tree(params, min_size=256)
    tree = _np(params)
    n_q8 = 0
    for n in (2, 4, 8):
        mesh = jmake_mesh({TP_AXIS: n})
        want = _jax_axes(jtp_sharding_tree(params, mesh, JRULES[family]))
        got = _port_axes(tp.tp_sharding_tree(tree, n, tp.FAMILY_TP_RULES[family]))
        # the JAX flatten drops empty (None) nodes, which the plan keeps as None
        assert set(want) <= set(got) and all(got[k] is None for k in set(got) - set(want))
        got = {k: got[k] for k in want}
        assert got == want, {k: (got.get(k), want.get(k)) for k in set(got) | set(want) if got.get(k) != want.get(k)}
        assert tp.count_tp_sharded(tree, n, family) == jcount_tp_sharded(params, mesh, family)
        n_q8 = sum(1 for k in got if "kernel_q8" in k)
        assert all(got[k] is None for k in got if "kernel_q8" in k)
    assert (n_q8 > 0) == (quant == "int8")
    assert tp.tp_sharding_tree(tree, 1, tp.FAMILY_TP_RULES[family]) == \
        jax.tree_util.tree_map(lambda _: None, tree)


def test_int8_biases_shard_and_non_divisible_leaves_stay_replicated():
    jcfg, _ = _zimage_cfgs(d=24, ff_ratio=1.5, n_heads=2)  # hid 36
    params = _np(jzimage.init_zimage(jax.random.PRNGKey(0), jcfg))
    plan = tp.tp_sharding_tree(params, 8, tp.ZIMAGE_TP_RULES)
    assert plan["blocks"]["qkv"]["kernel"] == 2  # 72 % 8 == 0
    assert plan["blocks"]["fc2"]["kernel"] is None  # 36 % 8 != 0
    q8 = _np(jquantize_tree(jzimage.init_zimage(jax.random.PRNGKey(0), _zimage_cfgs()[0]), min_size=256))
    plan = tp.tp_sharding_tree(q8, 2, tp.ZIMAGE_TP_RULES)
    assert plan["blocks"]["qkv"]["kernel_q8"] == {"q8": None, "scale": None} and plan["blocks"]["qkv"]["bias"] == 1
    tree = _np(_family_params("sana"))
    local = tp.shard_params_tp(tree, "sana")  # one process: the tree as given
    assert local["blocks"]["attn1"]["to_q"]["kernel"] is tree["blocks"]["attn1"]["to_q"]["kernel"]


def test_shard_params_tp_cuts_each_rank_its_chunk(monkeypatch):
    from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

    tree = tree_from_numpy(_np(_family_params("sana")), "cpu")
    monkeypatch.setattr(tp, "_group_rank", lambda group: (2, 1))  # rank 1 of a tp group of 2
    local = tp.shard_params_tp(tree, "sana")
    q, out = tree["blocks"]["attn1"]["to_q"]["kernel"], tree["blocks"]["attn1"]["to_out"]["kernel"]
    half_q, half_o = q.shape[-1] // 2, out.shape[-2] // 2
    assert torch.equal(local["blocks"]["attn1"]["to_q"]["kernel"], q[..., half_q:])
    assert torch.equal(local["blocks"]["attn1"]["to_out"]["kernel"], out[..., half_o:, :])
    assert local["patch_embed"]["kernel"] is tree["patch_embed"]["kernel"]


WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from hyperscalees_t2i_tpu_torch.models import infinity, sana, zimage
from hyperscalees_t2i_tpu_torch.parallel.collectives import process_rank
from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost
from hyperscalees_t2i_tpu_torch.parallel import tp
from hyperscalees_t2i_tpu_torch.weights.from_jax import infinity_from_jax, tree_from_numpy

src, out, prompts, img_dir = sys.argv[1:5]
d = pickle.load(open(src, "rb"))
initialize_multihost()
T = lambda a: torch.from_numpy(np.asarray(a))
res = {}
with torch.inference_mode():
    for fam in ("sana", "zimage", "infinity"):
        s = d[fam]
        if fam == "infinity":
            build = lambda: infinity_from_jax(s["params"], s["cfg"], "cpu")
            run = lambda m: infinity.generate(m, T(s["emb"])[None], T(s["mask"])[None], T(s["gumbel"])[None],
                                              decode=False)[0]
        else:
            mod = sana.SanaTransformer if fam == "sana" else zimage.ZImageTransformer
            build = lambda: mod(s["cfg"], tree_from_numpy(s["params"], "cpu"))
            run = lambda m: m(*(T(a) for a in s["inputs"]))
        model = build()
        plain = run(model).numpy()
        n = tp.shard_module_tp(model, fam)
        res[fam] = (plain, run(model).numpy(), n)
from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark
run_benchmark.main(["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--prompts_txt",
                    prompts, "--batch_size", "2", "--out_dir", img_dir, "--tp", "2"])
res["stats"] = {k: v[0] for k, v in tp.TP_STATS.items()}
pickle.dump(res, open(f"{out}.{process_rank()}", "wb"))
"""


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    d, jout = {}, {}
    # Sana's DiT
    jcfg, pcfg = _sana_cfgs()
    params = jsana.init_sana(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(1)
    inputs = (rs.randn(2, 8, 8, 4).astype(np.float32), np.array([0.3, 0.7], np.float32),
              rs.randn(2, 6, 16).astype(np.float32), np.array([[1] * 6, [1] * 3 + [0] * 3], bool))
    d["sana"] = dict(cfg=pcfg, params=_np(params), inputs=inputs)
    jout["sana"] = (np.asarray(jsana.sana_forward(params, jcfg, *(jnp.asarray(a) for a in inputs))),
                    jcount_tp_sharded(params, jmake_mesh({TP_AXIS: 2}), "sana"))
    # Z-Image's DiT
    jcfg, pcfg = _zimage_cfgs()
    params = jzimage.init_zimage(jax.random.PRNGKey(0), jcfg)
    inputs = (rs.randn(2, 4, 4, 4).astype(np.float32), np.array([0.3, 0.8], np.float32),
              rs.randn(2, 5, 12).astype(np.float32), np.array([[1] * 5, [1] * 2 + [0] * 3], bool))
    d["zimage"] = dict(cfg=pcfg, params=_np(params), inputs=inputs)
    jout["zimage"] = (np.asarray(jzimage.forward(params, jcfg, *(jnp.asarray(a) for a in inputs))),
                      jcount_tp_sharded(params, jmake_mesh({TP_AXIS: 2}), "zimage"))
    # Infinity with QK-l2 and 2D RoPE
    jcfg = _inf_cfg()
    params = jinf.init_infinity(jax.random.PRNGKey(0), jcfg)
    emb = rs.randn(2, 5, 12).astype(np.float32)
    mask = np.array([[1] * 5, [1] * 3 + [0] * 2], bool)
    key = jax.random.PRNGKey(2)
    d["infinity"] = dict(cfg=inf_port_cfg(jcfg), params=_np(params), emb=emb, mask=mask,
                         gumbel=jax_gumbel(key, jcfg, 2))
    jout["infinity"] = (np.asarray(jinf.generate(params, jcfg, jnp.asarray(emb), jnp.asarray(mask), key,
                                                 decode=False)),
                        jcount_tp_sharded(params, jmake_mesh({TP_AXIS: 2}), "infinity"))
    src = tmp / "models.pkl"
    src.write_bytes(pickle.dumps(d))
    prompts = tmp / "p.txt"
    prompts.write_text("a red cube\na blue sphere\n")
    run_workers(2, WORKER, [str(src), str(tmp / "out"), str(prompts), str(tmp / "tp_images")], timeout_s=240)
    ranks = [pickle.loads((tmp / f"out.{i}").read_bytes()) for i in range(2)]
    return tmp, ranks, jout


@pytest.mark.parametrize("family", ["sana", "zimage", "infinity"])
def test_tp2_forward_matches_unsharded_and_jax(launch, family):
    _, ranks, jout = launch
    plain, sharded, n = ranks[0][family]
    assert np.array_equal(sharded, ranks[1][family][1])  # every rank the same output
    err_port = float(np.abs(sharded - plain).max())
    err_jax = float(np.abs(sharded - jout[family][0]).max())
    print(f"{family} tp 2: max |sharded - unsharded| {err_port:.3g}, max |sharded - JAX| {err_jax:.3g}")
    np.testing.assert_allclose(sharded, plain, **TOL)
    np.testing.assert_allclose(sharded, jout[family][0], **TOL)
    assert n == jout[family][1] > 0


def test_run_benchmark_tp2_writes_the_tp0_images(launch, tmp_path):
    from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark
    from hyperscalees_t2i_tpu_torch.utils.images import read_png

    tmp, ranks, _ = launch
    run_benchmark.main(["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cpu", "--prompts_txt",
                        str(tmp / "p.txt"), "--batch_size", "2", "--out_dir", str(tmp_path), "--tp", "0"])
    refs, tps = sorted(tmp_path.glob("*.png")), sorted((tmp / "tp_images").glob("*.png"))
    assert len(refs) == 2 and [p.name for p in refs] == [p.name for p in tps]
    gap = max(int(np.abs(read_png(a).astype(int) - read_png(b).astype(int)).max()) for a, b in zip(refs, tps))
    print(f"run_benchmark --tp 2 against --tp 0: largest uint8 gap {gap}")
    assert gap <= 1
    assert all(r["stats"]["all_gather"] > 0 and r["stats"]["all_reduce"] > 0 for r in ranks)
