"""``chip_smoke.py``'s released-layout checkpoint writers, held at tiny
geometry: the key inventories it writes for ``var_d*.pth``,
``vae_ch160v4096z32.pth``, the diffusers ``SanaTransformer2DModel``, an
Infinity transformer ``.pth`` and its BSQ tokenizer are accepted by the JAX
and the port converters alike, with bitwise-equal trees (the VAR and Sana
ones with the structure and shapes of the port's ``init_*`` trees), and
the geometry inferred back from them is the config they were written for.
The bf16 ``.pth`` writer's files read alike in both packages. At Infinity-2B's
full geometry the key inventory's shapes alone (zero-stride views, no
values) infer the ``inf_2b`` rung's configuration through the port CLI's
``--infinity_variant 2b --pn 1M``, as the JAX CLI's steps do. The card
phases run the same writers at full width, where only the card would see a
wrong key."""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import bsq as jbsq
from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.weights import infinity as jwi
from hyperscalees_t2i_tpu.weights import sana as jws
from hyperscalees_t2i_tpu.weights import var as jwv
from hyperscalees_t2i_tpu.weights.io import load_state_dict as jload
from hyperscalees_t2i_tpu_torch.models import bsq, infinity, msvq, sana, var
from hyperscalees_t2i_tpu_torch.rungs import infinity_rung_model
from hyperscalees_t2i_tpu_torch.train import cli
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map
from hyperscalees_t2i_tpu_torch.weights import infinity as pwi
from hyperscalees_t2i_tpu_torch.weights import sana as pws
from hyperscalees_t2i_tpu_torch.weights import var as pwv
from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy
from hyperscalees_t2i_tpu_torch.weights.io import load_state_dict

from test_torch_weights_var import assert_config_fields, assert_trees_bitwise

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_writers", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

VQ = dict(vocab_size=16, c_vae=4, patch_nums=(1, 2, 4), phi_partial=2, ch=8, ch_mult=(1, 2), num_res_blocks=1)
VAR = dict(num_classes=5, depth=2, d_model=16, n_heads=2, ff_ratio=2.0, patch_nums=(1, 2, 4))
# d 140 keeps SanaConfig's default head counts (70 and 20) whole: the heads
# are not in the checkpoint, so inference keeps the defaults
SANA = dict(in_channels=4, out_channels=4, d_model=140, n_layers=2, caption_dim=8)
# the released attention flags (QK-l2 on both attentions, 2D RoPE); the
# tokenizer's decoder widths (16, 8) give CompVis levels of two widths
INF_PNS = (1, 2, 4)
INF = dict(depth=2, d_model=16, n_heads=2, ff_ratio=2.0, text_dim=12, patch_nums=INF_PNS, attn_l2_norm=True,
           cross_attn_l2_norm=True, use_rope2d=True)
BSQ = dict(bits=4, patch_nums=INF_PNS, phi_partial=4, dec_ch=(16, 8), dec_blocks=1)


def inf_cfgs(**kw):
    """The port's and the JAX ``InfinityConfig`` at the tiny geometry, f32."""
    port = infinity.InfinityConfig(vq=bsq.BSQConfig(compute_dtype=torch.float32, **BSQ),
                                   compute_dtype=torch.float32, **{**INF, **kw})
    ref = jinf.InfinityConfig(vq=jbsq.BSQConfig(compute_dtype=jnp.float32, **BSQ), compute_dtype=jnp.float32,
                              **{**INF, **kw})
    return port, ref


def bf16_cut(v):
    """The f32 values a bf16 torch pickle of ``v`` reads back as."""
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _shapes(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def _np_shapes(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def _lists(tree):
    """Shape trees compare lists and tuples alike."""
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lists(v) for v in tree]
    return tree


def test_var_and_vqvae_writers_convert_in_both_packages():
    vq = msvq.MSVQConfig(compute_dtype=torch.float32, **VQ)
    cfg = var.VARConfig(vq=vq, compute_dtype=torch.float32, **VAR)
    jvq = jmsvq.MSVQConfig(compute_dtype=jnp.float32, **VQ)
    jcfg = jvar.VARConfig(vq=jvq, compute_dtype=jnp.float32, **VAR)
    sd = cs.released_state_dict(cs.released_var_keys(cfg), seed=1)
    vsd = cs.released_state_dict(cs.released_vqvae_keys(vq), seed=2)
    assert {"lvl_1L", "attn_bias_for_masking", "blocks.1.attn.zero_k_bias"} <= set(sd)
    assert any(k.startswith("encoder.down.1.attn.") for k in vsd) and "quantize.ema_vocab_hit_SV" in vsd
    tree, ref = pwv.convert_var_transformer(sd, cfg), jwv.convert_var_transformer(sd, jcfg)
    tree["vq"], ref["vq"] = pwv.convert_vqvae(vsd, vq), jwv.convert_vqvae(vsd, jvq)
    assert assert_trees_bitwise(tree, ref) > 60
    assert _lists(_np_shapes(tree)) == _lists(_shapes(var.init_var(cfg, threefry.prng_key(0, "cpu"))))
    assert_config_fields(pwv.infer_var_config(sd, patch_nums=cfg.patch_nums, vq=vq, compute_dtype=torch.float32),
                         cfg)


def test_sana_writer_converts_in_both_packages(tmp_path):
    cfg = sana.SanaConfig(compute_dtype=torch.float32, **SANA)
    jcfg = jsana.SanaConfig(compute_dtype=jnp.float32, **SANA)
    keys = cs.released_sana_keys(cfg)
    sd = cs.released_state_dict(keys, seed=3)
    tree, ref = pws.convert_sana_transformer(sd, cfg), jws.convert_sana_transformer(sd, jcfg)
    assert assert_trees_bitwise(tree, ref) > 30
    assert _lists(_np_shapes(tree)) == _lists(_shapes(sana.init_sana(cfg, threefry.prng_key(0, "cpu"))))
    assert_config_fields(pws.infer_sana_config(sd, compute_dtype=torch.float32), cfg)
    # the bf16 file the card phase writes: the values cut to bf16, read alike by both packages
    path = tmp_path / "transformer.safetensors"
    size = cs.write_released_safetensors(path, keys, seed=3)
    assert size == path.stat().st_size
    port, ref_sd = load_state_dict(path), jload(str(path))
    for k, v in sd.items():
        cut = (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        assert port[k].dtype == np.float32 and np.array_equal(port[k], cut), k
    assert_trees_bitwise(pws.convert_sana_transformer(port, cfg), jws.convert_sana_transformer(ref_sd, jcfg))


def test_released_values_are_seeded_and_scaled():
    a = cs.released_state_dict([("w.weight", (64, 32)), ("n.norm1.weight", (64,)), ("b.bias", (64,)),
                                ("x.attn.scale_mul_1H11", (1, 4, 1, 1)), ("x.attn.zero_k_bias", (8,))], seed=5)
    b = cs.released_state_dict([("w.weight", (64, 32))], seed=5)
    assert np.array_equal(a["w.weight"], b["w.weight"])
    assert 0.1 < float(a["w.weight"].std()) < 0.25  # 1/√32
    assert abs(float(a["n.norm1.weight"].mean()) - 1.0) < 0.01 and float(np.abs(a["b.bias"]).max()) < 0.1
    assert abs(float(a["x.attn.scale_mul_1H11"].mean()) - np.log(4.0)) < 0.2
    assert not a["x.attn.zero_k_bias"].any()


@pytest.mark.parametrize("field", ["depth", "d_model"])
def test_var_writer_follows_the_geometry(field):
    cfg = var.VARConfig(vq=msvq.MSVQConfig(**VQ), **{**VAR, field: 2 * VAR[field]})
    got = pwv.infer_var_config(cs.released_state_dict(cs.released_var_keys(cfg), seed=0),
                               patch_nums=cfg.patch_nums, vq=cfg.vq)
    assert getattr(got, field) == getattr(cfg, field)


@pytest.mark.parametrize("shared_aln", [True, False], ids=["shared_aln", "per_block_aln"])
def test_infinity_and_bsq_pth_writers_convert_in_both_packages(tmp_path, shared_aln):
    cfg, jcfg = inf_cfgs()
    keys, vkeys = cs.released_infinity_keys(cfg, shared_aln=shared_aln), cs.released_bsq_keys(cfg.vq)
    paths = tmp_path / "transformer.pth", tmp_path / "tokenizer.pth"
    for path, ks, seed in ((paths[0], keys, 4), (paths[1], vkeys, 5)):
        assert cs.write_released_pth(path, ks, seed=seed) == path.stat().st_size
        port, ref = load_state_dict(path), jload(str(path))
        want = cs.released_state_dict(ks, seed=seed)
        assert sorted(port) == sorted(ref) == sorted(want)
        for k, v in want.items():  # the values rounded to bf16 as the writer rounds them, read as f32
            assert port[k].dtype == np.float32 and np.array_equal(port[k], bf16_cut(v)), k
            assert np.array_equal(port[k], ref[k]), k
    sd, vsd = load_state_dict(paths[0]), load_state_dict(paths[1])
    tree, want = pwi.convert_infinity_transformer(sd, cfg), jwi.convert_infinity_transformer(sd, jcfg)
    tree["vq"], want["vq"] = pwi.convert_bsq_vae(vsd, cfg.vq), jwi.convert_bsq_vae(vsd, jcfg.vq)
    assert assert_trees_bitwise(tree, want) > 70
    # the scale table cut to the schedule, the AdaLN a kernel a block either way
    assert tree["lvl_emb"].shape == (len(INF_PNS), INF["d_model"]) and sd["lvl_embed.weight"].shape[0] == 15
    assert tree["blocks"]["ada_lin"]["kernel"].shape == (INF["depth"], INF["d_model"], 6 * INF["d_model"])
    assert tree["blocks"]["cross_scale_mul"].shape == (INF["depth"], INF["n_heads"])
    # the CompVis decoder the converter found: a level per width, dec_blocks + 1 blocks a level
    up = tree["vq"]["decoder"]["up"]
    assert len(up) == len(BSQ["dec_ch"]) and all(len(lv["block"]) == BSQ["dec_blocks"] + 1 for lv in up)
    assert tree["vq"]["decoder"]["mid"]["attn_1"] is not None and "nin" in up[0]["block"][0]
    # the converted trees build the port's model (the tokenizer's CompVis decoder included)
    model = infinity.InfinityTransformer(cfg, tree_from_numpy(tree, "cpu"))
    assert len(model.blocks) == INF["depth"]


def test_infinity_writers_name_what_the_converters_ignore():
    cfg, jcfg = inf_cfgs()
    sd = cs.released_state_dict(cs.released_infinity_keys(cfg), seed=6)
    vsd = cs.released_state_dict(cs.released_bsq_keys(cfg.vq), seed=7)
    buffers = sorted(k for k in sd if k.split(".")[-1] in cs.RELEASED_BUFFERS)
    assert buffers == ["attn_bias_for_masking", "blocks.0.sa.zero_k_bias", "blocks.1.sa.zero_k_bias", "lvl_1L"]
    assert all(pwi._INF_IGNORE.search(k) for k in buffers) and not any(sd[k].any() for k in buffers)
    encoder = [k for k in vsd if k.startswith(("encoder.", "quant_conv."))]
    assert len(encoder) > 30 and all(pwi._BSQ_IGNORE.search(k) for k in encoder)
    assert any(k.startswith("encoder.mid.attn_1.") for k in encoder)
    # strict in both packages: one tensor more of either file raises, naming it
    for convert, c in ((pwi.convert_infinity_transformer, cfg), (jwi.convert_infinity_transformer, jcfg)):
        with pytest.raises(ValueError, match="blocks.1.ca.stray"):
            convert(dict(sd, **{"blocks.1.ca.stray": np.zeros(2, np.float32)}), c)
    for convert, c in ((pwi.convert_bsq_vae, cfg.vq), (jwi.convert_bsq_vae, jcfg.vq)):
        with pytest.raises(ValueError, match="decoder.stray"):
            convert(dict(vsd, **{"decoder.stray": np.zeros(2, np.float32)}), c)


def test_infinity_writer_infers_its_geometry_in_both_packages():
    cfg, _ = inf_cfgs()
    sd = cs.released_state_dict(cs.released_infinity_keys(cfg), seed=8)
    over = dict(patch_nums=INF_PNS, compute_dtype=torch.float32)
    got = pwi.infer_infinity_config(sd, **over)
    assert_config_fields(got, jwi.infer_infinity_config(sd, patch_nums=INF_PNS, compute_dtype=jnp.float32))
    for f in INF:
        assert getattr(got, f) == getattr(cfg, f), f
    assert (got.vq.bits, got.vq.patch_nums) == (BSQ["bits"], INF_PNS)


def _shapes_only(keys):
    """A state dict of zero-stride views: each key's shape, no values (the
    heads are read off the QK-l2 scales' size)."""
    return {k: np.broadcast_to(np.float32(0.0), s) for k, s in keys}


def test_infinity_writer_at_the_inf_2b_geometry_infers_the_rung():
    rung = infinity_rung_model("2b")["bcfg"].model
    keys = cs.released_infinity_keys(rung)
    assert 2.1e9 < sum(int(np.prod(s)) for _, s in keys) < 2.4e9  # ≈ 4.5 GB in bf16
    sd = _shapes_only(keys)
    args = cli.build_parser().parse_args(["--backend", "infinity", "--infinity_variant", "2b", "--pn", "1M"])
    got = cli.infinity_model(args, sd)
    assert got == rung == infinity.released_config("2b", "1M")
    # the JAX CLI's steps: the preset's geometry over the inferred one, then the 1M schedule on both
    ref = jwi.infer_infinity_config(sd, **jinf.INFINITY_PRESETS["2b"])
    pns = jinf.PN_PRESETS["1M"]
    ref = dataclasses.replace(ref, patch_nums=pns, vq=dataclasses.replace(ref.vq, patch_nums=pns))
    assert_config_fields(got, ref)
    assert (got.depth, got.d_model, got.n_heads, got.head_dim, got.seq_len, got.vq.bits) == (32, 2048, 16, 128, 9451,
                                                                                              32)
    vkeys = dict(cs.released_bsq_keys(rung.vq))
    assert vkeys["decoder.conv_in.weight"] == (512, 32, 3, 3) and vkeys["decoder.conv_out.weight"] == (3, 128, 3, 3)
    assert sum(1 for k in vkeys if k.startswith("quantize.quant_resi.qresi_ls.") and k.endswith("weight")) == 4


@pytest.mark.parametrize("field", ["depth", "d_model", "n_heads", "text_dim"])
def test_infinity_writer_follows_the_geometry(field):
    twice = {"depth": 4, "d_model": 32, "n_heads": 4, "text_dim": 24}
    cfg, _ = inf_cfgs(**{field: twice[field]})
    got = pwi.infer_infinity_config(cs.released_state_dict(cs.released_infinity_keys(cfg), seed=0),
                                    patch_nums=INF_PNS)
    assert getattr(got, field) == getattr(cfg, field)


def test_infinity_launch_rule_counts_the_converted_tree(monkeypatch):
    """``chip_smoke.expected_inf_launches`` on the tree converted from the
    writers' files (its head AdaLN ``head_ada``, absent from a random
    tree; the tokenizer's CompVis decoder) against the calls one generate
    call makes of K1's and K4's plain versions on the CPU, an int8 base
    without ``pop_fuse`` (the adapted sites run K1 with no adapter)."""
    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend, InfinityBackendConfig
    from hyperscalees_t2i_tpu_torch.ops import attention, quant_mm
    from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

    cfg, _ = inf_cfgs(d_model=32)  # head_ada 32 x 64 reaches the floor; φ's 576 values do not
    tree = pwi.convert_infinity_transformer(cs.released_state_dict(cs.released_infinity_keys(cfg), seed=9), cfg)
    tree["vq"] = pwi.convert_bsq_vae(cs.released_state_dict(cs.released_bsq_keys(cfg.vq), seed=10), cfg.vq)
    backend = InfinityBackend(InfinityBackendConfig(model=cfg), "cpu", params=quantize_tree(tree_from_numpy(tree, "cpu"),
                                                                                               600),
                              prompts=["a red square", "a blue circle"])
    backend.setup()
    assert hasattr(backend.model.head_ada, "q8")
    _, per = cs.expected_inf_launches(backend, None, TrainConfig(pop_size=2, member_batch=1), 2)
    calls = {"k1": 0, "k4": 0}

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(quant_mm, "int8_matmul_reference", counted("k1", quant_mm.int8_matmul_reference))
    monkeypatch.setattr(attention, "naive_masked_attention", counted("k4", attention.naive_masked_attention))
    with torch.inference_mode():
        images = backend.generate_p(None, torch.tensor([[0, 1]]), threefry.prng_key(3, "cpu")[None])
    assert bool(torch.isfinite(images).all())
    assert (calls["k1"], calls["k4"]) == (per["k1_per_call"], per["k4_per_call"]) and per["k3_per_call"] == 0
    assert per["k4_per_call"] == 2 * len(INF_PNS) * INF["depth"]
