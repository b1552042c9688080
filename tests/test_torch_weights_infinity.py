"""The port's Infinity converters (``hyperscalees_t2i_tpu_torch.weights.
infinity``) against the JAX package's, on the synthetic public-layout state
dicts of ``tests/test_weights_infinity.py`` (``make_sd`` with its
``shared_aln``, ``blk_prefix`` and ``qk_l2`` variants) and a CompVis-style
BSQ tokenizer built from ``TDecoder`` (``tests/test_weights_var.py``).

- Trees bitwise equal to the JAX converters' for every variant (the qkv
  zero-k-bias fold, the shared-AdaLN expansion, the unregistered block
  prefix, QK-l2 scales, a Sequential(norm, Linear) text projection) and
  for the BSQ tokenizer (its encoder ignored).
- ``infer_infinity_config`` field by field; the refusals (strictness, the
  attention flags against the checkpoint, a trained norm, the BSQ geometry
  guards) with the same messages.
- With the converted weights (QK-l2, 2D RoPE, the converted tokenizer) and
  JAX's sampling noise injected: the port's ``generate`` samples the same
  bits (f̂ equal, measured 0) and its images are within 3e-4 of the JAX
  call's (measured 9.5e-7); the tokenizer's decoder and φ within 1e-4
  (measured 4.8e-7 and 0).
- The port CLI loads an Infinity checkpoint and a BSQ ``--vae_weights`` as
  the JAX CLI does (``test_cli_loads_infinity_checkpoint``): the same
  inferred model, and the backend's tree is the JAX backend's, stored in
  the compute dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import bsq as jbsq
from hyperscalees_t2i_tpu.models import infinity as jinf
from hyperscalees_t2i_tpu.weights import infinity as jw
from hyperscalees_t2i_tpu_torch.models import bsq, infinity
from hyperscalees_t2i_tpu_torch.weights import infinity as pw
from hyperscalees_t2i_tpu_torch.weights.from_jax import bsq_from_jax, infinity_from_jax

import test_weights_infinity as twi
from test_torch_infinity import jax_gumbel, port_cfg, port_vq
from test_torch_weights_var import _raise_msg, assert_config_fields, assert_trees_bitwise
from test_weights_var import TDecoder

torch.set_num_threads(1)
PRIM_TOL, E2E_TOL = 1e-4, 3e-4
VARIANTS = {
    "plain": (dict(), twi.tiny_cfg),
    "shared_aln": (dict(shared_aln=True), twi.tiny_cfg),
    "unregistered_blocks": (dict(blk_prefix="unregistered_blocks"), twi.tiny_cfg),
    "qk_l2": (dict(qk_l2=True), twi.qk_l2_cfg),
}


class TBSQVAE(torch.nn.Module):
    """A CompVis-style BSQ tokenizer with the released key names: φ convs,
    ``post_quant_conv``, the decoder, and an encoder the converters ignore."""

    def __init__(self, z=twi.BITS, ch=8, ch_mult=(1, 2), nrb=1, K=2):
        super().__init__()
        nn_t = torch.nn
        self.quantize = nn_t.Module()
        self.quantize.quant_resi = nn_t.Module()
        self.quantize.quant_resi.qresi_ls = nn_t.ModuleList([nn_t.Conv2d(z, z, 3, 1, 1) for _ in range(K)])
        self.post_quant_conv = nn_t.Conv2d(z, z, 3, 1, 1)
        self.decoder = TDecoder(z, ch, ch_mult, nrb)
        self.encoder = nn_t.Module()
        self.encoder.conv_in = nn_t.Conv2d(3, ch, 3, 1, 1)


def bsq_sd(seed, K=2):
    torch.manual_seed(seed)
    return {k: v.detach().numpy() for k, v in TBSQVAE(K=K).eval().state_dict().items()}


def jax_vq_cfg(K=2):
    return jbsq.BSQConfig(bits=twi.BITS, patch_nums=twi.PNS, phi_partial=K, compute_dtype=jnp.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_transformer_tree_bitwise_and_config_fields(variant, capsys):
    kw, jcfg = VARIANTS[variant]
    sd = twi.make_sd(np.random.default_rng(3), **kw)
    tree, ref = pw.convert_infinity_transformer(sd, port_cfg(jcfg())), jw.convert_infinity_transformer(sd, jcfg())
    assert assert_trees_bitwise(tree, ref) == (32 if variant == "qk_l2" else 30)
    got, want = pw.infer_infinity_config(sd, patch_nums=twi.PNS), jw.infer_infinity_config(sd, patch_nums=twi.PNS)
    assert_config_fields(got, want)
    assert (got.depth, got.d_model, got.text_dim, got.vq.bits) == (twi.DEPTH, twi.D_, twi.TEXT, twi.BITS)
    assert (got.attn_l2_norm, got.use_rope2d, got.cross_attn_l2_norm) == ((variant == "qk_l2",) * 3)
    # heads: off the scale tensor, else the default with a warning (no preset is (2, 16))
    assert got.n_heads == (twi.HEADS if variant == "qk_l2" else infinity.InfinityConfig.n_heads)
    out = capsys.readouterr().out
    assert out.count("matches no preset") == (0 if variant == "qk_l2" else 2)


def test_infer_matches_a_preset_and_overrides():
    sd = twi.make_sd(np.random.default_rng(8))
    got = pw.infer_infinity_config(sd, patch_nums=twi.PNS, n_heads=4, ff_ratio=2.0)
    assert_config_fields(got, jw.infer_infinity_config(sd, patch_nums=twi.PNS, n_heads=4, ff_ratio=2.0))
    assert got.n_heads == 4 and got.vq.patch_nums == twi.PNS


def test_refusals_name_the_same_things():
    cfg, jcfg = port_cfg(twi.tiny_cfg()), twi.tiny_cfg()
    sd = twi.make_sd(np.random.default_rng(4))
    stray = dict(sd, **{"blocks.0.sa.stray_tensor": np.zeros((2, 2), np.float32)})
    msg = _raise_msg(pw.convert_infinity_transformer, stray, cfg)
    assert "blocks.0.sa.stray_tensor" in msg and msg == _raise_msg(jw.convert_infinity_transformer, stray, jcfg)
    l2 = twi.make_sd(np.random.default_rng(6), qk_l2=True)
    msg = _raise_msg(pw.convert_infinity_transformer, l2, cfg)
    assert "attn_l2_norm" in msg and msg == _raise_msg(jw.convert_infinity_transformer, l2, jcfg)
    msg = _raise_msg(pw.convert_infinity_transformer, sd, port_cfg(twi.qk_l2_cfg()))
    assert "no blocks" in msg and msg == _raise_msg(jw.convert_infinity_transformer, sd, twi.qk_l2_cfg())
    few = dataclasses.replace(twi.tiny_cfg(), patch_nums=tuple(range(1, 12)))
    msg = _raise_msg(pw.convert_infinity_transformer, sd, port_cfg(few))
    assert "lvl_embed" in msg and msg == _raise_msg(jw.convert_infinity_transformer, sd, few)
    # a Sequential(norm, Linear) text projection: converted when the norm is the identity
    seq = dict(sd)
    seq["text_proj_for_ca.1.weight"], seq["text_proj_for_ca.1.bias"] = seq.pop("text_proj_for_ca.weight"), \
        seq.pop("text_proj_for_ca.bias")
    seq["text_proj_for_ca.0.weight"] = np.ones(twi.TEXT, np.float32)
    assert_trees_bitwise(pw.convert_infinity_transformer(seq, cfg), jw.convert_infinity_transformer(seq, jcfg))
    seq["text_proj_for_ca.0.weight"] = np.full(twi.TEXT, 2.0, np.float32)
    msg = _raise_msg(pw.convert_infinity_transformer, seq, cfg)
    assert "trained norm scale" in msg and msg == _raise_msg(jw.convert_infinity_transformer, seq, jcfg)


def test_bsq_vae_tree_bitwise_decode_phi_and_guards():
    sd = bsq_sd(11)
    vcfg = port_vq(jax_vq_cfg())
    tree, ref = pw.convert_bsq_vae(sd, vcfg), jw.convert_bsq_vae(sd, jax_vq_cfg())
    assert "mid" in tree["decoder"] and assert_trees_bitwise(tree, ref) > 40
    vq = bsq_from_jax(tree, vcfg, "cpu")
    f_hat = torch.randn(2, 4, 4, twi.BITS, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        got = bsq.decode_img(vq, f_hat).numpy()
        pgot = bsq.phi_apply(vq, f_hat[:1], len(twi.PNS) - 1).numpy()
    want = np.asarray(jbsq.decode_img(ref, jax_vq_cfg(), jnp.asarray(f_hat.numpy())))
    pwant = np.asarray(jbsq.phi_apply(ref, jax_vq_cfg(), jnp.asarray(f_hat[:1].numpy()), len(twi.PNS) - 1))
    assert float(np.abs(got - want).max()) <= PRIM_TOL and float(np.abs(pgot - pwant).max()) <= PRIM_TOL
    stray = dict(sd, **{"decoder.stray": np.zeros(2, np.float32)})
    msg = _raise_msg(pw.convert_bsq_vae, stray, vcfg)
    assert "decoder.stray" in msg and msg == _raise_msg(jw.convert_bsq_vae, stray, jax_vq_cfg())
    for bad in (dict(phi_partial=3), dict(bits=8)):
        msg = _raise_msg(pw.convert_bsq_vae, sd, dataclasses.replace(vcfg, **bad))
        assert msg == _raise_msg(jw.convert_bsq_vae, sd, dataclasses.replace(jax_vq_cfg(), **bad))
    no_phi = {k: v for k, v in sd.items() if "qresi" not in k}
    assert _raise_msg(pw.convert_bsq_vae, no_phi, vcfg) == _raise_msg(jw.convert_bsq_vae, no_phi, jax_vq_cfg())


def test_load_bsq_vae_strips_module(tmp_path):
    sd = bsq_sd(13)
    torch.save({"module": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "bsq.pth")
    got = pw.load_bsq_vae(tmp_path / "bsq.pth", port_vq(jax_vq_cfg()))
    assert_trees_bitwise(got, jw.load_bsq_vae(str(tmp_path / "bsq.pth"), jax_vq_cfg()))
    torch.save({k: torch.from_numpy(v) for k, v in twi.make_sd(np.random.default_rng(14)).items()},
               tmp_path / "inf.pth")
    assert_trees_bitwise(pw.load_infinity_params(tmp_path / "inf.pth", port_cfg(twi.tiny_cfg())),
                         jw.load_infinity_params(str(tmp_path / "inf.pth"), twi.tiny_cfg()))


def test_generate_with_converted_weights_matches_jax():
    sd = twi.make_sd(np.random.default_rng(10), qk_l2=True)
    jcfg = twi.qk_l2_cfg()
    jcfg = dataclasses.replace(jcfg, vq=dataclasses.replace(jax_vq_cfg(), patch_nums=jcfg.patch_nums))
    cfg = port_cfg(jcfg)
    tree, ref = pw.convert_infinity_transformer(sd, cfg), jw.convert_infinity_transformer(sd, jcfg)
    vsd = bsq_sd(15)
    tree["vq"], ref["vq"] = pw.convert_bsq_vae(vsd, cfg.vq), jw.convert_bsq_vae(vsd, jcfg.vq)
    emb = np.random.RandomState(5).randn(2, 5, twi.TEXT).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jinf.generate(ref, jcfg, jnp.asarray(emb), jnp.asarray(mask), key))
    jf_hat = np.asarray(jinf.generate(ref, jcfg, jnp.asarray(emb), jnp.asarray(mask), key, decode=False))
    model = infinity_from_jax(tree, cfg, "cpu")
    gumbel = torch.from_numpy(jax_gumbel(key, jcfg, 2))[None]
    with torch.inference_mode():
        args = (model, torch.from_numpy(emb)[None], torch.from_numpy(mask)[None], gumbel)
        got = infinity.generate(*args)[0].numpy()
        f_hat = infinity.generate(*args, decode=False)[0].numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    assert np.array_equal(f_hat, jf_hat)  # every sampled bit equal
    assert float(np.abs(got - want).max()) <= E2E_TOL


def test_cli_loads_an_infinity_checkpoint_and_a_bsq_vae(tmp_path, monkeypatch):
    from hyperscalees_t2i_tpu.train import cli as jcli
    from hyperscalees_t2i_tpu_torch.models import infinity as inf_mod
    from hyperscalees_t2i_tpu_torch.train import cli

    sd = twi.make_sd(np.random.default_rng(5))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "infinity.pt")
    # the inferred tokenizer config keeps BSQConfig's 4 φ convs
    torch.save({k: torch.from_numpy(v) for k, v in bsq_sd(16, K=4).items()}, tmp_path / "bsq.pth")
    (tmp_path / "p.txt").write_text("a red square\n")
    argv = ["--backend", "infinity", "--weights", str(tmp_path / "infinity.pt"), "--vae_weights",
            str(tmp_path / "bsq.pth"), "--prompts_txt", str(tmp_path / "p.txt"), "--lora_r", "2"]
    jb = jcli.build_backend(jcli.build_parser().parse_args(argv))
    pb = cli.build_backend(cli.build_parser().parse_args(argv), torch.device("cpu"))
    assert_config_fields(pb.cfg.model, jb.cfg.model)
    assert pb.cfg.model.depth == twi.DEPTH and pb.cfg.model.vq.bits == twi.BITS
    assert pb.cfg.vae_weights == jb.cfg.vae_weights == str(tmp_path / "bsq.pth")
    built = []
    real = inf_mod.InfinityTransformer
    monkeypatch.setattr(inf_mod, "InfinityTransformer", lambda c, p: built.append(p) or real(c, p))
    jb.setup()
    pb.setup()
    dt = pb.cfg.model.compute_dtype
    assert dt == torch.bfloat16  # the inferred geometry keeps the released compute dtype

    def walk(p, r, path=""):  # the JAX backend's f32 tree, stored in the compute dtype by the port's CLI
        if isinstance(r, dict):
            assert sorted(p) == sorted(r), path
            return sum(walk(p[k], r[k], f"{path}/{k}") for k in r)
        if isinstance(r, (list, tuple)):
            return sum(walk(a, b, f"{path}/{i}") for i, (a, b) in enumerate(zip(p, r)))
        if r is None:
            assert p is None
            return 0
        assert p.dtype == dt and torch.equal(p, torch.from_numpy(np.array(r)).to(dt)), path
        return 1

    assert walk(built[0], jb.params) > 70
