"""The port's VAR converters (``hyperscalees_t2i_tpu_torch.weights.var``)
against the JAX package's, on the state dicts of the reference-layout torch
modules ``tests/test_weights_var.py`` defines (``TVAR``, ``TVQVAE``: the
released ``var_d*.pth`` / ``vae_ch160v4096z32.pth`` key names at tiny
geometry).

- Trees bitwise equal to the JAX converters' (structure, shapes, dtypes,
  values), the VQ-VAE's encoder and pre-quant conv ignored by both.
- ``infer_var_config`` field by field, its refusals with the same messages.
- Strictness: a stray tensor raises with the same leftover names.
- With the converted weights, the port's teacher-forced forward within 1e-4
  of the JAX one (measured 4.8e-7) and of the reference torch module
  (measured 2.4e-7), the VQ-VAE decoder and φ within 1e-4 of JAX
  (measured 6.0e-7 and 0).
- ``load_var_params`` from ``.pth`` files, and the port CLI's ``--weights
  --vae_weights`` at the canonical token geometry: the converted tree is
  the backend's, and a generate call is finite.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.weights import var as jw
from hyperscalees_t2i_tpu.weights.io import load_state_dict as jload
from hyperscalees_t2i_tpu_torch.models import msvq, var
from hyperscalees_t2i_tpu_torch.weights import var as pw
from hyperscalees_t2i_tpu_torch.weights.from_jax import msvq_from_jax, var_from_jax

from test_weights_var import TVAR, TVQVAE

torch.set_num_threads(1)
PRIM_TOL = 1e-4


def assert_trees_bitwise(port, ref, path="") -> int:
    """Leaf by leaf: the same structure, shapes, dtypes and bits (``None``
    leaves and lists included). Returns the number of leaves."""
    if ref is None:
        assert port is None, path
        return 0
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(set(port) ^ set(ref)))
        return sum(assert_trees_bitwise(port[k], ref[k], f"{path}/{k}") for k in ref)
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), path
        return sum(assert_trees_bitwise(p, r, f"{path}/{i}") for i, (p, r) in enumerate(zip(port, ref)))
    a = port.detach().cpu().numpy() if hasattr(port, "detach") else np.asarray(port)
    b = np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), path
    return 1


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def assert_config_fields(port, ref, path=""):
    """Every field of the port's config equal to the JAX config's field of
    the same name (dtypes by name, nested configs field by field)."""
    names = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        assert f.name in names, f"{path}{f.name}"
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(p):
            assert_config_fields(p, r, f"{path}{f.name}.")
        elif f.name == "compute_dtype":
            assert _dtype_name(p) == _dtype_name(r), f"{path}{f.name}"
        else:
            assert p == r, (f"{path}{f.name}", p, r)


def state_dict(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def tiny_vq(jax_side: bool, **kw):
    mod, dt = (jmsvq, jnp.float32) if jax_side else (msvq, torch.float32)
    base = dict(vocab_size=8, c_vae=4, patch_nums=(1, 2), phi_partial=2, ch=8, ch_mult=(1,), num_res_blocks=1,
                compute_dtype=dt)
    return mod.MSVQConfig(**{**base, **kw})


def tiny_var(jax_side: bool):
    mod, dt = (jvar, jnp.float32) if jax_side else (var, torch.float32)
    return mod.VARConfig(num_classes=5, depth=2, d_model=16, n_heads=2, ff_ratio=2.0, patch_nums=(1, 2),
                         vq=tiny_vq(jax_side), attn_l2_norm=True, compute_dtype=dt)


def vqvae_sd(seed, V=8, z=4, ch=8, ch_mult=(1,), nrb=1, K=2):
    """A ``TVQVAE`` state dict plus the encoder and ``quant_conv`` tensors a
    released file carries (ignored by the converters)."""
    torch.manual_seed(seed)
    sd = state_dict(TVQVAE(V, z, ch, ch_mult, nrb, K).eval())
    rng = np.random.default_rng(seed)
    sd["encoder.conv_in.weight"] = rng.standard_normal((ch, 3, 3, 3)).astype(np.float32)
    sd["encoder.conv_in.bias"] = rng.standard_normal(ch).astype(np.float32)
    sd["quant_conv.weight"] = rng.standard_normal((z, z, 3, 3)).astype(np.float32)
    sd["quant_conv.bias"] = rng.standard_normal(z).astype(np.float32)
    return sd


def test_var_transformer_tree_bitwise_and_forward():
    torch.manual_seed(2)
    tm = TVAR(5, 16, 2, 2, (1, 2), 8, 4).eval()
    sd = state_dict(tm)
    tree, ref = pw.convert_var_transformer(sd, tiny_var(False)), jw.convert_var_transformer(sd, tiny_var(True))
    assert assert_trees_bitwise(tree, ref) == 21
    vsd = vqvae_sd(3)
    tree["vq"], ref["vq"] = pw.convert_vqvae(vsd, tiny_vq(False)), jw.convert_vqvae(vsd, tiny_vq(True))
    assert_trees_bitwise(tree["vq"], ref["vq"])

    labels = torch.tensor([1, 4])
    inputs = torch.randn(2, tiny_var(False).seq_len - 1, 4, generator=torch.Generator().manual_seed(4))
    scale_inputs = torch.cat([torch.zeros(2, 1, 4), inputs], dim=1)
    with torch.no_grad():
        want = tm(labels, inputs).numpy()
        got = var.forward_teacher(var_from_jax(tree, tiny_var(False), "cpu"), labels, scale_inputs).numpy()
    jgot = np.asarray(jvar.forward_teacher(ref, tiny_var(True), jnp.asarray(labels.numpy()),
                                           jnp.asarray(scale_inputs.numpy())))
    assert float(np.abs(got - jgot).max()) <= PRIM_TOL
    assert float(np.abs(got - want).max()) <= PRIM_TOL


def test_vqvae_tree_bitwise_decode_and_phi():
    cfg, jcfg = tiny_vq(False, vocab_size=16, patch_nums=(1, 2, 4), ch_mult=(1, 2)), \
        tiny_vq(True, vocab_size=16, patch_nums=(1, 2, 4), ch_mult=(1, 2))
    sd = vqvae_sd(1, V=16, ch_mult=(1, 2))
    tree, ref = pw.convert_vqvae(sd, cfg), jw.convert_vqvae(sd, jcfg)
    assert_trees_bitwise(tree, ref)
    vq = msvq_from_jax(tree, cfg, "cpu")
    f_hat = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = msvq.decode_img(vq, f_hat).numpy()
        pgot = msvq.phi_apply(vq, f_hat[:1], 2).numpy()
    want = np.asarray(jmsvq.decode_img(ref, jcfg, jnp.asarray(f_hat.numpy())))
    pwant = np.asarray(jmsvq.phi_apply(ref, jcfg, jnp.asarray(f_hat[:1].numpy()), si=2))
    assert float(np.abs(got - want).max()) <= PRIM_TOL and float(np.abs(pgot - pwant).max()) <= PRIM_TOL
    # the geometry guards refuse as the reference does
    for bad in (dict(ch_mult=(1, 2, 2)), dict(num_res_blocks=2), dict(using_sa=False), dict(using_mid_sa=False)):
        assert _raise_msg(pw.convert_vqvae, sd, dataclasses.replace(cfg, **bad)) == \
            _raise_msg(jw.convert_vqvae, sd, dataclasses.replace(jcfg, **bad))


def _raise_msg(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_infer_var_config_matches_jax_field_by_field(capsys):
    torch.manual_seed(9)
    sd = state_dict(TVAR(5, 16, 2, 2, (1, 2), 8, 4).eval())
    got = pw.infer_var_config(sd, patch_nums=(1, 2), vq=tiny_vq(False))
    want = jw.infer_var_config(sd, patch_nums=(1, 2), vq=tiny_vq(True))
    assert_config_fields(got, want)
    assert (got.depth, got.d_model, got.n_heads, got.num_classes, got.attn_l2_norm) == (2, 16, 2, 5, True)
    assert pw.convert_var_transformer(sd, got)["blocks"]["scale_mul"].shape == (2, 2)
    # patch_nums alone syncs the VQ pyramid, keeping the canonical token geometry
    assert _raise_msg(pw.infer_var_config, sd, patch_nums=(1, 2)) == \
        _raise_msg(jw.infer_var_config, sd, patch_nums=(1, 2))
    assert "token geometry" in _raise_msg(pw.infer_var_config, sd, patch_nums=(1, 2))
    for p_kw, j_kw, what in ((dict(patch_nums=(1, 2, 3)), dict(patch_nums=(1, 2, 3)), "pos_1LC"),
                             (dict(vq=tiny_vq(False)), dict(vq=tiny_vq(True)), "share one scale schedule")):
        msg = _raise_msg(pw.infer_var_config, sd, **p_kw)
        assert what in msg and msg == _raise_msg(jw.infer_var_config, sd, **j_kw)
    # no QK-l2 scale tensors: the head count falls back to the default, loudly
    plain = {k: v for k, v in sd.items() if "scale_mul" not in k}
    got = pw.infer_var_config(plain, patch_nums=(1, 2), vq=tiny_vq(False))
    assert_config_fields(got, jw.infer_var_config(plain, patch_nums=(1, 2), vq=tiny_vq(True)))
    assert not got.attn_l2_norm and got.n_heads == var.VARConfig.n_heads
    assert capsys.readouterr().out.count("no attn.scale_mul_1H11") == 2


def test_strictness_names_the_same_leftovers():
    torch.manual_seed(3)
    sd = state_dict(TVAR(5, 16, 2, 2, (1, 2), 8, 4))
    sd["blocks.0.attn.extra_weight"] = np.zeros((3, 3), np.float32)
    sd["head.stray"] = np.zeros(2, np.float32)
    msg = _raise_msg(pw.convert_var_transformer, sd, tiny_var(False))
    assert "unconsumed" in msg and "blocks.0.attn.extra_weight" in msg and "head.stray" in msg
    assert msg == _raise_msg(jw.convert_var_transformer, sd, tiny_var(True))
    vsd = dict(vqvae_sd(4), **{"decoder.stray": np.zeros(2, np.float32)})
    msg = _raise_msg(pw.convert_vqvae, vsd, tiny_vq(False))
    assert "decoder.stray" in msg and msg == _raise_msg(jw.convert_vqvae, vsd, tiny_vq(True))


def test_load_var_params_from_pth_files(tmp_path):
    torch.manual_seed(6)
    tm = TVAR(5, 16, 2, 2, (1, 2), 8, 4)
    torch.save(tm.state_dict(), tmp_path / "var_d2.pth")
    torch.save({k: torch.from_numpy(v) for k, v in vqvae_sd(7).items()}, tmp_path / "vae.pth")
    got = pw.load_var_params(tmp_path / "var_d2.pth", tmp_path / "vae.pth", tiny_var(False))
    want = jw.load_var_params(str(tmp_path / "var_d2.pth"), str(tmp_path / "vae.pth"), tiny_var(True))
    assert assert_trees_bitwise(got, want) > 40


CANON = dict(V=4096, Cvae=32, pns=(1, 2, 3, 4, 5, 6, 8, 10, 13, 16))


def write_canonical_var(tmp_path, seed=0):
    """A depth-2, d-16 transformer and a narrow (ch 8) VQ-VAE at the
    released token geometry (vocab 4096, c_vae 32, the 10-scale 256 px
    schedule, 5 decoder levels of 3 blocks with mid and deepest-level
    attention), saved as ``var_d2.pth`` and ``vae.pth``."""
    torch.manual_seed(seed)
    tm = TVAR(5, 16, 2, 2, CANON["pns"], CANON["V"], CANON["Cvae"])
    torch.save(tm.state_dict(), tmp_path / "var_d2.pth")
    sd = vqvae_sd(seed + 1, V=CANON["V"], z=CANON["Cvae"], ch=8, ch_mult=(1, 1, 2, 2, 4), nrb=2, K=4)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vae.pth")
    return tmp_path / "var_d2.pth", tmp_path / "vae.pth"


def test_cli_loads_a_var_checkpoint_pair(tmp_path):
    from hyperscalees_t2i_tpu_torch.train import cli
    from hyperscalees_t2i_tpu_torch.utils import threefry

    ckpt, vae = write_canonical_var(tmp_path)
    base = ["--backend", "var", "--weights", str(ckpt), "--device", "cpu", "--var_classes", "0,1,2,3"]
    with pytest.raises(SystemExit, match="needs --vae_weights"):
        cli.build_backend(cli.build_parser().parse_args(base), torch.device("cpu"))
    backend = cli.build_backend(cli.build_parser().parse_args(base + ["--vae_weights", str(vae)]),
                                torch.device("cpu"))
    model = backend.cfg.model
    assert (model.depth, model.d_model, model.n_heads, model.seq_len, model.vq.vocab_size) == (2, 16, 2, 680, 4096)
    assert backend.cfg.cfg_scale == 4.0 and backend.cfg.top_k == 900 and backend.class_pool == (0, 1, 2, 3)
    backend.setup()
    want = jw.load_var_params(str(ckpt), str(vae), jw.infer_var_config(jload(str(ckpt))))
    emb = backend.model.class_emb
    assert emb.dtype == torch.float32 and np.array_equal(emb.numpy(), np.asarray(want["class_emb"]))
    theta = backend.init_theta(threefry.prng_key(0, "cpu"))
    with torch.inference_mode():
        img = backend.generate(theta, [0], threefry.prng_key(1, "cpu"))
    assert tuple(img.shape) == (1, 256, 256, 3) and bool(torch.isfinite(img).all())
