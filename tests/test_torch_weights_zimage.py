"""Z-Image's checkpoints in the port, against the JAX package, bitwise.

- ``convert_zimage_transformer`` and ``convert_kl_decoder`` on random state
  dicts with the released key names (the reference-layout torch modules of
  ``tests/test_weights_zimage.py``: ``x_embedder``, ``cap_embedder.{0,1}``,
  ``layers.{i}.attention.to_{q,k,v}/norm_{q,k}/to_out.0``, the SwiGLU
  ``w1/w2/w3``, ``adaLN_modulation.1``; the diffusers ``AutoencoderKL``
  decoder with ``post_quant_conv`` and encoder tensors to ignore): the same
  trees, leaf for leaf; ``infer_*_config`` the same configurations; an
  unread tensor raises in both.
- The GGUF reader on F32/F16/Q8_0 files that the JAX ``write_gguf`` wrote:
  metadata, every tensor's bytes, its f32 dequantization and
  ``q8_kernel_node`` bitwise the JAX reader's; the port's ``write_gguf``
  writes the same bytes; ``weights.io.load_state_dict`` routes ``.gguf``.
- The ``zimage`` prompt cache (``.npz`` and the reference's ragged ``.pt``,
  with ``max_len``), the dual-adapter PEFT export (conv factors in PEFT's
  Conv2d layout) and ``validate --family zimage`` (f32 in both packages,
  the stats within ``DEFAULT_ATOL``: measured 1e-6, the stats' 6-digit
  rounding).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.utils import prompt_cache as jpc
from hyperscalees_t2i_tpu.weights import gguf as jgguf
from hyperscalees_t2i_tpu.weights import io as jio
from hyperscalees_t2i_tpu.weights import validate as jvalidate
from hyperscalees_t2i_tpu.weights import zimage as jzw
from hyperscalees_t2i_tpu_torch.utils import prompt_cache as pc
from hyperscalees_t2i_tpu_torch.weights import gguf, io as pio, validate
from hyperscalees_t2i_tpu_torch.weights import zimage as pzw

import test_weights_zimage as twz
from test_torch_weights_var import assert_trees_bitwise

torch.set_num_threads(1)


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def state_dicts():
    torch.manual_seed(11)
    return _sd(twz.TZImage()), _sd(twz.TKLDecoder())


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items() if k != "compute_dtype"}


def test_converters_match_jax_bitwise(state_dicts):
    sd, vsd = state_dicts
    jcfg, pcfg = jzw.infer_zimage_config(sd), pzw.infer_zimage_config(sd)
    assert _fields(jcfg) == _fields(pcfg) and pcfg.head_dim == twz.DH
    assert_trees_bitwise(pzw.convert_zimage_transformer(sd, pcfg), jzw.convert_zimage_transformer(sd, jcfg))
    vsd = dict(vsd, **{"encoder.conv_in.weight": np.zeros((8, 3, 3, 3), np.float32),
                       "quant_conv.weight": np.zeros((4, 4, 1, 1), np.float32)})
    jv, pv = jzw.infer_kl_decoder_config(vsd), pzw.infer_kl_decoder_config(vsd)
    assert _fields(jv) == _fields(pv) and pv.ch == (twz.VC, twz.VC) and pv.blocks_per_stage == twz.VBLOCKS
    tree = pzw.convert_kl_decoder(vsd, pv)
    assert "post_quant" in tree
    assert_trees_bitwise(tree, jzw.convert_kl_decoder(vsd, jv))
    # overrides pass through both
    assert _fields(pzw.infer_zimage_config(sd, patch_size=2, num_steps=4)) == \
        _fields(jzw.infer_zimage_config(sd, patch_size=2, num_steps=4))


def test_converters_refuse_unread_tensors(state_dicts):
    sd, vsd = state_dicts
    extra = dict(sd, **{"layers.0.attention.stray.weight": np.zeros(3, np.float32)})
    for mod in (jzw, pzw):
        with pytest.raises(ValueError, match="unconsumed"):
            mod.convert_zimage_transformer(extra, mod.infer_zimage_config(sd))
    extra = dict(vsd, **{"decoder.stray.weight": np.zeros(3, np.float32)})
    for mod in (jzw, pzw):
        with pytest.raises(ValueError, match="unconsumed"):
            mod.convert_kl_decoder(extra, mod.infer_kl_decoder_config(vsd))


def _gguf_tensors():
    rng = np.random.RandomState(5)
    return ({"a.weight": rng.randn(8, 64).astype(np.float32), "a.bias": rng.randn(8).astype(np.float32),
             "b.weight": rng.randn(4, 32).astype(np.float32), "c.weight": (rng.randn(6, 96) * 3).astype(np.float32),
             "z.weight": np.zeros((2, 32), np.float32)},
            {"a.weight": "q8_0", "b.weight": "f16", "c.weight": "q8_0", "z.weight": "q8_0"})


def test_gguf_reader_matches_jax_bitwise(tmp_path):
    tensors, types = _gguf_tensors()
    meta = {"general.name": "tiny", "n": 3, "f": 0.5, "ok": True, "neg": -4}
    path = tmp_path / "jax.gguf"
    jgguf.write_gguf(path, tensors, meta, types)
    jmeta, jt = jgguf.read_gguf(path)
    pmeta, pt = gguf.read_gguf(path)
    assert pmeta == jmeta and list(pt) == list(jt)
    for name in jt:
        assert (pt[name].ne, pt[name].ggml_type, pt[name].data) == (jt[name].ne, jt[name].ggml_type, jt[name].data)
        np.testing.assert_array_equal(pt[name].to_f32(), jt[name].to_f32())
    jsd, psd = jgguf.load_gguf_state_dict(path), gguf.load_gguf_state_dict(path)
    assert list(psd) == list(jsd) and all(psd[k].dtype == np.float32 for k in psd)
    for k in jsd:
        np.testing.assert_array_equal(psd[k], jsd[k])
    for name in ("a.weight", "c.weight", "z.weight"):
        jn, pn = jgguf.q8_kernel_node(jt[name]), gguf.q8_kernel_node(pt[name])
        for f in ("q8", "scale"):
            assert pn[f].dtype == jn[f].dtype
            np.testing.assert_array_equal(pn[f], jn[f])
    with pytest.raises(ValueError, match="not Q8_0"):
        gguf.q8_kernel_node(pt["b.weight"])
    # the port's writer writes the reference's bytes; the io layer routes .gguf
    gguf.write_gguf(tmp_path / "port.gguf", tensors, meta, types)
    assert (tmp_path / "port.gguf").read_bytes() == path.read_bytes()
    routed = pio.load_state_dict(path)
    for k in jsd:
        np.testing.assert_array_equal(routed[k], np.asarray(jio.load_state_dict(path)[k]))
    np.testing.assert_array_equal(gguf.quantize_q8_0(tensors["c.weight"]) == jgguf.quantize_q8_0(tensors["c.weight"]),
                                  True)


def test_gguf_reader_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="bad magic"):
        gguf.read_gguf(bad)
    bad.write_bytes(b"GGUF" + (9).to_bytes(4, "little") + bytes(16))
    with pytest.raises(ValueError, match="version 9 unsupported"):
        gguf.read_gguf(bad)
    bad.write_bytes(b"GGUF")
    with pytest.raises(ValueError, match="truncated"):
        pio.load_state_dict(bad)


def test_zimage_checkpoint_from_gguf_converts_as_in_jax(tmp_path, state_dicts):
    sd, _ = state_dicts
    path = tmp_path / "z.gguf"
    types = {k: "q8_0" for k, v in sd.items() if v.ndim == 2 and v.shape[-1] % 32 == 0}
    assert types
    jgguf.write_gguf(path, sd, tensor_types=types)
    psd, jsd = pio.load_state_dict(path), jio.load_state_dict(path)
    assert_trees_bitwise(pzw.convert_zimage_transformer(psd, pzw.infer_zimage_config(psd)),
                         jzw.convert_zimage_transformer(jsd, jzw.infer_zimage_config(jsd)))


@pytest.mark.parametrize("max_len", [0, 3])
def test_zimage_prompt_cache_matches_jax(tmp_path, max_len):
    rng = np.random.default_rng(2)
    prompts = ["a red square", "a blue circle"]
    embeds = [rng.standard_normal((5, 6)).astype(np.float32), rng.standard_normal((2, 6)).astype(np.float32)]
    pt = tmp_path / "ref.pt"
    torch.save({"prompts": prompts, "prompt_embeds": [torch.from_numpy(e) for e in embeds]}, pt)
    got, want = pc.load_cache(str(pt), "zimage", max_len), jpc.load_cache(str(pt), "zimage", max_len)
    assert got["prompts"] == want["prompts"] == prompts and got["content_sha256"] == want["content_sha256"]
    for k in ("prompt_embeds", "prompt_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["prompt_embeds"].shape == (2, max_len or 5, 6)
    npz = tmp_path / "cache.npz"
    pc.save_zimage_cache(str(npz), prompts, got["prompt_embeds"], got["prompt_mask"])
    jgot = jpc.load_zimage_cache(str(npz))
    for k in ("prompt_embeds", "prompt_mask"):
        np.testing.assert_array_equal(pc.load_zimage_cache(str(npz))[k], jgot[k])
    assert list(jgot["prompts"]) == prompts


def test_dual_adapter_peft_export_matches_jax(tmp_path):
    import jax

    from hyperscalees_t2i_tpu.train.checkpoints import export_peft_adapter as jexport
    from hyperscalees_t2i_tpu_torch.train.checkpoints import export_peft_adapter
    from hyperscalees_t2i_tpu_torch.weights.from_jax import tree_from_numpy

    from test_torch_zimage import _jax_backend

    jb = _jax_backend(tmp_path)
    theta = jax.tree_util.tree_map(lambda x: x + 0.5, jb.init_theta(jax.random.PRNGKey(0)))
    name = lambda p, i: p.replace("/", ".") + ("" if i is None else f".{i}")  # noqa: E731
    jexport(tmp_path / "jax", theta, rank=2, alpha=4.0, module_name_fn=name)
    export_peft_adapter(tmp_path / "port", tree_from_numpy(jax.tree_util.tree_map(np.asarray, theta), "cpu"), rank=2,
                        alpha=4.0, module_name_fn=name)
    for sub in ("transformer", "vae_decoder"):
        jdir, pdir = tmp_path / "jax" / sub, tmp_path / "port" / sub
        assert json.loads((pdir / "adapter_config.json").read_text()) == \
            json.loads((jdir / "adapter_config.json").read_text())
        f = jdir / "adapter_model.safetensors"
        want = pio.load_state_dict(f if f.exists() else jdir / "adapter_model.bin")
        got = pio.load_state_dict(pdir / "adapter_model.safetensors")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = pio.load_state_dict(tmp_path / "port" / "vae_decoder" / "adapter_model.safetensors")
    conv_a = [v for k, v in got.items() if "conv1" in k and "lora_A" in k][0]
    conv_b = [v for k, v in got.items() if "conv1" in k and "lora_B" in k][0]
    r = jb.cfg.vae_lora_r
    assert conv_a.shape[0] == r and conv_a.shape[2:] == (3, 3) and conv_b.shape[1:] == (r, 1, 1)


def _f32_geometry(monkeypatch):
    """Both packages' Z-Image transformer and decoder in f32."""
    import dataclasses

    for mod, dt in ((jzw, jnp.float32), (pzw, torch.float32)):
        for fn in ("infer_zimage_config", "infer_kl_decoder_config"):
            real = getattr(mod, fn)
            monkeypatch.setattr(mod, fn, lambda sd, real=real, dt=dt, **kw: dataclasses.replace(real(sd, **kw),
                                                                                             compute_dtype=dt))


def test_validate_zimage_family_matches_jax(tmp_path, monkeypatch, capsys, state_dicts):
    sd, vsd = state_dicts
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "zimage.pt")
    torch.save({k: torch.from_numpy(v) for k, v in vsd.items()}, tmp_path / "vae.pt")
    (tmp_path / "p.txt").write_text("a red square\na blue circle\n")
    argv = ["--family", "zimage", "--weights", str(tmp_path / "zimage.pt"), "--vae_weights", str(tmp_path / "vae.pt"),
            "--prompts_txt", str(tmp_path / "p.txt"), "--images", "2"]
    _f32_geometry(monkeypatch)
    expected = tmp_path / "expected.json"
    assert jvalidate.main(argv + ["--write_expected", str(expected)]) == 0
    want = json.loads(expected.read_text())
    capsys.readouterr()
    assert validate.main(argv + ["--device", "cpu", "--expect", str(expected)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["family"] == "zimage" and got["shape"] == want["shape"] == [32, 32, 3]
    worst = max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))))
                for k in ("mean", "std", "min", "max", "grid8"))
    print(f"largest stat difference: {worst:.3g}")
    assert worst <= validate.DEFAULT_ATOL
