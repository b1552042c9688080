"""``chip_smoke.py``'s released-layout checkpoint writers, held at tiny
geometry: the key inventories it writes for ``var_d*.pth``,
``vae_ch160v4096z32.pth`` and the diffusers ``SanaTransformer2DModel`` are
accepted by the JAX and the port converters alike, with bitwise-equal trees
whose structure and shapes are the port's ``init_*`` trees, and the
geometry inferred back from them is the config they were written for. The
card phases run the same writers at full width, where only the card would
see a wrong key."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import msvq as jmsvq
from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.models import var as jvar
from hyperscalees_t2i_tpu.weights import sana as jws
from hyperscalees_t2i_tpu.weights import var as jwv
from hyperscalees_t2i_tpu.weights.io import load_state_dict as jload
from hyperscalees_t2i_tpu_torch.models import msvq, sana, var
from hyperscalees_t2i_tpu_torch.utils import threefry
from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map
from hyperscalees_t2i_tpu_torch.weights import sana as pws
from hyperscalees_t2i_tpu_torch.weights import var as pwv
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
