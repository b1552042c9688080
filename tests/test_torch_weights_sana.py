"""The port's Sana converter (``hyperscalees_t2i_tpu_torch.weights.sana``)
against the JAX package's, on the diffusers-layout state dicts of
``TSana`` (``tests/test_weights_sana.py``).

- Trees bitwise equal to the JAX converter's, in the Sprint (guidance)
  layout and in the ``AdaLayerNormSingle`` one (``time_embed.emb.*``).
- ``infer_sana_config`` field by field; strictness with the same leftover
  names.
- With the converted weights, the port's forward within 1e-4 of the JAX
  one (measured 3.3e-7) and within the JAX test's 5e-4 of ``TSana``
  (measured 3.6e-7).
- ``load_sana_params`` on a ``model.``-prefixed f32 safetensors file and on
  a bf16 one (the reference reads bf16 as ``ml_dtypes`` arrays, the port
  upcasts; the converted trees are the same).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperscalees_t2i_tpu.models import sana as jsana
from hyperscalees_t2i_tpu.weights import sana as jw
from hyperscalees_t2i_tpu_torch.models import sana
from hyperscalees_t2i_tpu_torch.weights import sana as pw
from hyperscalees_t2i_tpu_torch.weights.from_jax import sana_from_jax
from hyperscalees_t2i_tpu_torch.weights.io import save_safetensors

from test_torch_weights_var import _raise_msg, assert_config_fields, assert_trees_bitwise, state_dict
from test_weights_sana import CAP, CIN, TSana, _tiny_cfg

torch.set_num_threads(1)
PRIM_TOL = 1e-4


def port_cfg():
    j = _tiny_cfg()
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "compute_dtype"}
    return sana.SanaConfig(**kw, compute_dtype=torch.float32)


def test_sana_tree_bitwise_and_forward():
    torch.manual_seed(0)
    tm = TSana().eval()
    sd = state_dict(tm)
    tree, ref = pw.convert_sana_transformer(sd, port_cfg()), jw.convert_sana_transformer(sd, _tiny_cfg())
    assert assert_trees_bitwise(tree, ref) == 42
    g = torch.Generator().manual_seed(1)
    lat, cap = torch.randn(2, CIN, 4, 4, generator=g), torch.randn(2, 6, CAP, generator=g)
    t, gd = torch.tensor([0.4, 0.7]), torch.tensor([0.45, 0.45])
    with torch.no_grad():
        want = tm(lat, t, cap, gd).permute(0, 2, 3, 1).numpy()
        got = sana_from_jax(tree, port_cfg(), "cpu")(lat.permute(0, 2, 3, 1), t, cap, None, gd).numpy()
    jgot = np.asarray(jsana.sana_forward(ref, _tiny_cfg(), jnp.asarray(lat.permute(0, 2, 3, 1).numpy()),
                                         jnp.asarray(t.numpy()), jnp.asarray(cap.numpy()), None,
                                         jnp.asarray(gd.numpy())))
    assert float(np.abs(got - jgot).max()) <= PRIM_TOL
    assert float(np.abs(got - want).max()) <= 5e-4


def test_ada_layer_norm_single_layout_converts_as_jax():
    torch.manual_seed(4)
    sd = {k.replace("time_embed.timestep_embedder", "time_embed.emb.timestep_embedder")
          .replace("time_embed.guidance_embedder", "time_embed.emb.guidance_embedder"): v
          for k, v in state_dict(TSana()).items()}
    assert any(k.startswith("time_embed.emb.") for k in sd)
    assert_trees_bitwise(pw.convert_sana_transformer(sd, port_cfg()), jw.convert_sana_transformer(sd, _tiny_cfg()))
    assert_config_fields(pw.infer_sana_config(sd), jw.infer_sana_config(sd))


def test_infer_sana_config_matches_jax_field_by_field():
    torch.manual_seed(1)
    sd = state_dict(TSana())
    got = pw.infer_sana_config(sd, compute_dtype=torch.float32)
    assert_config_fields(got, jw.infer_sana_config(sd, compute_dtype=jnp.float32))
    assert (got.n_layers, got.d_model, got.caption_dim, got.in_channels, got.patch_size) == (2, 16, CAP, CIN, 1)
    assert got.guidance_embeds
    no_guidance = {k: v for k, v in sd.items() if "guidance_embedder" not in k}
    assert not pw.infer_sana_config(no_guidance).guidance_embeds
    assert_config_fields(pw.infer_sana_config(no_guidance), jw.infer_sana_config(no_guidance))


def test_strictness_names_the_same_leftovers():
    torch.manual_seed(2)
    sd = state_dict(TSana())
    sd["transformer_blocks.0.attn1.stray"] = np.zeros((2, 2), np.float32)
    msg = _raise_msg(pw.convert_sana_transformer, sd, port_cfg())
    assert "unconsumed" in msg and "transformer_blocks.0.attn1.stray" in msg
    assert msg == _raise_msg(jw.convert_sana_transformer, sd, _tiny_cfg())


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_load_sana_params_from_safetensors(tmp_path, dtype):
    torch.manual_seed(3)
    sd = state_dict(TSana())
    path = tmp_path / f"transformer_{dtype}.safetensors"
    save_safetensors(path, {f"model.{k}": (dtype, v.shape, lambda v=v: v) for k, v in sd.items()})
    got, want = pw.load_sana_params(path, port_cfg()), jw.load_sana_params(str(path), _tiny_cfg())
    assert_trees_bitwise(got, want)
    if dtype == "BF16":  # the values are the bf16 roundings of the state dict's
        w = sd["proj_out.weight"]
        assert not np.array_equal(got["proj_out"]["kernel"], w.T)
        assert np.array_equal(got["proj_out"]["kernel"],
                              torch.from_numpy(w.T.copy()).to(torch.bfloat16).float().numpy())
