"""The port's PEFT adapter export (``train.checkpoints.export_peft_adapter``)
against the JAX package's on the CPU: dense 2-D and stacked 3-D factors,
conv 4-D factors and a nested multi-adapter θ, from the same numpy values.
The state dicts' keys, shapes and values are bitwise equal (each file read
by the ``safetensors`` package and by the port's own reader) and
``adapter_config.json`` is equal. The port writes through
``weights.io.save_safetensors``, with no ``safetensors`` package."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from hyperscalees_t2i_tpu.train.checkpoints import export_peft_adapter as jexport
from hyperscalees_t2i_tpu_torch.train.checkpoints import export_peft_adapter
from hyperscalees_t2i_tpu_torch.weights.io import load_state_dict

torch.set_num_threads(1)


def _name(path, layer):
    return path.replace("/", ".") + ("" if layer is None else f".{layer}")


def _tree(seed, spec):
    rng = np.random.default_rng(seed)
    return {k: {f: rng.standard_normal(s).astype(np.float32) for f, s in fs.items()} for k, fs in spec.items()}


DENSE = {"blocks/attn1/to_q": {"a": (24, 4), "b": (4, 16)}, "caption_proj": {"a": (12, 4), "b": (4, 24)}}
STACKED = {"blocks/attn1/to_k": {"a": (3, 24, 4), "b": (3, 4, 24)}, "blocks/ff/up": {"a": (3, 24, 4), "b": (3, 4, 48)}}
CONV = {"decoder/conv_in": {"a": (3, 3, 8, 4), "b": (4, 16)}, "decoder/proj": {"a": (1, 1, 16, 4), "b": (4, 8)}}


@pytest.mark.parametrize("spec", [
    DENSE, STACKED, CONV,
    {"transformer": {**DENSE, **STACKED}, "vae_decoder": CONV},
], ids=["dense", "stacked", "conv", "nested"])
def test_export_matches_jax(tmp_path, spec):
    nested = all("a" not in v for v in spec.values())
    theta = ({sub: _tree(i, s) for i, (sub, s) in enumerate(spec.items())} if nested else _tree(0, spec))

    def convert(tree, f):
        return {k: ({n: f(a) for n, a in v.items()} if "a" in v else convert(v, f)) for k, v in tree.items()}

    export_peft_adapter(tmp_path / "ours", convert(theta, torch.from_numpy), rank=4, alpha=8.0, module_name_fn=_name)
    jexport(tmp_path / "ref", convert(theta, jnp.asarray), rank=4, alpha=8.0, module_name_fn=_name)
    dirs = [(tmp_path / "ours" / sub, tmp_path / "ref" / sub) for sub in spec] if nested else \
        [(tmp_path / "ours", tmp_path / "ref")]
    for ours, ref in dirs:
        assert not (ours / "adapter_model.bin").exists()
        a = load_file(str(ours / "adapter_model.safetensors"))
        b = load_file(str(ref / "adapter_model.safetensors"))
        own = load_state_dict(ours / "adapter_model.safetensors")
        assert a.keys() == b.keys() == own.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(own[k], b[k], err_msg=k)
        assert json.loads((ours / "adapter_config.json").read_text()) == \
            json.loads((ref / "adapter_config.json").read_text())


def test_factors_land_transposed(tmp_path):
    """``lora_A = aᵀ`` and ``lora_B = bᵀ`` per layer; conv ``[r, cin, kh, kw]``
    and ``[cout, r, 1, 1]``."""
    theta = {**_tree(3, STACKED), **_tree(4, CONV)}
    export_peft_adapter(tmp_path, {k: {f: torch.from_numpy(a) for f, a in v.items()} for k, v in theta.items()},
                        rank=4, alpha=8.0, module_name_fn=_name)
    sd = load_state_dict(tmp_path / "adapter_model.safetensors")
    a, b = theta["blocks/attn1/to_k"]["a"], theta["blocks/attn1/to_k"]["b"]
    for i in range(3):
        np.testing.assert_array_equal(sd[f"base_model.model.blocks.attn1.to_k.{i}.lora_A.weight"], a[i].T)
        np.testing.assert_array_equal(sd[f"base_model.model.blocks.attn1.to_k.{i}.lora_B.weight"], b[i].T)
    c = theta["decoder/conv_in"]
    np.testing.assert_array_equal(sd["base_model.model.decoder.conv_in.lora_A.weight"], c["a"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["base_model.model.decoder.conv_in.lora_B.weight"], c["b"].T[:, :, None, None])
