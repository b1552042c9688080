"""Checkpoint ingestion and weight conversion into the port's modules.

- :mod:`io`: raw state dicts (torch pickles, safetensors files and shard
  directories, read without the ``safetensors`` package);
- :mod:`sana`: diffusers ``SanaTransformer2DModel`` → the ``models/sana`` tree;
- :mod:`var`: ``var_d*.pth`` + ``vae_ch160v4096z32.pth`` → the ``models/var`` tree;
- :mod:`infinity`: an Infinity transformer and its BSQ tokenizer → the
  ``models/infinity`` tree;
- :mod:`validate`: one-command validation of a converted checkpoint;
- :mod:`from_jax`: the JAX package's trees carried across leaf by leaf.

The converters give the JAX package's trees (f32 numpy leaves), bitwise
the JAX converters' on the same state dict (``tests/test_torch_weights_*.py``).
Z-Image's converters are ROADMAP queue A item 9.
"""

from .infinity import (convert_bsq_vae, convert_infinity_transformer, infer_infinity_config, load_bsq_vae,
                       load_infinity_params)
from .io import load_state_dict, save_safetensors, strip_prefix
from .sana import convert_sana_transformer, infer_sana_config, load_sana_params
from .var import convert_var_transformer, convert_vqvae, infer_var_config, load_var_params

__all__ = [
    "load_state_dict",
    "strip_prefix",
    "convert_sana_transformer",
    "infer_sana_config",
    "load_sana_params",
    "convert_var_transformer",
    "convert_vqvae",
    "infer_var_config",
    "load_var_params",
    "convert_infinity_transformer",
    "infer_infinity_config",
    "load_infinity_params",
]
