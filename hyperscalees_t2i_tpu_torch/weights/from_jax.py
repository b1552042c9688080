"""Carry the JAX package's parameter trees across to the port.

The input is a JAX parameter tree already converted leaf by leaf to numpy
(``jax.tree_util.tree_map(np.asarray, params)``): nested dicts and lists,
stacked ``[L, ...]`` leaves, ``kernel_q8`` dicts, HWIO conv kernels, and the
flat LoRA dict ``{path: {"a", "b"}}``. The port keeps the same layout, so
the conversion is leaf by leaf; the module constructors then slice the
stacked layers and turn the kernels of the convs that run through
``F.conv2d`` from HWIO into OIHW. This module imports neither ``jax`` nor
the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import dcae, sana
from ..utils.pytree import tree_map


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    """One numpy leaf → tensor on ``device`` (ml_dtypes bfloat16 included)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device)


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A numpy tree → the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def sana_from_jax(tree: Any, cfg: sana.SanaConfig, device: DeviceLike = None) -> sana.SanaTransformer:
    return sana.SanaTransformer(cfg, tree_from_numpy(tree, device))


def dcae_from_jax(tree: Any, cfg: dcae.DCAEConfig, device: DeviceLike = None) -> dcae.DCAEDecoder:
    return dcae.DCAEDecoder(cfg, tree_from_numpy(tree, device))


def adapter_from_jax(lora: Dict[str, Dict[str, Any]], device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The flat LoRA dict (stacked along a leading adapter axis or not)."""
    return tree_from_numpy(lora, device)
