"""Carry the JAX package's parameter trees across to the port.

The input is a JAX parameter tree already converted leaf by leaf to numpy
(``jax.tree_util.tree_map(np.asarray, params)``): nested dicts and lists,
stacked ``[L, ...]`` leaves, ``kernel_q8`` dicts, HWIO conv kernels, the
flat LoRA dict ``{path: {"a", "b"}}``, ES noise trees and factored adapter
leaves. The port keeps the same layout, so the conversion is leaf by leaf;
the module constructors then slice the stacked layers and turn the kernels
of the convs that run through ``F.conv2d`` from HWIO into OIHW. This module
imports neither ``jax`` nor the JAX package: the JAX package's named-tuple
nodes (``LowRankNoise``, ``DenseNoise``, ``FactoredDelta``) are recognized
by their field names and become the port's classes of the same name;
``None`` leaves (the VQ decoder's ``"attn_1"`` without mid attention) and
lists are carried across unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..es.noiser import DenseNoise, LowRankNoise
from ..lora import FactoredDelta
from ..models import bsq, clip, dcae, infinity, msvq, sana, var

_NODE_TYPES = {cls._fields: cls for cls in (LowRankNoise, DenseNoise, FactoredDelta)}


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    """One numpy leaf → tensor on ``device`` (ml_dtypes bfloat16 included)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, order="C").view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return t.to(device)


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A numpy tree → the same tree of tensors on ``device``; the JAX
    package's ``LowRankNoise``/``DenseNoise``/``FactoredDelta`` nodes become
    the port's; ``None`` stays ``None``."""
    dev = resolve_device(device)

    def walk(t: Any) -> Any:
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return _NODE_TYPES[tuple(t._fields)](*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return tensor_from_numpy(t, dev)

    return walk(tree)


def sana_from_jax(tree: Any, cfg: sana.SanaConfig, device: DeviceLike = None) -> sana.SanaTransformer:
    return sana.SanaTransformer(cfg, tree_from_numpy(tree, device))


def dcae_from_jax(tree: Any, cfg: dcae.DCAEConfig, device: DeviceLike = None) -> dcae.DCAEDecoder:
    return dcae.DCAEDecoder(cfg, tree_from_numpy(tree, device))


def clip_from_jax(tree: Any, cfg: clip.CLIPConfig, device: DeviceLike = None) -> clip.CLIPModel:
    return clip.CLIPModel(cfg, tree_from_numpy(tree, device))


def var_from_jax(tree: Any, cfg: var.VARConfig, device: DeviceLike = None) -> var.VARTransformer:
    """The VAR tree (its ``"vq"`` subtree included) as the port's module."""
    return var.VARTransformer(cfg, tree_from_numpy(tree, device))


def msvq_from_jax(tree: Any, cfg: msvq.MSVQConfig, device: DeviceLike = None) -> msvq.MSVQ:
    return msvq.MSVQ(cfg, tree_from_numpy(tree, device))


def infinity_from_jax(tree: Any, cfg: infinity.InfinityConfig, device: DeviceLike = None) -> infinity.InfinityTransformer:
    """The Infinity tree (its ``"vq"`` subtree included) as the port's
    module. The backend's frozen text features are plain arrays: pass them
    through :func:`tree_from_numpy` to ``InfinityBackend(text=...)``."""
    return infinity.InfinityTransformer(cfg, tree_from_numpy(tree, device))


def bsq_from_jax(tree: Any, cfg: bsq.BSQConfig, device: DeviceLike = None) -> bsq.BSQ:
    return bsq.BSQ(cfg, tree_from_numpy(tree, device))


def adapter_from_jax(lora: Dict[str, Dict[str, Any]], device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The flat LoRA dict (stacked along a leading adapter axis or not)."""
    return tree_from_numpy(lora, device)
