"""LoRA adapters as flat dicts of factors, applied inside the forward pass.

Port of the serving half of ``hyperscalees_t2i_tpu/lora.py``. An adapter is
``{path: {"a": A, "b": B}}`` keyed by the kernel's parameter path (without
the trailing ``/kernel``): ``a [.., din, r]``, ``b [.., r, dout]``, stacked
``[L, ..]`` for scan-stacked layers. Every adapted dense computes
``y = x @ W + (alpha/r)·(x @ A) @ B`` and never forms ``W + ΔW``.

:func:`init_lora` builds the same tree structure, from the same target
regexes over the same paths, as the JAX package, so adapters move between
the two packages leaf by leaf (``weights/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .utils.pytree import tree_leaves_with_path

Adapter = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """Static adapter spec: rank, alpha and target path regexes."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ()

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def match_targets(path: str, targets: Sequence[str]) -> bool:
    return any(re.search(t, path) for t in targets)


def iter_kernel_paths(params: Any) -> List[Tuple[str, torch.Tensor]]:
    """All ``(path, leaf)`` pairs of tensors with ``ndim >= 2``, in the JAX
    package's flattening order (dict keys sorted)."""
    return [(p, leaf) for p, leaf in tree_leaves_with_path(params)
            if torch.is_tensor(leaf) and leaf.ndim >= 2]


def init_lora(params: Any, spec: LoRASpec, generator: torch.Generator,
              device: Optional[torch.device] = None) -> Adapter:
    """The adapter tree for every targeted kernel (float ``kernel`` or int8
    ``kernel_q8/q8``): ``a ~ N(0, 1/fan_in)``, ``b = 0`` (identity at init,
    as PEFT). Draws come from ``generator`` in path order."""
    kernels = [(p, leaf) for p, leaf in iter_kernel_paths(params)
               if p.endswith("kernel") or p.endswith("kernel_q8/q8")]
    tree: Adapter = {}
    for path, leaf in kernels:
        name = re.sub(r"/?(kernel|kernel_q8/q8)$", "", path)
        if not match_targets(name, spec.targets):
            continue
        dev = device if device is not None else leaf.device
        shape = tuple(leaf.shape)
        if leaf.ndim == 2:
            din, dout = shape
            a_shape, b_shape, fan = (din, spec.rank), (spec.rank, dout), din
        elif leaf.ndim == 3:
            L, din, dout = shape
            a_shape, b_shape, fan = (L, din, spec.rank), (L, spec.rank, dout), din
        elif leaf.ndim == 4:
            kh, kw, cin, cout = shape
            a_shape, b_shape, fan = (kh, kw, cin, spec.rank), (spec.rank, cout), kh * kw * cin
        else:
            continue
        a = torch.randn(a_shape, generator=generator, device=generator.device) / math.sqrt(fan)
        tree[name] = {"a": a.to(dev), "b": torch.zeros(b_shape, device=dev)}
    return tree


def lookup(lora: Optional[Dict[str, Any]], path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The adapter leaf for a kernel path, or ``None``."""
    if lora is None:
        return None
    return lora.get(path)


def slice_layer(leaf: Optional[Dict[str, torch.Tensor]], i: int) -> Optional[Dict[str, torch.Tensor]]:
    """Layer ``i`` of stacked ``[.., L, m, n]`` factors. The layer axis is the
    third from last, so a lane-stacked ``[A, L, m, n]`` leaf gives ``[A, m, n]``."""
    if leaf is None:
        return None
    return {"a": leaf["a"].select(-3, i), "b": leaf["b"].select(-3, i)}


def lora_delta(x: torch.Tensor, leaf: Optional[Dict[str, torch.Tensor]], scale: float) -> Optional[torch.Tensor]:
    """``scale·(x@A)@B`` for 2D factors ``A [din, r]``, ``B [r, dout]``;
    ``None`` when the layer is unadapted.

    Lane-stacked factors ``A [n, din, r]``, ``B [n, r, dout]`` apply lane
    ``i``'s adapter to the ``i``-th of ``n`` equal row groups of ``x``
    (``x``'s leading axis is lane-major), so several adapters share one base
    matmul."""
    if leaf is None:
        return None
    a = leaf["a"].to(x.dtype)
    b = leaf["b"].to(x.dtype)
    if a.ndim == 2:
        return ((x @ a) @ b) * scale
    n = a.shape[0]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} adapter lanes")
    d = torch.bmm(torch.bmm(x.reshape(n, -1, x.shape[-1]), a), b) * scale
    return d.reshape(*x.shape[:-1], b.shape[-1])


def stack_adapters(trees: Sequence[Adapter]) -> Adapter:
    """N same-structure adapters → one adapter whose every leaf has a leading
    ``[N]`` axis (the serving batch). A structure or shape mismatch raises
    naming the adapter."""
    if not trees:
        raise ValueError("stack_adapters needs at least one adapter tree")
    ref = trees[0]
    for i, tree in enumerate(trees[1:], start=1):
        if tree.keys() != ref.keys() or any(tree[k].keys() != ref[k].keys() for k in ref):
            raise ValueError(
                f"adapter {i} has a different tree structure than adapter 0 "
                "(was it trained against a different target list / rank?)"
            )
        for k in ref:
            for f in ref[k]:
                t, r = tree[k][f], ref[k][f]
                if t.shape != r.shape or t.dtype != r.dtype:
                    raise ValueError(
                        f"adapter {i} leaf {k}/{f}: shape/dtype {tuple(t.shape)}/{t.dtype} "
                        f"!= adapter 0's {tuple(r.shape)}/{r.dtype}"
                    )
    return {k: {f: torch.stack([t[k][f] for t in trees]) for f in ref[k]} for k in ref}
