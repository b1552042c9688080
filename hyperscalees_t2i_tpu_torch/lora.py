"""LoRA adapters as flat dicts of factors, applied inside the forward pass.

Port of ``hyperscalees_t2i_tpu/lora.py``. An adapter is
``{path: {"a": A, "b": B}}`` keyed by the kernel's parameter path (without
the trailing ``/kernel``): ``a [.., din, r]``, ``b [.., r, dout]``, stacked
``[L, ..]`` for scan-stacked layers. Every adapted dense computes
``y = x @ W + (alpha/r)·(x @ A) @ B`` and never forms ``W + ΔW``. Under
ES training a factor may arrive as a :class:`FactoredDelta`, the member's
perturbation kept factored (``models/nn.py`` routes those to the kernels).

:func:`init_lora` builds the same tree structure, from the same target
regexes over the same paths, as the JAX package, so adapters move between
the two packages leaf by leaf (``weights/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .utils import threefry
from .utils.pytree import tree_leaves, tree_leaves_with_path, tree_replace_leaves

Adapter = Dict[str, Dict[str, torch.Tensor]]


class FactoredDelta(NamedTuple):
    """A LoRA factor carrying its ES perturbation in factored form:
    ``w_k = w + c · u @ vᵀ`` without a materialized ``w_k``.

    ``w [.., m, n]`` is the unperturbed factor (θ, shared by every member),
    ``u [.., m, r_e]`` and ``v [.., n, r_e]`` are the member's slices of the
    EGGROLL noise factors (in the noise store's dtype), ``c`` the member's
    f32 coefficient ``σ·s_k/√r_e``. Several members evaluated together carry
    a leading lane axis on ``u``, ``v`` and ``c`` (``c [lanes]``); their rows
    of ``x`` are grouped lane-major, as in :func:`lora_delta`."""

    w: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    c: torch.Tensor


def effective_factor(f: Any, dtype: torch.dtype) -> torch.Tensor:
    """``w + c·u@vᵀ`` in f32 (the noise upcast before the product), cast to
    ``dtype``; ``[lanes, m, n]`` for a laned factor. Raw factors are cast."""
    if not isinstance(f, FactoredDelta):
        return f.to(dtype)
    d = f.u.to(torch.float32) @ f.v.to(torch.float32).transpose(-1, -2)
    c = f.c.to(torch.float32)
    if c.ndim:
        c = c.reshape(-1, *([1] * (d.ndim - 1)))
    return (f.w.to(torch.float32) + c * d).to(dtype)


def lane_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2D ``w``, or lane ``i``'s ``w[i]`` applied to the
    ``i``-th of ``lanes`` equal row groups of ``x`` for a ``[lanes, m, n]``
    ``w``."""
    if w.ndim == 2:
        return x @ w
    n = w.shape[0]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} lanes")
    y = torch.bmm(x.reshape(n, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def matmul_factored(x: torch.Tensor, f: Any) -> torch.Tensor:
    """``x @ f`` for a raw factor or a :class:`FactoredDelta` (applied through
    :func:`effective_factor`, in x's dtype)."""
    return lane_matmul(x, effective_factor(f, x.dtype))


def fused_lora_delta(x: torch.Tensor, leaf: Dict[str, Any], scale: float) -> torch.Tensor:
    """``scale·(x@a_k)@b_k`` where either factor may be a
    :class:`FactoredDelta`. Both factored over 2D ``w`` (every layer-sliced
    dense site): the chain kernel K2 (``ops.fused_lora.member_lora_delta``).
    Any other mix: two products with the perturbed factors built at the
    point of use (:func:`matmul_factored`)."""
    a, b = leaf["a"], leaf["b"]
    if (isinstance(a, FactoredDelta) and isinstance(b, FactoredDelta)
            and a.w.ndim == 2 and b.w.ndim == 2):
        from .ops.fused_lora import member_lora_delta

        return member_lora_delta(x, a, b, scale)
    h = matmul_factored(x, a)
    return matmul_factored(h, b) * scale


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


def init_lora(params: Any, spec: LoRASpec, key: torch.Tensor,
              device: Optional[torch.device] = None) -> Adapter:
    """The adapter tree for every targeted kernel (float ``kernel`` or int8
    ``kernel_q8/q8``): ``a ~ N(0, 1/fan_in)``, ``b = 0`` (identity at init,
    as PEFT). As in the JAX package, ``key`` splits into one key per kernel
    path, targeted or not, in path order; the draws are made on the key's
    device and land on ``device`` (default: the kernel's)."""
    kernels = [(p, leaf) for p, leaf in iter_kernel_paths(params)
               if p.endswith("kernel") or p.endswith("kernel_q8/q8")]
    keys = threefry.split(key, max(len(kernels), 1))
    tree: Adapter = {}
    for k, (path, leaf) in zip(keys, kernels):
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
        a = threefry.normal(k, a_shape) / math.sqrt(fan)
        tree[name] = {"a": a.to(dev), "b": torch.zeros(b_shape, device=dev)}
    return tree


def lookup(lora: Optional[Dict[str, Any]], path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The adapter leaf for a kernel path, or ``None``."""
    if lora is None:
        return None
    return lora.get(path)


def _slice_factor(f: Any, i: int) -> Any:
    if isinstance(f, FactoredDelta):
        # w, u and v carry the layer stack; c is per member, not per layer
        return FactoredDelta(f.w.select(-3, i), f.u.select(-3, i), f.v.select(-3, i), f.c)
    return f.select(-3, i)


def slice_layer(leaf: Optional[Dict[str, Any]], i: int) -> Optional[Dict[str, Any]]:
    """Layer ``i`` of stacked ``[.., L, m, n]`` factors, raw or
    :class:`FactoredDelta`. The layer axis is the third from last, so a
    lane-stacked ``[A, L, m, n]`` leaf gives ``[A, m, n]``."""
    if leaf is None:
        return None
    return {"a": _slice_factor(leaf["a"], i), "b": _slice_factor(leaf["b"], i)}


def lora_delta(x: torch.Tensor, leaf: Optional[Dict[str, torch.Tensor]], scale: float) -> Optional[torch.Tensor]:
    """``scale·(x@A)@B`` for 2D factors ``A [din, r]``, ``B [r, dout]``;
    ``None`` when the layer is unadapted.

    Lane-stacked factors ``A [n, din, r]``, ``B [n, r, dout]`` apply lane
    ``i``'s adapter to the ``i``-th of ``n`` equal row groups of ``x``
    (``x``'s leading axis is lane-major), so several adapters share one base
    matmul."""
    if leaf is None:
        return None
    return lane_matmul(lane_matmul(x, leaf["a"].to(x.dtype)), leaf["b"].to(x.dtype)) * scale


def stack_adapters(trees: Sequence[Any]) -> Any:
    """N same-structure adapters → one adapter whose every leaf has a leading
    ``[N]`` axis (the serving batch, a chunk of ES members). Adapters may be
    nested (Z-Image's ``{"transformer", "vae_decoder"}``). A structure or
    shape mismatch raises naming the adapter."""
    if not trees:
        raise ValueError("stack_adapters needs at least one adapter tree")
    ref = list(tree_leaves_with_path(trees[0]))
    for i, tree in enumerate(trees[1:], start=1):
        leaves = list(tree_leaves_with_path(tree))
        if [p for p, _ in leaves] != [p for p, _ in ref]:
            raise ValueError(
                f"adapter {i} has a different tree structure than adapter 0 "
                "(was it trained against a different target list / rank?)"
            )
        for (path, t), (_, r) in zip(leaves, ref):
            if t.shape != r.shape or t.dtype != r.dtype:
                raise ValueError(
                    f"adapter {i} leaf {path}: shape/dtype {tuple(t.shape)}/{t.dtype} "
                    f"!= adapter 0's {tuple(r.shape)}/{r.dtype}"
                )
    return tree_replace_leaves(trees[0], [torch.stack(ls) for ls in zip(*(tree_leaves(t) for t in trees))])
