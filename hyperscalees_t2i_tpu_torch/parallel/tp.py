"""Tensor parallelism for the one-model inference paths (port of
``hyperscalees_t2i_tpu/parallel/tp.py``).

The rule tables are the JAX package's, letter for letter: each family's
linear weights split Megatron-style, QKV and up projections on the output
feature axis (column-parallel), out and down projections on the input
feature axis (row-parallel). An unlisted leaf, or one whose axis the tp
degree does not divide, stays replicated; so do int8 trees' ``kernel_q8``
leaves, which match no rule (their biases still do).

GSPMD inserts the collectives for the JAX package. Torch has none, so the
port writes them out: :func:`shard_module_tp` slices each matched buffer of
a built model's ``models.nn.Dense``/``Conv`` modules to this rank's chunk
and gives the module a :class:`TPShard`, and ``models.nn.dense`` /
``Conv`` run its plan. A column-parallel product gives the local output
features, then an all-gather on the feature axis; a row-parallel one takes
the local slice of its input, multiplies in f32 and all-reduces the partial
sums over the tp group, then rounds to the input's dtype once; a sharded
bias is gathered before it is added; a depthwise conv is channel-local (its
input channels sliced, its output gathered). Every product's output is
whole again, so the model code between layers is the same for all four
families, correct by construction, as the rules are. Keeping heads local to
a rank is later work. The collectives are gloo's over the group (host
copies), and a forward with them runs eagerly: a gloo collective cannot be
captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .collectives import all_gather_tree, axis_size, psum_tree

Pytree = Any

# (path regex, feature axis to shard). Axis indices may be negative.
TPRules = List[Tuple[str, int]]

# Sana DiT: separate q/k/v (linear attention) and GLUMBConv mix-FFN.
SANA_TP_RULES: TPRules = [
    (r"blocks/attn[12]/to_[qkv]/kernel$", -1),
    (r"blocks/attn[12]/to_[qkv]/bias$", -1),
    (r"blocks/attn[12]/to_out/kernel$", -2),  # row-parallel: partial sums
    (r"blocks/ff/conv_inverted/(kernel|bias)$", -1),
    (r"blocks/ff/conv_depth/(kernel|bias)$", -1),  # depthwise: channel-local
    (r"blocks/ff/conv_point/kernel$", -2),
]

# Z-Image single-stream DiT: fused qkv + fused SwiGLU gate/up.
ZIMAGE_TP_RULES: TPRules = [
    (r"blocks/qkv/(kernel|bias)$", -1),
    (r"blocks/attn_proj/kernel$", -2),
    (r"blocks/fc1/(kernel|bias)$", -1),
    (r"blocks/fc2/kernel$", -2),
]

# VAR / Infinity AR transformers share the fused-qkv + MLP block layout.
AR_TP_RULES: TPRules = [
    (r"blocks/qkv/(kernel|bias)$", -1),
    (r"blocks/attn_proj/kernel$", -2),
    (r"blocks/cross_q/(kernel|bias)$", -1),
    (r"blocks/cross_kv/(kernel|bias)$", -1),
    (r"blocks/cross_proj/kernel$", -2),
    (r"blocks/fc1/(kernel|bias)$", -1),
    (r"blocks/fc2/kernel$", -2),
]

FAMILY_TP_RULES = {
    "sana": SANA_TP_RULES,
    "zimage": ZIMAGE_TP_RULES,
    "var": AR_TP_RULES,
    "infinity": AR_TP_RULES,
}

# each collective of the tp forward: calls and host seconds (copies included)
TP_STATS: Dict[str, List[float]] = {"all_gather": [0, 0.0], "all_reduce": [0, 0.0]}


def leaf_tp_axis(name: str, shape: Tuple[int, ...], n_tp: int, rules: TPRules) -> Optional[int]:
    """The axis (non-negative) the first matching rule shards ``name`` on,
    or ``None``: no rule matches, ``n_tp`` is 1, or the axis does not divide
    by ``n_tp``."""
    if n_tp <= 1:
        return None
    ndim = len(shape)
    for pat, ax in rules:
        if re.search(pat, name):
            axis = ax if ax >= 0 else ndim + ax
            if 0 <= axis < ndim and shape[axis] % n_tp == 0:
                return axis
            return None  # matched but not shardable → replicate
    return None


def _walk(tree: Pytree, fn, prefix: str = "") -> Pytree:
    if tree is None:  # an empty node, as in a JAX tree
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def tp_sharding_tree(params: Pytree, n_tp: int, rules: TPRules) -> Pytree:
    """Each leaf's plan: the axis it shards over ``tp`` (``n_tp`` ranks),
    or ``None`` (replicated): the JAX ``tp_sharding_tree``'s specs as axes."""
    return _walk(params, lambda name, leaf: leaf_tp_axis(name, tuple(leaf.shape), n_tp, rules))


def _chunk(t: torch.Tensor, axis: int, n: int, rank: int) -> torch.Tensor:
    k = t.shape[axis] // n
    return t.narrow(axis, rank * k, k).contiguous()


def _group_rank(group: Any) -> Tuple[int, int]:
    n = axis_size(group)
    if n <= 1:
        return 1, 0
    import torch.distributed as dist

    return n, dist.get_rank(group)


def shard_params_tp(params: Pytree, family: str, group: Any = None) -> Pytree:
    """This rank's local tree: every leaf the family's rules shard over the
    tp group (default: the launch) cut to the rank's contiguous chunk of
    its axis, the rest as given."""
    n, rank = _group_rank(group)
    rules = FAMILY_TP_RULES[family]

    def local(name: str, leaf: Any) -> Any:
        ax = leaf_tp_axis(name, tuple(leaf.shape), n, rules)
        return leaf if ax is None else _chunk(leaf, ax, n, rank)

    return _walk(params, local)


def count_tp_sharded(params: Pytree, n_tp: int, family: str) -> int:
    """How many leaves the family's rules shard at ``n_tp`` ranks."""
    count = [0]
    _walk(tp_sharding_tree(params, n_tp, FAMILY_TP_RULES[family]),
          lambda name, ax: count.__setitem__(0, count[0] + (ax is not None)))
    return count[0]


@dataclasses.dataclass
class TPShard:
    """One dense or conv node's plan on this rank: ``kernel`` -1
    (column-parallel: the local output features), -2 (row-parallel: the
    local input features) or ``None`` (replicated); ``bias`` -1 (the local
    chunk) or ``None``."""

    kernel: Optional[int]
    bias: Optional[int]
    group: Any
    n: int
    rank: int

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's chunk of the last axis, in rank order."""
        t0 = time.perf_counter()
        out = all_gather_tree(y, axis=-1, group=self.group)
        TP_STATS["all_gather"][0] += 1
        TP_STATS["all_gather"][1] += time.perf_counter() - t0
        return out

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The partial sums added over the group."""
        t0 = time.perf_counter()
        out = psum_tree(y, group=self.group)
        TP_STATS["all_reduce"][0] += 1
        TP_STATS["all_reduce"][1] += time.perf_counter() - t0
        return out

    def local_in(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``x``'s last (feature) axis."""
        k = x.shape[-1] // self.n
        return x[..., self.rank * k:(self.rank + 1) * k]

    def full_bias(self, b: torch.Tensor) -> torch.Tensor:
        return self.gather(b) if self.bias is not None else b


def _module_path(name: str) -> str:
    """``blocks.3.attn1.to_q`` → ``blocks/attn1/to_q``: a per-layer module
    of a stacked tree reads its rules as the stacked leaf's path."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def shard_module_tp(model: torch.nn.Module, family: str, group: Any = None) -> int:
    """Shard a built model's dense and conv nodes over the tp group
    (default: the launch) in place, by the family's rules on each node's
    path and full shapes, and give each node its :class:`TPShard`. Returns
    the number of tree leaves sharded (:func:`count_tp_sharded`'s count: a
    node's kernel and bias apart, the layers of a stacked leaf once)."""
    from ..models import nn

    n, rank = _group_rank(group)
    rules = FAMILY_TP_RULES[family]
    sharded = set()
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Dense, nn.Conv)):
            continue
        path = _module_path(name)
        kernel_axis = None
        if isinstance(mod, nn.Dense) and hasattr(mod, "kernel"):
            ax = leaf_tp_axis(f"{path}/kernel", tuple(mod.kernel.shape), n, rules)
            if ax is not None:
                kernel_axis = ax - mod.kernel.ndim
                mod.kernel = _chunk(mod.kernel, ax, n, rank)
        elif isinstance(mod, nn.Conv) and hasattr(mod, "kernel_oihw"):
            o, i, kh, kw = mod.kernel_oihw.shape
            ax = leaf_tp_axis(f"{path}/kernel", (kh, kw, i, o), n, rules)  # the HWIO leaf
            if ax is not None:
                kernel_axis = ax - 4
                mod.kernel_oihw = _chunk(mod.kernel_oihw, 0 if kernel_axis == -1 else 1, n, rank)
                if mod.groups > 1:  # depthwise: channel-local
                    mod.groups //= n
        bias_axis = None
        if hasattr(mod, "bias") and mod.bias is not None:
            ax = leaf_tp_axis(f"{path}/bias", tuple(mod.bias.shape), n, rules)
            if ax is not None:
                bias_axis = -1
                mod.bias = _chunk(mod.bias, ax, n, rank)
        if kernel_axis is not None or bias_axis is not None:
            mod.tp = TPShard(kernel_axis, bias_axis, group, n, rank)
            sharded.update(f"{path}/{leaf}" for leaf, ax in (("kernel", kernel_axis), ("bias", bias_axis))
                           if ax is not None)
    return len(sharded)
