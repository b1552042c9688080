"""Nested-dict parameter trees: dtype knobs, leaf-wise maps, flat views.

Parameter trees are plain nested ``dict``/``list`` structures of tensors, the
same structure as the JAX package's pytrees (so weights move across leaf by
leaf). Dict leaves are visited in sorted key order, the order JAX flattens
dicts in. The flat views (port of ``hyperscalees_t2i_tpu/utils/pytree.py``
and of ``flatten_with_paths`` in its ``resilience/checkpoints.py``) serve
norm logging and the checkpoint files.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def resolve_float_dtype(name: str) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (aliases ``"f32"``/``"bf16"``) → torch
    dtype. Unknown names raise."""
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32"):
        return torch.float32
    raise ValueError(f"dtype knob must be float32 or bfloat16, got {name!r}")


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """Apply ``fn`` to every non-container leaf, keeping the structure.
    Named tuples (the ES noise nodes, ``lora.FactoredDelta``) are
    containers; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves_with_path(tree: Tree, prefix: str = "",
                          is_leaf: Optional[Callable[[Any], bool]] = None) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, dict keys sorted, path parts joined by ``/``;
    a node that ``is_leaf`` accepts is a leaf."""
    if tree is None:
        return
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{prefix}/{k}" if prefix else str(k), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{prefix}/{i}" if prefix else str(i), is_leaf)
    else:
        yield prefix, tree


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_replace_leaves(tree: Tree, values: List[Any]) -> Tree:
    """``tree``'s structure with its leaves replaced by ``values``, given in
    flattening order (dict keys sorted)."""
    it = iter(values)

    def walk(t: Tree) -> Tree:
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)


def tree_structure(tree: Tree) -> Any:
    """A hashable description of the container structure (leaves elided)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_structure(v) for v in tree))
    return "*"


def cast_floating(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast every floating tensor leaf to ``dtype``; integer leaves (the int8
    ``q8`` kernels) are untouched."""
    return tree_map(
        lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x,
        tree,
    )


def tree_size(tree: Tree) -> int:
    """The number of scalars in the tree's leaves."""
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))


def tree_to_flat(tree: Tree) -> torch.Tensor:
    """Every leaf, in flattening order, as one f32 vector."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([leaf.to(torch.float32).reshape(-1) for leaf in leaves])


def flat_to_tree(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`tree_to_flat`: ``like``'s structure, shapes and
    dtypes filled from ``flat``."""
    leaves = tree_leaves(like)
    need = sum(leaf.numel() for leaf in leaves)
    if need != flat.shape[0]:
        raise ValueError(f"flat vector has {flat.shape[0]} elems, tree needs {need}")
    out, idx = [], 0
    for leaf in leaves:
        out.append(flat[idx:idx + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        idx += leaf.numel()
    return tree_replace_leaves(like, out)


def zero_like_theta(theta: Tree) -> Tree:
    """θ = 0: every LoRA delta vanishes, so the adapted model is the base."""
    return tree_map(torch.zeros_like, theta)


def tree_norms(tree: Tree) -> Dict[str, torch.Tensor]:
    """The global L2 norm and the mean of |x| over the f32 flat vector (the
    reference's per-epoch θ diagnostics)."""
    flat = tree_to_flat(tree)
    n = max(flat.shape[0], 1)
    return {"norm": torch.linalg.vector_norm(flat), "mean_abs": flat.abs().sum() / n}


def flatten_with_paths(tree: Tree) -> Dict[str, np.ndarray]:
    """``{"a/b/c": ndarray}`` on the host, keys slash-joined with dict keys
    sorted: the checkpoint files' layout, key for key the JAX package's."""
    return {path: leaf.detach().cpu().contiguous().numpy() for path, leaf in tree_leaves_with_path(tree)}
