"""Member-axis slicing of stacked adapter trees (the serving part of
``hyperscalees_t2i_tpu/es/noiser.py``; the ES noise and update come with the
training slice)."""

from __future__ import annotations

from typing import Any, Union

import torch

from ..utils.pytree import tree_leaves, tree_map

Index = Union[int, slice]


def lane_slice(stacked: Any, k: Index) -> Any:
    """Slot ``k`` (an int, or a slice for a chunk of lanes) of a tree whose
    every tensor leaf carries a leading lane axis."""
    bad = [i for i, leaf in enumerate(tree_leaves(stacked))
           if not torch.is_tensor(leaf) or leaf.ndim < 1]
    if bad:
        raise ValueError(
            f"stacked adapter leaves need a leading adapter axis; leaf index(es) {bad} "
            "are scalars — build the batch with lora.stack_adapters"
        )
    return tree_map(lambda leaf: leaf[k], stacked)


def stacked_adapter_theta(stacked: Any, k: Index) -> Any:
    """Adapter ``k`` (or the lanes of slice ``k``) of an adapter batch built
    by ``lora.stack_adapters``."""
    return lane_slice(stacked, k)
