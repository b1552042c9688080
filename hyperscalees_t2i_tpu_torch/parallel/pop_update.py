"""The pop-sharded EGGROLL update: each process contracts only its own slice
of base samples (port of ``hyperscalees_t2i_tpu/parallel/pop_update.py``).

The update is a sum over base samples of fitness-weighted rank-r factors,
so a contiguous slice per process and one sum of the adapter-sized partial
trees give the whole Δθ::

    Δ = Σ_b c_b U_b V_bᵀ = Σ_rank ( Σ_{b ∈ rank's slice} c_b U_b V_bᵀ )

The port's pop axis is the process group (``parallel.mesh``):
:func:`pop_shard_update_plan` takes its size from ``process_count()``, and
rank ``i`` contracts base samples ``[i·lslice, (i+1)·lslice)``. The partial
tree travels as one flat f32 buffer through one all-reduce on the gloo
group; on the card that buffer is copied to the host and back, outside any
CUDA graph (``train.trainer.make_host_sharded_programs`` runs the update
as two programs around it). Every rank then applies the same summed bytes,
so every rank leaves with a bitwise-identical θ′. Against the replicated
update the sum order differs: rounding-tight, not bitwise.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..es.noiser import EggRollConfig, apply_es_delta, base_pop_size, es_partial_delta, fitness_coeffs
from ..utils.pytree import tree_leaves, tree_replace_leaves
from .collectives import axis_size, process_count, process_rank, psum_tree

Pytree = Any


def pop_shard_update_plan(mode: str, pop_size: int, antithetic: bool,
                          n_pop: Optional[int] = None) -> Tuple[bool, str]:
    """Resolve ``--pop_shard_update {auto,on,off}`` against a pop axis of
    ``n_pop`` processes (default: the launch's process count). Returns
    ``(enabled, reason)``:

    - ``off``, or a pop axis of 1: replicated; ``on`` with a pop axis of 1
      raises (the sharding cannot exist);
    - the base-sample count must tile the pop axis (contiguous slices, no
      padding of the noise store): ``auto`` falls back to replicated when it
      does not, ``on`` raises naming both numbers."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"pop_shard_update must be auto/on/off, got {mode!r}")
    if mode == "off":
        return False, "off"
    n_pop = process_count() if n_pop is None else int(n_pop)
    if n_pop <= 1:
        if mode == "on":
            raise ValueError(
                "pop_shard_update=on needs a pop axis of size > 1 "
                f"(the process group: {n_pop} process(es))"
            )
        return False, "no pop axis"
    base = base_pop_size(pop_size, antithetic)
    if base % n_pop:
        if mode == "on":
            raise ValueError(
                f"pop_shard_update=on needs the base-sample count ({base}, "
                f"from pop_size={pop_size}, antithetic={antithetic}) divisible "
                f"by the pop-axis size ({n_pop}) — contiguous slices only"
            )
        return False, f"base {base} % pop axis {n_pop} != 0"
    return True, f"{n_pop}-way"


def _flat(tree: Pytree) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])


def _unflat(flat: torch.Tensor, theta: Pytree) -> Pytree:
    out, i = [], 0
    for t in tree_leaves(theta):
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return tree_replace_leaves(theta, out)


def make_sharded_es_update(pop_size: int, cfg: EggRollConfig, group: Any = None,
                           shards: Optional[Tuple[int, int]] = None) -> Callable[[Pytree, Pytree, torch.Tensor], Pytree]:
    """``update(theta, noise, fitness) → θ'`` with the fitness-weighted noise
    contraction split over the processes of ``group`` (default: the launch).

    Every rank takes the same θ, noise and ``[pop]`` fitness; rank ``i``
    contracts its ``base/n`` base samples (``update.partial``: the flat f32
    partial sums), ``update.reduce`` sums the flat buffers over the group
    (one all-reduce), and ``update.apply`` applies the sum
    (``es.noiser.apply_es_delta``). ``update`` is the three in order; a
    caller that captures the first and last as programs runs ``reduce``
    between them on the host. ``shards = (n, i)`` plans share ``i`` of
    ``n`` for a process outside such a launch (``tools.preflight``
    measures one process's share); its ``reduce`` sums nothing."""
    n_pop = axis_size(group) if shards is None else int(shards[0])
    base = base_pop_size(pop_size, cfg.antithetic)
    if base % n_pop:
        raise ValueError(f"base sample count {base} does not tile the pop axis ({n_pop})")
    lslice = base // n_pop
    if shards is not None:
        lo = int(shards[1]) * lslice
    else:
        lo = (process_rank() if group is None else torch.distributed.get_rank(group)) * lslice

    def partial(theta: Pytree, noise: Pytree, fitness: torch.Tensor) -> torch.Tensor:
        coeffs = fitness_coeffs(fitness, pop_size, cfg)  # tiny [base], the same on every rank
        return _flat(es_partial_delta(theta, noise, coeffs, lo, lslice, pop_size, cfg))

    def reduce(flat: torch.Tensor) -> torch.Tensor:
        return psum_tree(flat, group) if shards is None else flat.clone()

    def apply(theta: Pytree, flat: torch.Tensor, noise: Pytree) -> Pytree:
        return apply_es_delta(theta, _unflat(flat, theta), noise, pop_size, cfg)

    def update(theta: Pytree, noise: Pytree, fitness: torch.Tensor) -> Pytree:
        return apply(theta, reduce(partial(theta, noise, fitness)), noise)

    update.partial, update.reduce, update.apply = partial, reduce, apply
    update.n_pop, update.slice = n_pop, (lo, lslice)
    return update
