"""EGGROLL low-rank ES noise, member perturbations and the update.

Port of ``hyperscalees_t2i_tpu/es/noiser.py``. θ is the flat LoRA adapter
dict ``{path: {"a", "b"}}``; its noise is a tree of the same structure whose
leaves are :class:`LowRankNoise` (2D ``[m, n]`` leaves: ``U [base, m, r]``,
``V [base, n, r]``; stacked 3D ``[L, m, n]`` leaves: ``U [base, L, m, r]``)
or :class:`DenseNoise` (any other rank: ``E [base, *shape]``). Member ``k``
uses base sample ``b_k`` with sign ``s_k`` (antithetic layout
``[e_0..e_{h-1}, −e_0..−e_{h-1}, (+e_h if odd)]``), and
``ε_k = s_k·U_b V_bᵀ/√r``. The update contracts the fitness into the
factors, so no ``[pop, D]`` matrix ever exists.

Draws come from a ``utils.threefry`` key and are the JAX package's numbers
(the same key tree, leaf by leaf). Every contraction upcasts the (possibly
bf16) noise store to f32.

The pop-sharded update splits the contraction over the processes of a
launch (``parallel.pop_update``): each contracts its slice of base samples
(:func:`es_partial_delta`), one all-reduce sums the partials, and
:func:`apply_es_delta` applies the sum with :func:`es_update`'s scaling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..device import constant
from ..utils import threefry
from ..utils.pytree import resolve_float_dtype, tree_leaves, tree_leaves_with_path, tree_map, tree_replace_leaves

Index = Union[int, slice]


@dataclasses.dataclass(frozen=True)
class EggRollConfig:
    """Static ES hyperparameters. ``lr = lr_scale·σ`` (the reference code's
    behaviour, which the JAX package reproduces)."""

    sigma: float = 0.01
    lr_scale: float = 1.0
    rank: int = 1
    antithetic: bool = True
    noise_dtype: str = "float32"

    def __post_init__(self) -> None:
        resolve_float_dtype(self.noise_dtype)

    @property
    def lr(self) -> float:
        return self.lr_scale * self.sigma

    @property
    def noise_torch_dtype(self) -> torch.dtype:
        return resolve_float_dtype(self.noise_dtype)


class LowRankNoise(NamedTuple):
    """Factored noise of one 2D or stacked-3D leaf: ``ε_b = U[b] @ V[b]ᵀ/√r``."""

    U: torch.Tensor  # [base, (L,) m, r]
    V: torch.Tensor  # [base, (L,) n, r]


class DenseNoise(NamedTuple):
    """Dense noise of one leaf of any other rank: ``ε_b = E[b]``."""

    E: torch.Tensor  # [base, *leaf.shape]


def _is_noise(x: Any) -> bool:
    return isinstance(x, (LowRankNoise, DenseNoise))


def base_pop_size(pop_size: int, antithetic: bool) -> int:
    """Independently drawn base samples: ``⌈pop/2⌉`` antithetic, else pop."""
    if not antithetic:
        return pop_size
    return pop_size // 2 + pop_size % 2


def member_signs_and_bases(pop_size: int, antithetic: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Member ``k`` → (sign ``s_k``, base sample ``b_k``), in the layout
    ``[e_0..e_{h-1}, −e_0..−e_{h-1}, (+e_h if odd)]``."""
    if not antithetic:
        return np.ones(pop_size, np.float32), np.arange(pop_size, dtype=np.int64)
    half = pop_size // 2
    signs = np.ones(pop_size, np.float32)
    signs[half:2 * half] = -1.0
    bases = np.concatenate([np.arange(half), np.arange(half), np.full(pop_size % 2, half)]).astype(np.int64)
    return signs, bases


def member_maps(pop_size: int, antithetic: bool, device: Union[str, torch.device]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`member_signs_and_bases` as tensors on ``device`` (f32 signs,
    int64 bases), made once per (geometry, device) and shared after:
    callers must not write to them."""
    signs, bases = member_signs_and_bases(pop_size, antithetic)
    return constant(signs.tolist(), torch.float32, device), constant(bases.tolist(), torch.int64, device)


def sample_noise(key: torch.Tensor, theta: Any, pop_size: int, cfg: EggRollConfig) -> Any:
    """Factored population noise for ``theta``, the JAX package's draws:
    ``key`` splits into one key per leaf in flattening order; a 2D or
    stacked-3D leaf splits its key into ``(ku, kv)`` for ``U`` and ``V``,
    any other leaf draws ``E`` from its own. f32 standard normals on the
    key's device, cast to the store dtype. Draws of one shape are made
    together, one batch of keys each."""
    base = base_pop_size(pop_size, cfg.antithetic)
    ndt = cfg.noise_torch_dtype
    leaves = tree_leaves(theta)
    keys = threefry.split(key, max(len(leaves), 1))
    uv = threefry.split(keys)  # [leaves, 2 (ku, kv), 2]; read for the factored leaves only
    requests: List[Tuple[torch.Tensor, Tuple[int, ...]]] = []  # (key, shape) per draw, in leaf order
    for i, leaf in enumerate(leaves):
        if leaf.ndim in (2, 3):
            *stack, m, n = leaf.shape
            requests.append((uv[i, 0], (base, *stack, m, cfg.rank)))
            requests.append((uv[i, 1], (base, *stack, n, cfg.rank)))
        else:
            requests.append((keys[i], (base, *leaf.shape)))
    draws: List[Any] = [None] * len(requests)
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for r, (_, shape) in enumerate(requests):
        by_shape.setdefault(shape, []).append(r)
    for shape, rs in by_shape.items():
        z = threefry.normal(torch.stack([requests[r][0] for r in rs]), shape).to(ndt)
        for zi, r in zip(z, rs):
            draws[r] = zi
    it = iter(draws)
    return tree_replace_leaves(theta, [LowRankNoise(U=next(it), V=next(it)) if leaf.ndim in (2, 3)
                                       else DenseNoise(E=next(it)) for leaf in leaves])


def _noise_pairs(theta: Any, noise: Any) -> List[Tuple[torch.Tensor, Any]]:
    """``(θ leaf, noise node)`` pairs in flattening order; raises naming the
    mismatch when ``noise`` was not sampled for a θ of this structure."""
    t = list(tree_leaves_with_path(theta))
    n = list(tree_leaves_with_path(noise, is_leaf=_is_noise))
    if [p for p, _ in t] != [p for p, _ in n]:
        raise ValueError(
            "noise tree structure does not match theta (was the noise sampled from a "
            f"different adapter tree?): theta {[p for p, _ in t]}, noise {[p for p, _ in n]}"
        )
    bad = [p for p, x in n if not _is_noise(x)]
    if bad:
        raise ValueError(f"noise leaves must be LowRankNoise/DenseNoise nodes; got raw leaves at {bad}")
    return [(tl, nl) for (_, tl), (_, nl) in zip(t, n)]


def _member(pop_size: int, cfg: EggRollConfig, k: int) -> Tuple[float, int]:
    signs, bases = member_signs_and_bases(pop_size, cfg.antithetic)
    return float(signs[k]), int(bases[k])


def materialize_member_eps(theta: Any, noise: Any, k: int, pop_size: int, cfg: EggRollConfig) -> Any:
    """Member ``k``'s full perturbation ``ε_k`` (f32), shaped like θ."""
    s, b = _member(pop_size, cfg, k)
    inv_sqrt_r = 1.0 / math.sqrt(cfg.rank)
    out = []
    for _, fac in _noise_pairs(theta, noise):
        if isinstance(fac, LowRankNoise):
            eps = (fac.U[b].to(torch.float32) @ fac.V[b].to(torch.float32).transpose(-1, -2)) * inv_sqrt_r
        else:
            eps = fac.E[b].to(torch.float32)
        out.append(s * eps)
    return tree_replace_leaves(theta, out)


Scale = Union[float, torch.Tensor]


def scaled(s: Scale, x: torch.Tensor) -> torch.Tensor:
    """``s·x`` in ``x``'s dtype, with ``s`` a Python float or an f32 scalar
    tensor: either way ``s`` is rounded to f32 once, the product is taken in
    f32 and rounded to ``x``'s dtype once (what torch does for a Python
    scalar), so a tensor holding ``f32(s)`` gives the float's bits."""
    if not isinstance(s, torch.Tensor):
        return s * x
    return x * s if x.dtype == torch.float32 else (x.to(torch.float32) * s).to(x.dtype)


def perturb_member(theta: Any, noise: Any, k: int, pop_size: int, cfg: EggRollConfig,
                   sigma: Optional[Scale] = None) -> Any:
    """``θ_k = θ + σ·ε_k``, materialized (cast to θ's dtype before the add).
    ``sigma`` (an f32 scalar tensor: the fleet's per-job σ) replaces
    ``cfg.sigma``; ``f32(cfg.sigma)`` there gives the same bits."""
    eps = materialize_member_eps(theta, noise, k, pop_size, cfg)
    s = cfg.sigma if sigma is None else sigma
    leaves = [t + scaled(s, e.to(t.dtype)) for t, e in zip(tree_leaves(theta), tree_leaves(eps))]
    return tree_replace_leaves(theta, leaves)


def factored_member_theta(theta: Any, noise: Any, k: Union[int, List[int]], pop_size: int,
                          cfg: EggRollConfig, sigma: Optional[torch.Tensor] = None,
                          c_scale: Optional[torch.Tensor] = None) -> Any:
    """Member ``k``'s adapter with the perturbation kept factored: each
    low-rank-noised leaf becomes ``lora.FactoredDelta(w=θ leaf, u=U[b],
    v=V[b], c=σ·s_k/√r)`` (``c`` computed in f32); dense-noised leaves are
    materialized as ``θ + σ·s·E[b]``.

    ``k`` may be a list of members: ``u``, ``v`` and ``c`` then carry a
    leading lane axis (one lane per member, in order), dense-noised leaves
    a lane-stacked ``[lanes, ...]`` value, and the forward's rows must be
    grouped lane-major.

    ``sigma`` and ``c_scale`` (f32 scalar tensors on the device, given
    together: the fleet's per-job σ_j and ``f32(σ_j/√r)`` from
    ``train.trainer.fleet_scalar_args``) replace the σ of the dense leaves
    and the ``f32(σ/√r)`` of ``c``, which the solo step makes once as
    device constants. They are a program's inputs, so a captured program
    serves any σ; the same values give the same bits as the constants."""
    from ..lora import FactoredDelta

    if (sigma is None) != (c_scale is None):
        raise ValueError("factored_member_theta: give sigma and c_scale together "
                         "(c_scale = float32(sigma / sqrt(rank)), from fleet_scalar_args)")
    members = [k] if isinstance(k, int) else list(k)
    sb = [_member(pop_size, cfg, m) for m in members]
    pairs = _noise_pairs(theta, noise)
    # made once on the device (no host copy: the step is captured whole)
    dev = pairs[0][0].device if pairs else torch.device("cpu")
    idx = constant([b for _, b in sb], torch.int64, dev)
    signs = constant([s for s, _ in sb], torch.float32, dev)
    if c_scale is None:
        c_f32 = float(np.float32(cfg.sigma / math.sqrt(cfg.rank)))  # σ/√r rounded to f32; ·(±1) is exact
        c_lanes = constant([c_f32 * s for s, _ in sb], torch.float32, dev)
        sigma = cfg.sigma
    else:
        c_lanes = c_scale * signs
    out = []
    for t, fac in pairs:
        if isinstance(fac, LowRankNoise):
            u, v, c = fac.U[idx], fac.V[idx], c_lanes
            if isinstance(k, int):
                u, v, c = u[0], v[0], c[0]
            out.append(FactoredDelta(w=t, u=u, v=v, c=c))
        else:
            e = fac.E[idx].to(torch.float32)
            s = signs.reshape(-1, *([1] * (e.ndim - 1)))
            val = t + (sigma * s * e).to(t.dtype)
            out.append(val[0] if isinstance(k, int) else val)
    return tree_replace_leaves(theta, out)


def fitness_coeffs(fitness: torch.Tensor, pop_size: int, cfg: EggRollConfig) -> torch.Tensor:
    """Per-base coefficients ``c_b = Σ_{k: b_k=b} f_k·s_k`` (f32)."""
    signs, bases = member_signs_and_bases(pop_size, cfg.antithetic)
    dev = fitness.device
    w = fitness.to(torch.float32) * constant(signs.tolist(), torch.float32, dev)
    c = torch.zeros(base_pop_size(pop_size, cfg.antithetic), dtype=torch.float32, device=dev)
    return c.index_add_(0, constant(bases.tolist(), torch.int64, dev), w)


def es_update(theta: Any, noise: Any, fitness: torch.Tensor, pop_size: int, cfg: EggRollConfig,
              lr: Optional[Scale] = None) -> Any:
    """``θ' = θ + lr·mean_k(f_k·ε_k)`` in factored form: per low-rank leaf
    ``Σ_b c_b U_b V_bᵀ/(pop·√r)``, per dense leaf ``Σ_b c_b E_b/pop``, the
    contractions in f32 over the upcast noise; the delta is cast to θ's
    dtype before ``t + lr·delta``. ``lr`` (an f32 scalar tensor: the
    fleet's per-job ``f32(lr_scale·σ)``) replaces ``cfg.lr`` with the same
    bits for the same value."""
    if lr is None:
        lr = cfg.lr
    c = fitness_coeffs(fitness, pop_size, cfg)
    inv = 1.0 / (pop_size * math.sqrt(cfg.rank))
    out = []
    for t, fac in _noise_pairs(theta, noise):
        cc = c.to(t.device)
        if isinstance(fac, LowRankNoise):
            U, V = fac.U.to(torch.float32), fac.V.to(torch.float32)
            cu = U * cc.reshape(-1, *([1] * (U.ndim - 1)))
            delta = (cu @ V.transpose(-1, -2)).sum(0) * inv
        else:
            E = fac.E.to(torch.float32)
            delta = (E * cc.reshape(-1, *([1] * (E.ndim - 1)))).sum(0) / pop_size
        out.append(t + scaled(lr, delta.to(t.dtype)))
    return tree_replace_leaves(theta, out)


def es_partial_delta(theta: Any, noise: Any, coeffs: torch.Tensor, lo: int, n_slice: int, pop_size: int,
                     cfg: EggRollConfig) -> Any:
    """One shard's unnormalized share of the update: the coefficient-weighted
    noise summed over base samples ``[lo, lo + n_slice)`` only, a θ-shaped
    tree of f32 sums (low-rank leaves ``Σ c_b U_b V_bᵀ``, not yet divided by
    ``pop·√r``; dense leaves ``Σ c_b E_b``, not yet by ``pop``), contracted
    as :func:`es_update` contracts. The partials of a disjoint cover of
    ``[0, base)`` sum to :func:`es_update`'s contraction up to f32
    summation order (one shard over the whole range: bitwise)."""
    cs = coeffs[lo:lo + n_slice].to(torch.float32)
    out = []
    for _, fac in _noise_pairs(theta, noise):
        if isinstance(fac, LowRankNoise):
            U = fac.U[lo:lo + n_slice].to(torch.float32)
            V = fac.V[lo:lo + n_slice].to(torch.float32)
            part = ((U * cs.reshape(-1, *([1] * (U.ndim - 1)))) @ V.transpose(-1, -2)).sum(0)
        else:
            E = fac.E[lo:lo + n_slice].to(torch.float32)
            part = (E * cs.reshape(-1, *([1] * (E.ndim - 1)))).sum(0)
        out.append(part)
    return tree_replace_leaves(theta, out)


def apply_es_delta(theta: Any, delta_sums: Any, noise: Any, pop_size: int, cfg: EggRollConfig) -> Any:
    """``θ' = θ + lr·delta`` from the summed :func:`es_partial_delta` trees:
    low-rank leaves scaled by ``1/(pop·√r)``, dense leaves divided by
    ``pop``, as :func:`es_update` scales them, the delta cast to θ's dtype
    before the add. Which leaves are low-rank is read from the ``noise``
    tree's node types, the one authority."""
    inv = 1.0 / (pop_size * math.sqrt(cfg.rank))
    out = []
    for (t, fac), d in zip(_noise_pairs(theta, noise), tree_leaves(delta_sums)):
        delta = d * inv if isinstance(fac, LowRankNoise) else d / pop_size
        out.append(t + scaled(cfg.lr, delta.to(t.dtype)))
    return tree_replace_leaves(theta, out)


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
