"""Member-batched evaluation on one device (port of
``hyperscalees_t2i_tpu/parallel/pop_eval.py``): the ES population evaluator
(the whole population, or one process's member slice, ``host_slice``), the
fleet evaluator (W jobs' populations against one base) and the
multi-tenant serving generator. The JAX package's mesh-sharded variant
shards the population over processes here: with a ``parallel.mesh``
``ProcessMesh`` each process evaluates its pop shard's members on its data
shard's images inside its program, and the rows are gathered over the data
group, then the pop group, on the host (a gloo collective cannot be
captured in a CUDA graph).

Trace time, as in the JAX package: a run of an evaluator's body while a
program is built (``utils.graphs.building``: its warm-up and its capture,
the runs jax's tracing stands for) counts ``pop_eval_traces``
(``serve_traces`` for the serving generator) on the process's registry,
opens ``trace/pop_eval`` (``trace/fleet_eval``, ``trace/serve_batch``) on
the process's tracer and notes its geometry for the program's ledger
record (``obs.program_cost.note_program_geometry``). On the card a build
counts two (the warm-up and the capture) and a replay, which runs no
Python, nothing; on the CPU an entry's first call is its build and counts
one, as jax traces once; later calls, and calls outside any program, count
nothing. (``fleet_traces`` is the fleet step's own count of every run.)"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..es.noiser import EggRollConfig, factored_member_theta, perturb_member, stacked_adapter_theta
from ..lora import stack_adapters
from ..obs.metrics import get_registry
from ..obs.program_cost import note_program_geometry, repeated
from ..obs.trace import span
from ..utils.graphs import building
from .collectives import all_gather_tree
from .mesh import DATA_AXIS, POP_AXIS

GenerateFn = Callable[..., torch.Tensor]
RewardFn = Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


def effective_reward_tile(batch: int, reward_tile: int) -> int:
    """Largest divisor of ``batch`` that is ≤ ``reward_tile`` (0 = untiled)."""
    if reward_tile <= 0 or reward_tile >= batch:
        return 0
    tile = reward_tile
    while batch % tile:
        tile -= 1
    return tile


def _note_effective_tile(batch: int, reward_tile: int) -> int:
    """The tile a ``batch`` runs at, with a warning on stderr where the
    divisor rounding degraded it (tile 2 on a batch of 7 runs 1-image
    tiles)."""
    eff = effective_reward_tile(batch, reward_tile)
    if 0 < eff < reward_tile < batch:
        print(f"[pop_eval] WARNING: reward_tile={reward_tile} does not divide the per-member batch B={batch}; "
              f"degraded to tile={eff} (pick a divisor of prompts_per_gen*batches_per_gen to avoid "
              "over-serializing the decode→reward pipeline)", file=sys.stderr, flush=True)
    return eff


def _trace_time(counter: Optional[str], name: str, attrs: Dict[str, Any], geometry: Callable[[], Dict[str, Any]]):
    """A run of a program body: inside a build, ``counter`` counted (when
    given), the geometry noted and the ``name`` span opened."""
    if not building():
        return contextlib.nullcontext()
    if counter is not None:
        get_registry().inc(counter)
    note_program_geometry(**geometry())
    return span(name, **attrs)


def _member_evaluator(generate_p: GenerateFn, reward_fn: RewardFn, pop_size: int, es_cfg: EggRollConfig,
                      member_batch: int, reward_tile: int, pop_fuse: bool) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_members(theta, noise, members, ids, gen_noise, sigma,
    c_scale)``: the rewards of the listed members, in chunks of
    ``member_batch`` (see :func:`make_population_evaluator`)."""

    def chunk_theta(theta, noise, members, sigma, c_scale):
        if pop_fuse:
            return factored_member_theta(theta, noise, members[0] if len(members) == 1 else members,
                                         pop_size, es_cfg, sigma=sigma, c_scale=c_scale)
        thetas = [perturb_member(theta, noise, k, pop_size, es_cfg, sigma=sigma) for k in members]
        return thetas[0] if len(thetas) == 1 else stack_adapters(thetas)

    def eval_members(theta, noise, members_all, ids, gen_noise, sigma, c_scale):
        B = ids.shape[0]
        tile = effective_reward_tile(B, reward_tile) or B
        chunks = []
        for c0 in range(0, len(members_all), member_batch):
            members = members_all[c0:c0 + member_batch]
            n = len(members)
            theta_k = chunk_theta(theta, noise, members, sigma, c_scale)
            tiles = []
            for i0 in range(0, B, tile):
                t_ids = ids[i0:i0 + tile]
                t_noise = gen_noise[i0:i0 + tile]
                # the same ops for every member tile of this shape (the program ledger counts two)
                with repeated(("member_tile", n, t_ids.shape[0])):
                    images = generate_p(theta_k, t_ids.expand(n, -1), None,
                                        noise=t_noise.expand(n, *t_noise.shape))
                    r = reward_fn(images.reshape(n * t_ids.shape[0], *images.shape[2:]), t_ids.repeat(n))
                tiles.append({k: v.reshape(n, -1) for k, v in r.items()})
            chunks.append({k: torch.cat([t[k] for t in tiles], dim=1) for k in tiles[0]})
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    return eval_members


def make_population_evaluator(
    generate_p: GenerateFn,
    reward_fn: RewardFn,
    pop_size: int,
    es_cfg: EggRollConfig,
    member_batch: int,
    reward_tile: int = 0,
    pop_fuse: bool = False,
    host_slice: Optional[Tuple[int, int]] = None,
    mesh: Optional[Any] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_pop(theta, noise, ids [B], gen_noise [B, *noise_shape])
    → rewards``, every reward leaf ``[pop_size, B]``; with ``host_slice=(lo,
    n)`` the members ``[lo, lo + n)`` only, every leaf ``[n, B]`` (one
    process's slice of a host-sharded population: member ids and the
    perturbation stay global, against the global ``pop_size``, so each
    member's rewards are the whole population's rows). ``ids`` is an int64
    tensor on the generator's device: nothing here copies from the host, so
    a CUDA graph can capture the evaluation whole.

    Members run in chunks of ``member_batch`` lanes: one chunk's adapter is
    ``factored_member_theta`` over the chunk's members (``pop_fuse``: the
    perturbation stays factored, ``lora.FactoredDelta`` leaves with a lane
    axis when the chunk has several members) or the chunk's materialized
    ``perturb_member`` adapters, lane-stacked. Every base matmul of a chunk
    takes all its lanes' rows at once. A chunk is whole lanes: its
    generate call orders rows lane-major (Sana ``[lane][image]``; VAR and
    Infinity ``[lane][cond|uncond][image]``), and K2 and K3 apply one 2D
    ``w`` a launch to ``lanes`` equal row groups, so a lane is never split
    across chunks or calls. Each member sees the same epoch
    noise ``gen_noise`` (common random numbers). ``reward_tile`` runs
    generate → decode → reward over image tiles of that size (rounded down
    to a divisor of ``B``); image ``i`` keeps its own noise row, so tiling
    does not change a reward. ``sigma``/``c_scale`` (f32 scalar tensors)
    replace ``es_cfg``'s σ in the perturbation (``es.noiser``: the fleet's
    per-job σ as program inputs).

    With ``mesh`` (a ``parallel.mesh.ProcessMesh`` holding this process,
    ``pop`` and ``data`` axes) the slice is split as the JAX mesh splits
    it: the members pad to a multiple of ``n_pop`` (padded members wrap
    within the slice) and the images to a multiple of ``n_data`` (padded
    slots generate prompt 0 at their own global position), and this
    process evaluates its ``lpop`` members on its ``B_pad/n_data`` images,
    each with its global image position's noise row (``gen_noise`` holds
    ``B_pad`` rows or more, :func:`padded_batch`). ``eval_pop`` then returns
    this process's block ``[lpop, B_pad/n_data]`` and ``eval_pop.gather``
    (host side, outside any graph) assembles ``[n, B]``: every process
    calls it with its block."""
    if member_batch < 1:
        raise ValueError(f"member_batch must be >= 1, got {member_batch}")
    slice_lo, slice_n = host_slice if host_slice is not None else (0, pop_size)
    if not (0 <= slice_lo and slice_lo + slice_n <= pop_size and slice_n >= 1):
        raise ValueError(f"host_slice={host_slice} out of range for pop_size={pop_size}")
    n_pop = mesh.shape.get(POP_AXIS, 1) if mesh is not None else 1
    n_data = mesh.shape.get(DATA_AXIS, 1) if mesh is not None else 1
    if n_data > 1 and getattr(generate_p, "ignores_item_index", False):
        raise ValueError(
            "data-axis sharding needs a generator that folds item_index into "
            "its per-image noise keys; this backend's generate() does not "
            "accept item_index, so shard-local positions would silently "
            "change the noise. Use a pop-only mesh for it."
        )
    eval_members = _member_evaluator(generate_p, reward_fn, pop_size, es_cfg, member_batch, reward_tile, pop_fuse)

    def geometry(B_local: int) -> Callable[[], Dict[str, Any]]:
        return lambda: dict(pop=pop_size, member_batch=member_batch, n_pop=n_pop, n_data=n_data,
                            reward_tile=reward_tile, host_slice=list(host_slice) if host_slice is not None else None,
                            pop_fuse=pop_fuse, fused_qlora=True,
                            reward_tile_effective=_note_effective_tile(B_local, reward_tile))

    if n_pop == 1 and n_data == 1:
        def eval_pop(theta, noise, ids, gen_noise, sigma=None, c_scale=None):
            with _trace_time("pop_eval_traces", "trace/pop_eval", {"pop": pop_size, "member_batch": member_batch},
                             geometry(ids.shape[0])):
                members = list(range(slice_lo, slice_lo + slice_n))
                return eval_members(theta, noise, members, ids, gen_noise, sigma, c_scale)

        eval_pop.gather = lambda local, B: {k: v[:slice_n, :B] for k, v in local.items()}
        return eval_pop

    pop_pad = -(-slice_n // n_pop) * n_pop
    lpop = pop_pad // n_pop
    p_idx, d_idx = mesh.index(POP_AXIS), mesh.index(DATA_AXIS)
    # padded members re-evaluate an existing member, wrapping within the slice
    members = [slice_lo + (i % slice_n) for i in range(p_idx * lpop, (p_idx + 1) * lpop)]

    def eval_pop(theta, noise, ids, gen_noise, sigma=None, c_scale=None):
        B = ids.shape[0]
        B_pad = padded_batch(B, n_data)
        if gen_noise.shape[0] < B_pad:
            raise ValueError(f"{gen_noise.shape[0]} noise rows for a batch padded to {B_pad}")
        bl = B_pad // n_data
        with _trace_time("pop_eval_traces", "trace/pop_eval",
                         {"pop": pop_size, "member_batch": member_batch, "n_pop": n_pop, "n_data": n_data},
                         geometry(bl)):
            ids_p = F.pad(ids, (0, B_pad - B))  # padded slots generate prompt 0
            lo = d_idx * bl
            return eval_members(theta, noise, members, ids_p[lo:lo + bl], gen_noise[lo:lo + bl], sigma, c_scale)

    def gather(local: Dict[str, torch.Tensor], B: int) -> Dict[str, torch.Tensor]:
        """This process's block → the slice's rows ``[n, B]``: gathered over
        the data group (image axis), then over the pop group (member axis),
        the padding cut away."""
        rows = all_gather_tree(local, axis=1, group=mesh.group(DATA_AXIS)) if n_data > 1 else local
        if n_pop > 1:
            rows = all_gather_tree(rows, axis=0, group=mesh.group(POP_AXIS))
        return {k: v[:slice_n, :B] for k, v in rows.items()}

    eval_pop.gather = gather
    return eval_pop


def padded_batch(B: int, n_data: int) -> int:
    """The image batch padded to a multiple of the data axis."""
    return -(-B // n_data) * n_data


def make_fleet_evaluator(
    generate_p: GenerateFn,
    reward_fn: RewardFn,
    width: int,
    pop_size: int,
    es_cfg: EggRollConfig,
    member_batch: int,
    reward_tile: int = 0,
    pop_fuse: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_fleet(thetas, noises, ids [W, B], gen_noise [W, B, ...],
    sigmas [W], c_scales [W]) → rewards``, every reward leaf ``[W, pop, B]``:
    ``width`` independent ES jobs against one resident base, job ``j`` with
    its own adapter ``thetas[j]``, noise tree ``noises[j]``, prompts
    ``ids[j]``, generation noise ``gen_noise[j]`` and σ (``sigmas[j]``,
    ``c_scales[j] = f32(σ_j/√r)``, device tensors from
    ``train.trainer.fleet_scalar_args``).

    The member axis is a flat (job, member) lane axis: lane ``i`` is job
    ``i // pop``, member ``i % pop``, and job ``j`` owns lanes
    ``[j·pop, (j+1)·pop)`` (``train.fleet.job_lane_spans``). Lanes run in
    chunks of ``member_batch`` that never cross a job boundary: each job's
    lanes are chunked from its first lane exactly as the solo
    :func:`make_population_evaluator` chunks a population. A chunk's
    adapter is one 2D ``w`` per launch of K2/K3 (``ops.fused_lora`` refuses
    a lane-stacked ``w``), so a chunk spanning two jobs would need a kernel
    that K2/K3 are not. When ``member_batch`` divides ``pop`` this is the
    JAX package's ``lax.map(batch_size=member_batch)`` over ``W·pop`` lanes;
    when it does not, the JAX map's straddling chunk becomes the solo
    chunking of each job, the one departure from it. Either way every job's
    chunks are its solo chunks, so its reward rows are its solo rows."""
    if width < 1 or pop_size < 1:
        raise ValueError(f"width and pop_size must be >= 1, got ({width}, {pop_size})")
    eval_members = _member_evaluator(generate_p, reward_fn, pop_size, es_cfg, member_batch, reward_tile, pop_fuse)
    members = list(range(pop_size))

    def eval_fleet(thetas, noises, ids, gen_noise, sigmas, c_scales):
        if len(thetas) != width or ids.shape[0] != width:
            raise ValueError(f"{len(thetas)} adapters and {ids.shape[0]} prompt rows for a fleet of {width}")
        # fleet_traces is the step's count (train.trainer.make_fleet_step)
        attrs = {"fleet_width": width, "pop": pop_size, "member_batch": member_batch}
        with _trace_time(None, "trace/fleet_eval", attrs,
                         lambda: dict(fleet_width=width, pop=pop_size, member_batch=member_batch, n_pop=1, n_data=1,
                                      reward_tile=reward_tile, pop_fuse=pop_fuse, fused_qlora=True,
                                      reward_tile_effective=_note_effective_tile(ids.shape[1], reward_tile))):
            per_job = [eval_members(thetas[j], noises[j], members, ids[j], gen_noise[j], sigmas[j], c_scales[j])
                       for j in range(width)]
        return {k: torch.stack([r[k] for r in per_job]) for k in per_job[0]}

    return eval_fleet


def make_adapter_batch_generator(
    generate_p: GenerateFn,
    adapter_batch: int,
    images_per_request: int,
    member_batch: int = 0,
) -> Callable[..., torch.Tensor]:
    """``gen_batch(stacked_theta, ids [n, B], keys [n, 2], noise=None,
    guidance_scale=None) → images [n, B, H, W, C]`` for ``n <= adapter_batch``
    lanes, each lane one request with its own adapter and ``utils.threefry``
    key; ``ids`` is an int64 tensor on the generator's device.

    Lanes run in chunks of ``member_batch`` (0 = all lanes in one chunk).
    Inside a chunk every base matmul takes all the chunk's rows at once and
    each lane's LoRA applies to its own rows (``lora.lora_delta``).
    Image ``j`` of a lane draws its noise from (lane key, ``j``) only, the
    JAX package's request-local ``item_index``, so a request gives the same
    image served alone or in any batch."""
    A, B = adapter_batch, images_per_request
    if A < 1 or B < 1:
        raise ValueError(
            f"adapter_batch and images_per_request must be >= 1, got ({adapter_batch}, {images_per_request})"
        )

    def gen_batch(
        stacked_theta: Optional[Any],
        ids: torch.Tensor,
        keys: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        n = ids.shape[0]
        if not 1 <= n <= A or ids.shape[1] != B:
            raise ValueError(f"flat_ids {tuple(ids.shape)} does not fit the ({A}, {B}) serving geometry")
        chunk = min(member_batch, n) if member_batch > 0 else n
        outs = []
        with _trace_time("serve_traces", "trace/serve_batch", {"adapter_batch": A, "images": B},
                         lambda: dict(adapter_batch=A, images_per_request=B, member_batch=member_batch,
                                      fused_qlora=True)):
            for k0 in range(0, n, chunk):
                lanes = slice(k0, min(k0 + chunk, n))
                theta = None if stacked_theta is None else stacked_adapter_theta(stacked_theta, lanes)
                outs.append(generate_p(
                    theta, ids[lanes], keys[lanes],
                    noise=None if noise is None else noise[lanes],
                    guidance_scale=guidance_scale,
                ))
            return torch.cat(outs)

    return gen_batch
