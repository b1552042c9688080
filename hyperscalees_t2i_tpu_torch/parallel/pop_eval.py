"""Member-batched evaluation on one device (port of
``hyperscalees_t2i_tpu/parallel/pop_eval.py``): the ES population evaluator,
the fleet evaluator (W jobs' populations against one base) and the
multi-tenant serving generator. The mesh-sharded and ``host_slice``
variants come with multi-GPU training."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..es.noiser import EggRollConfig, factored_member_theta, perturb_member, stacked_adapter_theta
from ..lora import stack_adapters
from ..obs.program_cost import note_program_geometry, repeated

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


def make_population_evaluator(
    generate_p: GenerateFn,
    reward_fn: RewardFn,
    pop_size: int,
    es_cfg: EggRollConfig,
    member_batch: int,
    reward_tile: int = 0,
    pop_fuse: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``eval_pop(theta, noise, ids [B], gen_noise [B, *noise_shape])
    → rewards``, every reward leaf ``[pop_size, B]``. ``ids`` is an int64
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
    per-job σ as program inputs)."""
    if member_batch < 1:
        raise ValueError(f"member_batch must be >= 1, got {member_batch}")
    # the ledger's record of the program this evaluator runs in
    note_program_geometry(member_batch=member_batch, reward_tile=reward_tile, pop_fuse=pop_fuse)

    def chunk_theta(theta, noise, members, sigma, c_scale):
        if pop_fuse:
            return factored_member_theta(theta, noise, members[0] if len(members) == 1 else members,
                                         pop_size, es_cfg, sigma=sigma, c_scale=c_scale)
        thetas = [perturb_member(theta, noise, k, pop_size, es_cfg, sigma=sigma) for k in members]
        return thetas[0] if len(thetas) == 1 else stack_adapters(thetas)

    def eval_pop(theta, noise, ids, gen_noise, sigma=None, c_scale=None):
        B = ids.shape[0]
        tile = effective_reward_tile(B, reward_tile) or B
        chunks = []
        for k0 in range(0, pop_size, member_batch):
            members = list(range(k0, min(k0 + member_batch, pop_size)))
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

    return eval_pop


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
    eval_pop = make_population_evaluator(generate_p, reward_fn, pop_size, es_cfg, member_batch,
                                         reward_tile=reward_tile, pop_fuse=pop_fuse)

    def eval_fleet(thetas, noises, ids, gen_noise, sigmas, c_scales):
        if len(thetas) != width or ids.shape[0] != width:
            raise ValueError(f"{len(thetas)} adapters and {ids.shape[0]} prompt rows for a fleet of {width}")
        per_job = [eval_pop(thetas[j], noises[j], ids[j], gen_noise[j], sigma=sigmas[j], c_scale=c_scales[j])
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
