"""The EGGROLL-ES epoch step (port of ``_combine_and_update`` and
``make_es_step`` from ``hyperscalees_t2i_tpu/train/trainer.py``).

One step: draw the factored ES noise and the epoch's generation noise,
evaluate every member (perturb → generate → decode → reward, in chunks of
``member_batch``), build the ``[pop, B]`` reward rows, then promptnorm,
masked standardization, the EGGROLL update, the step cap and the θ cap.
Every member shares the epoch's generation noise (common random numbers).

Seeds: the JAX package splits the epoch key into a noise key and a
generation key. The port derives two integer seeds from the step's
``seed`` with ``es.sampling.mix_seed`` (``mix_seed(seed, 1, 0)`` for the ES
noise, ``mix_seed(seed, 2, 0)`` for the generation noise) and draws each
from its own ``torch.Generator`` on the step's device. The draws are not
``jax.random``'s; ``noise=``/``gen_noise=`` take given draws instead.

ES needs no gradient: the step runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import DeviceLike, generator_for, resolve_device
from ..es.caps import cap_step_norm, cap_theta_norm, global_norm
from ..es.noiser import es_update, sample_noise
from ..es.sampling import mix_seed
from ..es.scoring import prompt_normalized_scores, standardize_fitness_masked
from ..obs.es_health import es_health_metrics
from ..parallel.pop_eval import make_population_evaluator
from ..utils.pytree import tree_leaves, tree_map, tree_replace_leaves
from .config import TrainConfig

REWARD_KEYS = ("clip_aesthetic", "clip_text", "no_artifacts", "pickscore", "combined")


def _combine_and_update(theta: Any, prev_delta: Any, noise: Any, rewards: Dict[str, torch.Tensor], *,
                        tc: TrainConfig, es_cfg, pop: int, num_unique: int, repeats: int):
    """Rewards → scores → fitness → EGGROLL update → caps → metrics.
    Returns ``(θ', Δθ, metrics, opt_scores)``."""
    # S[k, j]: mean over repeats (grouped layout [r][m])
    S = rewards["combined"].reshape(pop, repeats, num_unique).mean(dim=1)
    if tc.promptnorm:
        opt_scores, _, sigma_bar = prompt_normalized_scores(S)
    else:
        opt_scores = S.mean(dim=1)
        sigma_bar = torch.zeros((), device=S.device)
    fitness, n_finite = standardize_fitness_masked(opt_scores)
    theta_new = es_update(theta, noise, fitness, pop, es_cfg)
    theta_new, step_scale = cap_step_norm(theta, theta_new, tc.max_step_norm)
    theta_new, theta_scale = cap_theta_norm(theta_new, tc.theta_max_norm)
    delta = tree_replace_leaves(theta, [a - b for a, b in zip(tree_leaves(theta_new), tree_leaves(theta))])
    metrics = {
        "opt_score_mean": opt_scores.mean(),
        "opt_score_best": opt_scores.max(),
        "opt_score_worst": opt_scores.min(),
        "sigma_bar": sigma_bar,
        "n_finite": n_finite,
        "theta_norm": global_norm(theta_new),
        "delta_norm": global_norm(delta),
    }
    metrics.update(es_health_metrics(
        opt_scores=opt_scores, fitness=fitness, delta=delta, prev_delta=prev_delta,
        cap_theta_scale=theta_scale, cap_step_scale=step_scale, pop_size=pop, antithetic=es_cfg.antithetic,
    ))
    for k in REWARD_KEYS:
        if k in rewards:
            metrics[f"reward/{k}_mean"] = rewards[k].mean()
    metrics["per_prompt_mean"] = S.mean(dim=0)
    return theta_new, delta, metrics, opt_scores


def make_es_step(backend: Any, reward_fn: Any, tc: TrainConfig, num_unique: int, repeats: int,
                 device: DeviceLike = None, *, stateful_delta: bool = False):
    """Build the epoch step for a fixed (m prompts, r repeats) plan.

    Returns ``step(theta, flat_ids [m·r], seed, noise=None, gen_noise=None)
    → (θ', metrics, opt_scores)``; with ``stateful_delta=True``,
    ``step(theta, prev_delta, flat_ids, seed, ...) → (θ', Δθ, metrics,
    opt_scores)``, which feeds ``es/update_cosine``. ``metrics`` is the JAX
    package's dict without ``quality/*``, as tensors on the device.

    ``device`` must be the backend's device; ``None`` means the card and
    raises without one. ``noise`` (a tree from ``es.sample_noise``'s
    structure) and ``gen_noise`` (``[m·r, *backend.noise_shape]``) replace
    the step's own draws."""
    if tc.quality:
        raise NotImplementedError(
            "quality=True needs the per-prompt quality attribution of obs/quality.py, which a "
            "later slice of the port brings with the training loop; pass quality=False"
        )
    dev = resolve_device(device)
    if dev != backend.device:
        raise ValueError(f"make_es_step on {dev}, but the backend lives on {backend.device}")
    es_cfg = tc.es_config()
    pop = tc.pop_size
    eval_pop = make_population_evaluator(backend.generate_p, reward_fn, pop, es_cfg, tc.member_batch,
                                         reward_tile=tc.reward_tile, pop_fuse=tc.pop_fuse)

    def core(theta, prev_delta, flat_ids, seed: int, noise=None, gen_noise=None):
        ids = torch.as_tensor(flat_ids, dtype=torch.long)
        if ids.numel() != num_unique * repeats:
            raise ValueError(f"{ids.numel()} prompt ids for a plan of {num_unique}×{repeats}")
        to_dev = lambda t: t.to(dev)  # noqa: E731
        with torch.inference_mode():
            theta = tree_map(to_dev, theta)
            prev_delta = tree_map(to_dev, prev_delta)
            if noise is None:
                noise = sample_noise(generator_for(dev, mix_seed(seed, 1, 0)), theta, pop, es_cfg)
            else:
                noise = tree_map(to_dev, noise)
            if gen_noise is None:
                gen_noise = backend.sample_gen_noise(generator_for(dev, mix_seed(seed, 2, 0)), ids.numel())
            rewards = eval_pop(theta, noise, ids, gen_noise.to(dev, torch.float32))
            return _combine_and_update(theta, prev_delta, noise, rewards, tc=tc, es_cfg=es_cfg,
                                       pop=pop, num_unique=num_unique, repeats=repeats)

    if stateful_delta:
        return core

    def step(theta, flat_ids, seed: int, noise=None, gen_noise=None):
        zeros = tree_map(torch.zeros_like, theta)
        theta_new, _delta, metrics, opt_scores = core(theta, zeros, flat_ids, seed, noise, gen_noise)
        return theta_new, metrics, opt_scores

    return step

