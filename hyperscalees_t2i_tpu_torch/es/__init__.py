"""EGGROLL-ES: noise, member perturbations, update, fitness shaping, caps,
prompt sampling."""

from .caps import cap_step_norm, cap_theta_norm, global_norm
from .noiser import (
    DenseNoise,
    EggRollConfig,
    LowRankNoise,
    apply_es_delta,
    base_pop_size,
    es_partial_delta,
    es_update,
    factored_member_theta,
    fitness_coeffs,
    lane_slice,
    materialize_member_eps,
    member_maps,
    member_signs_and_bases,
    perturb_member,
    sample_noise,
    stacked_adapter_theta,
)
from .sampling import epoch_key, mix_seed, parse_int_list, repeat_batches, sample_indices_unique
from .scoring import (
    jobwise_prompt_normalized_scores,
    prompt_normalized_scores,
    standardize_fitness,
    standardize_fitness_masked,
)

__all__ = [
    "DenseNoise", "EggRollConfig", "LowRankNoise", "apply_es_delta", "base_pop_size", "cap_step_norm", "cap_theta_norm",
    "epoch_key", "es_partial_delta", "es_update", "factored_member_theta", "fitness_coeffs", "global_norm",
    "jobwise_prompt_normalized_scores", "lane_slice",
    "materialize_member_eps", "member_maps", "member_signs_and_bases", "mix_seed", "parse_int_list", "perturb_member",
    "prompt_normalized_scores", "repeat_batches", "sample_indices_unique", "sample_noise",
    "stacked_adapter_theta", "standardize_fitness", "standardize_fitness_masked",
]
