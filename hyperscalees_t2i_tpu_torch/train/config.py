"""The training configuration fields the ES step reads (port of the
corresponding part of ``hyperscalees_t2i_tpu/train/config.py``; the
training loop's fields come with ``run_training``). The prompt plan
(``prompts_per_gen`` × ``batches_per_gen``) is given to ``make_es_step`` as
``num_unique`` × ``repeats``; the frozen base's storage and the towers'
dtype are the backend's (``build_train_backend``)."""

from __future__ import annotations

import dataclasses
from ..es.noiser import EggRollConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    pop_size: int = 8
    sigma: float = 0.01
    lr_scale: float = 1.0
    egg_rank: int = 4
    antithetic: bool = True
    promptnorm: bool = True
    member_batch: int = 1  # members evaluated together as lanes
    reward_tile: int = 0  # images per generate→decode→reward tile (0 = all)
    noise_dtype: str = "float32"  # store dtype of the factored ES noise
    pop_fuse: bool = False  # keep member perturbations factored (K2/K3)
    theta_max_norm: float = 40.0
    max_step_norm: float = 0.0
    # per-prompt quality attribution needs obs/quality.py, which a later
    # slice ports; make_es_step refuses quality=True until then
    quality: bool = False

    def es_config(self) -> EggRollConfig:
        return EggRollConfig(sigma=self.sigma, lr_scale=self.lr_scale, rank=self.egg_rank,
                             antithetic=self.antithetic, noise_dtype=self.noise_dtype)
