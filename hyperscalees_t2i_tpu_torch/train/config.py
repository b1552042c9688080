"""Training configuration (port of ``hyperscalees_t2i_tpu/train/config.py``:
every field with the JAX package's name, type and default, and the same
``auto_run_name``).

The port's ``run_training`` runs the single-process loop. The fields of
machinery it does not have yet raise there when set away from their
defaults (:func:`unported_settings`, naming the ROADMAP item that brings
each). Three defaults are accepted although nothing reads them yet:
``anomaly_detect`` (the ES-health anomaly watchdog, queue A item 5b),
``log_hist_every`` (θ/Δθ histograms, item 10) and the ``desync_*`` check
(multi-process only, item 7). ``remat``, ``tower_dtype`` and
``base_quant`` are recorded for the checkpoint manifest; the backend's
and reward suite's trees carry the applied values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..es.noiser import EggRollConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # ES core
    num_epochs: int = 100
    pop_size: int = 8
    sigma: float = 0.01
    lr_scale: float = 1.0
    egg_rank: int = 4
    antithetic: bool = True
    promptnorm: bool = True
    # per-epoch plan: m unique prompts × r repeats
    prompts_per_gen: int = 2
    batches_per_gen: int = 1
    member_batch: int = 1  # members evaluated together as lanes
    reward_tile: int = 0  # images per generate→decode→reward tile (0 = all)
    remat: str = "none"
    noise_dtype: str = "float32"  # store dtype of the factored ES noise
    tower_dtype: str = "float32"
    pop_fuse: bool = False  # keep member perturbations factored (K2/K3)
    base_quant: str = "off"
    pop_shard_update: str = "auto"
    steps_per_dispatch: int = 1
    # stabilizers
    theta_max_norm: float = 40.0
    max_step_norm: float = 0.0
    reward_weights: Tuple[float, float, float, float] = (0.3, 0.3, 0.2, 0.2)
    # bookkeeping and observability
    seed: int = 0
    save_every: int = 10
    log_images_every: int = 0
    log_hist_every: int = 10
    profile_epochs: int = 0
    trace: bool = False  # host-side spans → run_dir/trace.jsonl
    metrics_port: int = 0
    metrics_host: str = "0.0.0.0"
    metrics_linger_s: float = 0.0
    slo: Optional[str] = None
    heartbeat_interval_s: float = 0.0
    stall_cap_s: float = 0.0
    stall_action: str = "warn"
    es_degenerate_warn_epochs: int = 5  # DegeneracyWatchdog threshold (0 = off)
    anomaly_detect: bool = True
    anomaly_window: int = 32
    anomaly_min_epochs: int = 8
    anomaly_z: float = 8.0
    quality: bool = True  # per-prompt attribution in the step + quality.jsonl
    quality_hack_window: int = 4
    snapshot_every: int = 0
    run_dir: str = "runs/default"
    resume: bool = True
    run_name: Optional[str] = None
    # fault tolerance
    ckpt_keep: int = 3
    ckpt_legacy_mirror: bool = True
    rollback_policy: str = "sigma_shrink"
    max_rollbacks: int = 3
    rollback_sigma_shrink: float = 0.5
    theta_explode_norm: float = 0.0
    faults: Optional[str] = None
    # multi-process launch and pod resilience
    pop_host_shard: str = "auto"
    desync_check_every: int = 8
    desync_action: str = "rollback"
    on_topology_mismatch: str = "raise"
    elastic_action: str = "checkpoint_exit"

    def es_config(self) -> EggRollConfig:
        return EggRollConfig(sigma=self.sigma, lr_scale=self.lr_scale, rank=self.egg_rank,
                             antithetic=self.antithetic, noise_dtype=self.noise_dtype)

    def auto_run_name(self, backend_name: str) -> str:
        """The run's directory name, from the key hyperparameters."""
        if self.run_name:
            return self.run_name
        return (
            f"{backend_name}_pop{self.pop_size}_sig{self.sigma}_lr{self.lr_scale}"
            f"_r{self.egg_rank}_m{self.prompts_per_gen}x{self.batches_per_gen}"
            f"{'_anti' if self.antithetic else ''}{'_pn' if self.promptnorm else ''}"
        )


# (field, is it set away from what the port runs?, the ROADMAP item that ports it)
_UNPORTED = (
    ("metrics_port", lambda v: v != 0, "queue A item 5b (the trainer's exporter)"),
    ("slo", lambda v: v is not None, "queue A item 5b (the trainer's SLOs)"),
    ("heartbeat_interval_s", lambda v: v != 0, "queue A item 5b (heartbeats)"),
    ("stall_cap_s", lambda v: v != 0, "queue A item 5b (the stall watchdog)"),
    ("faults", lambda v: v is not None, "queue A item 7 (fault injection)"),
    ("pop_host_shard", lambda v: v == "on", "queue A item 7 (host-sharded population)"),
    ("pop_shard_update", lambda v: v == "on", "queue A item 7 (the pop-sharded update)"),
    ("desync_check_every", lambda v: v != 8, "queue A item 7 (the desync check)"),
    ("desync_action", lambda v: v != "rollback", "queue A item 7 (the desync check)"),
    ("on_topology_mismatch", lambda v: v == "reshard", "queue A item 7 (reshard on restore)"),
    ("elastic_action", lambda v: v != "checkpoint_exit", "queue A item 7 (elastic membership)"),
    ("profile_epochs", lambda v: v != 0, "queue A item 10 (the profiler ledger)"),
    ("log_images_every", lambda v: v != 0, "queue A item 10 (member strips)"),
    ("snapshot_every", lambda v: v != 0, "queue A item 10 (quality snapshots)"),
)


def unported_settings(tc: TrainConfig) -> List[str]:
    """``"field=value (ROADMAP item)"`` for every field of ``tc`` that asks
    for machinery the port does not have yet."""
    return [f"{name}={getattr(tc, name)!r} ({item})" for name, off, item in _UNPORTED if off(getattr(tc, name))]
