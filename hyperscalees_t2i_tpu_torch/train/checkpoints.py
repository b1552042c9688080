"""Checkpoints of a training run and the PEFT adapter export (port of
``hyperscalees_t2i_tpu/train/checkpoints.py``).

The ES optimizer's state is (θ, epoch), since every draw derives from the
epoch. :func:`save_checkpoint` commits a versioned slot
(``resilience.checkpoints.CheckpointStore``) and, by default, the legacy
single-slot mirror ``latest_theta.npz`` + ``latest_meta.json`` (each file
tmp → ``os.replace``). :func:`load_checkpoint` restores the newest valid
slot, else the mirror. The files are the JAX package's.
:func:`export_peft_adapter` writes θ as a PEFT adapter directory
(``adapter_model.safetensors`` through ``weights.io.save_safetensors``,
``adapter_config.json``).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..resilience.checkpoints import CheckpointStore, load_validated
from ..resilience.retry import call_with_retry
from ..utils.pytree import flatten_with_paths

_THETA_FILE = "latest_theta.npz"
_META_FILE = "latest_meta.json"


def save_checkpoint(run_dir: Path, theta: Any, epoch: int, summary_reward: float, backend_name: str,
                    config: Optional[Dict[str, Any]] = None, *, prev_delta: Optional[Any] = None, keep: int = 3,
                    legacy_mirror: bool = True, topology: Optional[Dict[str, Any]] = None,
                    registry: Optional[Any] = None) -> None:
    """A durable slot (θ, Δθ_{t−1} when given, the manifest) plus, with
    ``legacy_mirror``, the single-slot mirror."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    CheckpointStore(run_dir, keep=keep, registry=registry).save(
        theta, epoch, prev_delta=prev_delta, summary_reward=summary_reward, backend_name=backend_name,
        config=config, topology=topology)
    if legacy_mirror:
        write_legacy_mirror(run_dir, theta, epoch, summary_reward=summary_reward, backend_name=backend_name,
                            config=config, registry=registry)


def write_legacy_mirror(run_dir: Path, theta: Any, epoch: int, *, summary_reward: float = 0.0,
                        backend_name: str = "", config: Optional[Dict[str, Any]] = None,
                        registry: Optional[Any] = None) -> None:
    """``latest_theta.npz`` and ``latest_meta.json``, each written to a tmp
    file and renamed."""
    run_dir = Path(run_dir)

    def write() -> None:
        tmp = run_dir / (_THETA_FILE + ".tmp.npz")
        np.savez(tmp, **flatten_with_paths(theta))
        tmp.replace(run_dir / _THETA_FILE)
        meta = {"epoch": int(epoch), "summary_mean_reward": float(summary_reward), "backend": backend_name,
                "config": config or {}}
        meta_tmp = run_dir / (_META_FILE + ".tmp")
        meta_tmp.write_text(json.dumps(meta, indent=2))
        os.replace(meta_tmp, run_dir / _META_FILE)

    call_with_retry(write, site="ckpt_write", registry=registry)


def load_checkpoint(run_dir: Path, theta_template: Any) -> Optional[Tuple[Any, int]]:
    """(θ, epoch) from the newest valid slot, else from the legacy mirror."""
    run_dir = Path(run_dir)
    restored = CheckpointStore(run_dir).restore(theta_template)
    if restored is not None:
        return restored.theta, restored.epoch
    return load_legacy_checkpoint(run_dir, theta_template)


def load_legacy_checkpoint(run_dir: Path, theta_template: Any,
                           registry: Optional[Any] = None) -> Optional[Tuple[Any, int]]:
    """(θ, epoch) from the legacy mirror only; a mirror that does not fit
    the template is rejected (logged, ``restore_rejected``) and gives
    ``None``."""
    run_dir = Path(run_dir)
    theta_path, meta_path = run_dir / _THETA_FILE, run_dir / _META_FILE
    if not theta_path.exists() or not meta_path.exists():
        return None
    try:
        theta = load_validated(theta_path, theta_template, "legacy theta")
    except ValueError as e:
        if registry is not None:
            registry.inc("restore_rejected")
        print(f"[resilience] RESTORE: rejecting legacy checkpoint: {e}", file=sys.stderr, flush=True)
        return None
    return theta, int(json.loads(meta_path.read_text())["epoch"])


def _host_f32(t: Any) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as f32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def export_peft_adapter(
    out_dir: Path,
    theta: Any,
    rank: int,
    alpha: float,
    module_name_fn: Callable[[str, Optional[int]], str],
    target_modules: Optional[List[str]] = None,
) -> None:
    """Write a PEFT-layout adapter directory from the flat LoRA tree.

    ``theta`` is ``{path: {"a": [.., din, r], "b": [.., r, dout]}}``; 3-D
    stacked factors are split per layer. ``module_name_fn(path, layer)``
    maps a kernel path (and layer index, or None) to the torch module name,
    e.g. ``blocks/attn1/to_q`` at layer 3 → ``transformer_blocks.3.attn1.to_q``.
    A nested multi-adapter θ (``{"transformer": {...}, "vae_decoder":
    {...}}``) is written as one directory per sub-adapter.

    PEFT conventions: ``lora_A.weight [r, d_in]`` (aᵀ), ``lora_B.weight
    [d_out, r]`` (bᵀ), delta = B @ A · alpha/r, the forward of ``lora.py``;
    conv factors ``a [kh, kw, cin, r]``, ``b [r, cout]`` become ``lora_A
    [r, cin, kh, kw]`` and ``lora_B [cout, r, 1, 1]``. Tensors are f32."""
    from ..weights.io import save_safetensors

    if theta and all(isinstance(v, dict) and "a" not in v for v in theta.values()):
        for sub, subtree in theta.items():
            export_peft_adapter(Path(out_dir) / sub, subtree, rank, alpha, module_name_fn, target_modules)
        return

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    state: Dict[str, np.ndarray] = {}
    modules = set()

    def put(name: str, a: np.ndarray, b: np.ndarray) -> None:
        modules.add(name.rsplit(".", 1)[-1])
        if a.ndim == 4:
            A = a.transpose(3, 2, 0, 1).copy()
            B = b.T.copy()[:, :, None, None]
        else:
            A = a.T.copy()
            B = b.T.copy()
        state[f"base_model.model.{name}.lora_A.weight"] = A
        state[f"base_model.model.{name}.lora_B.weight"] = B

    for path, leaf in theta.items():
        a, b = _host_f32(leaf["a"]), _host_f32(leaf["b"])
        if a.ndim == 3:  # stacked per-layer dense factors
            for i in range(a.shape[0]):
                put(module_name_fn(path, i), a[i], b[i])
        else:
            put(module_name_fn(path, None), a, b)
    save_safetensors(out_dir / "adapter_model.safetensors", state)
    adapter_cfg = {
        "peft_type": "LORA",
        "r": int(rank),
        "lora_alpha": float(alpha),
        "lora_dropout": 0.0,
        "target_modules": sorted(target_modules or modules),
        "bias": "none",
        "task_type": None,
    }
    (out_dir / "adapter_config.json").write_text(json.dumps(adapter_cfg, indent=2))
