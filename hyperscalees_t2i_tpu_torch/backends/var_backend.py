"""VAR backend: class-conditional ES over the next-scale AR generator.

Port of ``hyperscalees_t2i_tpu/backends/var_backend.py``. A class pool is
the catalog: catalog item ``i`` is class ``class_pool[i]``, prompted to the
rewards as "a photo of {name}". Names come from a labels file (one per
line), at 1000 classes from the ImageNet list at
``utils.imagenet_labels.DEFAULT_LABELS_PATH``, or fall back to
``class_{i}``; nothing is downloaded.

Generation noise is Gumbel noise ``[L, V]`` per image, drawn from the JAX
package's ``jax.random.categorical`` keys (scale ``si`` of image ``j``:
``fold_in(fold_in(key, si), j)``, ``ops.sampling.per_scale_gumbel``): a
served lane draws it from the request's key, and an ES epoch draws one
``[B, L, V]`` block that every member shares
(:meth:`VarBackend.sample_gen_noise`).

:func:`build_train_backend` builds the backend and the reward suite of the
``ar_d16`` rung (``rungs.var_rung_model``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..lora import LoRASpec, init_lora
from ..models import var as var_mod
from ..ops.sampling import per_scale_gumbel
from ..rungs import rung_opt, var_rung_model
from ..utils import threefry
from ..utils.pytree import cast_floating, resolve_float_dtype, tree_map
from .base import StepInfo, default_step_info, lane_keys

Params = Dict[str, Any]


@dataclasses.dataclass
class VarBackendConfig:
    model: var_mod.VARConfig = dataclasses.field(default_factory=var_mod.VARConfig)
    class_pool: Optional[Tuple[int, ...]] = None  # None → all classes
    labels_path: Optional[str] = None
    cfg_scale: float = 4.0
    top_k: int = 900
    top_p: float = 0.96
    lora_r: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = var_mod.VAR_LORA_TARGETS
    seed_params: int = 0


def load_class_names(num_classes: int, labels_path: Optional[str]) -> List[str]:
    """Class names for the reward prompts, in the JAX package's order:
    ``labels_path`` when it holds at least ``num_classes`` names; at 1000
    classes the ImageNet list at ``utils.imagenet_labels.DEFAULT_LABELS_PATH``
    (a warning where it is missing or malformed); else ``class_{i}``
    placeholders."""
    if labels_path and Path(labels_path).exists():
        names = [l.strip() for l in Path(labels_path).read_text().splitlines() if l.strip()]
        if len(names) >= num_classes:
            return names[:num_classes]
    if num_classes == 1000:
        from ..utils.imagenet_labels import get_imagenet_labels

        try:
            return get_imagenet_labels(labels_path=None)[:num_classes]
        except (RuntimeError, FileNotFoundError) as e:
            print(f"[var] WARNING: {e}; using class_<i> placeholder names", flush=True)
    return [f"class_{i}" for i in range(num_classes)]


class VarBackend:
    """Holds the frozen :class:`~..models.var.VARTransformer` (with its VQ-VAE)
    on ``device`` and generates images for lane-stacked adapter batches.
    ``params`` is a tree in the JAX package's layout; a missing one is drawn
    from ``PRNGKey(cfg.seed_params)`` by :meth:`setup`."""

    def __init__(self, cfg: VarBackendConfig, device: DeviceLike = None, params: Optional[Params] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = "var"
        self._params = params
        self.model: Optional[var_mod.VARTransformer] = None
        self.param_shapes: Optional[Params] = None
        self._spec = LoRASpec(rank=cfg.lora_r, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
        pool = cfg.class_pool or tuple(range(cfg.model.num_classes))
        self.class_pool: Tuple[int, ...] = tuple(int(c) for c in pool)
        names = load_class_names(cfg.model.num_classes, cfg.labels_path)
        self.prompts = [f"a photo of {names[c]}" for c in self.class_pool]
        self._pool = torch.tensor(self.class_pool, dtype=torch.long, device=self.device)

    def setup(self) -> None:
        if self.model is None:
            params = self._params
            if params is None:
                params = var_mod.init_var(self.cfg.model, threefry.prng_key(self.cfg.seed_params, self.device))
            self.param_shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
            self.model = var_mod.VARTransformer(self.cfg.model, params).to(self.device)
            self._params = None

    # -- protocol ------------------------------------------------------------
    def init_theta(self, key: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        return init_lora(self.param_shapes, self._spec, key, device=torch.device("cpu"))

    @property
    def lora_scale(self) -> float:
        return self._spec.scale

    @property
    def num_items(self) -> int:
        return len(self.class_pool)

    @property
    def texts(self) -> List[str]:
        return self.prompts

    def step_info(self, seed: int, num_unique: int, repeats: int) -> StepInfo:
        return default_step_info(seed, self.num_items, num_unique, repeats, self.prompts)

    @property
    def noise_shape(self) -> Tuple[int, int]:
        return (self.cfg.model.seq_len, self.cfg.model.vq.vocab_size)

    def sample_gen_noise(self, key: torch.Tensor, item_index: Sequence[int]) -> torch.Tensor:
        """Sampling noise ``[len(item_index), L, V]`` on the key's device:
        the Gumbel noise of the JAX package's per-scale, per-image keys."""
        return per_scale_gumbel(key, item_index, self.cfg.model.patch_nums, (self.cfg.model.vq.vocab_size,))

    def generate_p(
        self,
        stacked_theta: Optional[Params],
        flat_ids: Any,
        keys: Optional[torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """``[n, b]`` catalog indices with ``n`` lane-stacked adapters and
        ``n`` keys ``[n, 2]`` → images ``[n, b, H, W, 3]``. Image ``j`` of
        lane ``i`` draws its Gumbel noise from ``keys[i]`` and ``j``;
        ``noise [n, b, L, V]`` replaces the draw. ``guidance_scale``
        overrides the CFG scale."""
        cfg = self.cfg
        ids = torch.as_tensor(flat_ids, dtype=torch.long, device=self.device)
        n, b = ids.shape
        if noise is None:
            noise = self.sample_gen_noise(lane_keys(keys, n, self.device), range(b))
        noise = noise.reshape(n, b, *self.noise_shape)
        return var_mod.generate(
            self.model, self._pool[ids], noise,
            cfg_scale=cfg.cfg_scale if guidance_scale is None else guidance_scale,
            top_k=cfg.top_k, top_p=cfg.top_p, lora=stacked_theta, lora_scale=self.lora_scale,
        )

    def generate(self, theta: Optional[Params], flat_ids: Sequence[int], key: torch.Tensor) -> torch.Tensor:
        """One adapter, one request: ``[b]`` catalog indices → ``[b, H, W, 3]``."""
        stacked = None
        if theta is not None:
            stacked = {k: {f: t.to(self.device)[None] for f, t in v.items()} for k, v in theta.items()}
        return self.generate_p(stacked, [list(flat_ids)], key[None])[0]


def build_train_backend(scale: str = "d16", device: DeviceLike = None, seed: int = 0, depth: Optional[int] = None):
    """The VAR backend and the reward suite of the ``ar_d16`` rung, as the
    JAX package's ``bench.py`` and ``train/cli.py`` build them: random
    weights from ``split(PRNGKey(seed))``'s first key on the device (the
    reward suite from its second, ``bench.py``'s ``_build_ar``), the
    transformer's and VQ-VAE's
    float leaves cast to bf16 (``"d16"``; ``"tiny"`` stays f32), a 16-class
    pool (``class_{i}`` names), CLIP-B/32 and the CLIP-H/14 PickScore tower
    at their published widths (``"d16"``) with text tables from random
    token ids, both towers' weights and compute in the rung's
    ``tower_dtype`` (f32). The float base is kept (``RUNG_OPT["ar_d16"]``).
    ``depth`` cuts the transformer to that many blocks, every width kept.
    Returns ``(backend, reward_fn)``."""
    from ..rewards.suite import build_random_reward_suite

    opt = rung_opt("ar_d16")
    dev = resolve_device(device)
    spec = var_rung_model(scale, tower_dtype=opt["tower_dtype"])
    bcfg = spec["bcfg"]
    if depth is not None:
        bcfg = dataclasses.replace(bcfg, model=dataclasses.replace(bcfg.model, depth=int(depth)))
    kt, kc = threefry.split(threefry.prng_key(seed, dev))
    params = cast_floating(var_mod.init_var(bcfg.model, kt), bcfg.model.compute_dtype)
    backend = VarBackend(bcfg, dev, params=params)
    del params
    backend.setup()
    return backend, build_random_reward_suite(spec["clip_b"], spec["clip_h"], backend.num_items, kc,
                                              resolve_float_dtype(opt["tower_dtype"]))
