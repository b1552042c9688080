"""Sana one-step backend: prompt catalog, frozen DiT + DC-AE, adapter batches.

Port of ``hyperscalees_t2i_tpu/backends/sana_backend.py`` (one-step mode).
Every draw is the JAX package's (``utils.threefry`` keys): the frozen
weights from ``PRNGKey(seed_params)``, each prompt's embedding from
``fold_in(PRNGKey(1234), stable_text_seed(prompt))``, image ``i``'s latent
noise from ``fold_in(key, i)``. Loading an encoded-prompt cache is not
ported yet.

:func:`build_serve_backend` builds the serving backend;
:func:`build_train_backend` the backend and the reward suite of one ES rung,
in the order the JAX package's ``bench.py`` builds them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..lora import LoRASpec, init_lora
from ..models import dcae, sana
from ..ops.quant import maybe_quantize_tree
from ..rungs import BENCH_PROMPT_SET, PROMPT_EMBED_LEN, rung_opt, sana_rung_model
from ..utils import threefry
from ..utils.pytree import cast_floating, resolve_float_dtype, tree_map
from ..utils.seeding import stable_text_seed
from .base import StepInfo, default_step_info, lane_keys

Params = Dict[str, Any]
PROMPT_EMBED_SEED = 1234


@dataclasses.dataclass
class SanaBackendConfig:
    model: sana.SanaConfig = dataclasses.field(default_factory=sana.SanaConfig)
    vae: dcae.DCAEConfig = dataclasses.field(default_factory=dcae.DCAEConfig)
    guidance_scale: float = 1.0
    width_latent: int = 32
    height_latent: int = 32
    lora_r: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = sana.SANA_LORA_TARGETS
    seed_params: int = 0
    prompt_embed_len: int = PROMPT_EMBED_LEN


class SanaBackend:
    """Holds the frozen :class:`~..models.sana.SanaTransformer` and
    :class:`~..models.dcae.DCAEDecoder` on ``device`` and generates images
    for lane-stacked adapter batches.

    ``params``/``vae_params`` are parameter trees in the JAX package's layout
    (float or int8 nodes); missing ones are drawn from
    ``split(PRNGKey(cfg.seed_params))`` by :meth:`setup`, which also builds
    the modules."""

    def __init__(
        self,
        cfg: SanaBackendConfig,
        device: DeviceLike = None,
        params: Optional[Params] = None,
        vae_params: Optional[Params] = None,
        prompts: Optional[Sequence[str]] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = "sana_one_step"
        self._params = params
        self._vae_params = vae_params
        self.prompts: List[str] = list(prompts) if prompts else []
        self.model: Optional[sana.SanaTransformer] = None
        self.vae: Optional[dcae.DCAEDecoder] = None
        self.param_shapes: Optional[Params] = None
        self.prompt_embeds: Optional[torch.Tensor] = None  # [P, Ltxt, caption_dim] f32
        self.prompt_mask: Optional[torch.Tensor] = None  # [P, Ltxt] bool
        self._spec = LoRASpec(rank=cfg.lora_r, alpha=cfg.lora_alpha, targets=cfg.lora_targets)

    # -- setup ---------------------------------------------------------------
    def setup(self) -> None:
        kt, kv = threefry.split(threefry.prng_key(self.cfg.seed_params, self.device))
        if self.model is None:
            params = self._params
            if params is None:
                params = sana.init_sana(self.cfg.model, kt)
            # meta tensors: the tree's structure and shapes, for init_lora
            self.param_shapes = tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params
            )
            self.model = sana.SanaTransformer(self.cfg.model, params).to(self.device)
            self._params = None
        if self.vae is None:
            vp = self._vae_params
            if vp is None:
                vp = dcae.init_decoder(self.cfg.vae, kv)
            self.vae = dcae.DCAEDecoder(self.cfg.vae, vp).to(self.device)
            self._vae_params = None
        if self.prompt_embeds is None:
            self._synthesize_prompts()

    def _synthesize_prompts(self) -> None:
        """Deterministic placeholder embeddings, prompt ``p`` drawn from
        ``fold_in(PRNGKey(1234), stable_text_seed(p))`` as in the JAX package
        (a real deployment loads encoded prompts)."""
        self.prompts = self.prompts or ["a photo of a cat"]
        L, D = self.cfg.prompt_embed_len, self.cfg.model.caption_dim
        text_seeds = torch.tensor([stable_text_seed(p) for p in self.prompts], device=self.device)
        keys = threefry.fold_in(threefry.prng_key(PROMPT_EMBED_SEED, self.device), text_seeds)
        self.prompt_embeds = threefry.normal(keys, (L, D))
        self.prompt_mask = torch.ones((len(self.prompts), L), dtype=torch.bool, device=self.device)

    def set_prompt_embeds(self, embeds: torch.Tensor) -> None:
        """Given embeddings ``[prompts, Ltxt, caption_dim]`` (all positions
        valid) in place of the synthesized ones."""
        self.prompt_embeds = embeds.to(self.device, torch.float32)
        self.prompt_mask = torch.ones(embeds.shape[:2], dtype=torch.bool, device=self.device)

    # -- protocol ------------------------------------------------------------
    def init_theta(self, key: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        return init_lora(self.param_shapes, self._spec, key, device=torch.device("cpu"))

    @property
    def lora_scale(self) -> float:
        return self._spec.scale

    @property
    def num_items(self) -> int:
        return len(self.prompts)

    @property
    def texts(self) -> List[str]:
        return self.prompts

    def step_info(self, seed: int, num_unique: int, repeats: int) -> StepInfo:
        return default_step_info(seed, self.num_items, num_unique, repeats, self.prompts)

    @property
    def noise_shape(self) -> Tuple[int, int, int]:
        return (self.cfg.height_latent, self.cfg.width_latent, self.cfg.model.in_channels)

    def sample_gen_noise(self, key: torch.Tensor, item_index: Sequence[int]) -> torch.Tensor:
        """Latent noise ``[len(item_index), h, w, C]`` on the key's device,
        image ``i`` from ``fold_in(key, item_index[i])``."""
        return sana.per_image_normal(key, item_index, self.noise_shape)

    def generate_p(
        self,
        stacked_theta: Optional[Params],
        flat_ids: Any,
        keys: Optional[torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """``[n, b]`` prompt indices with ``n`` lane-stacked adapters and ``n``
        keys ``[n, 2]`` → images ``[n, b, H, W, 3]``. Image ``j`` of lane ``i``
        draws its noise from ``fold_in(keys[i], j)``; ``noise [n, b, h, w,
        C]`` replaces the draw (ES training shares one epoch noise across
        members). The lanes' adapter may also be one ES member chunk:
        ``lora.FactoredDelta`` leaves, laned or not."""
        cfg = self.cfg
        ids = torch.as_tensor(flat_ids, dtype=torch.long, device=self.device)
        n, b = ids.shape
        hw = (cfg.height_latent, cfg.width_latent)
        shape = self.noise_shape
        if noise is None:
            noise = self.sample_gen_noise(lane_keys(keys, n, self.device), range(b))
        noise = noise.reshape(n * b, *shape)
        flat = ids.reshape(-1)
        latents = sana.one_step_generate(
            self.model, self.prompt_embeds[flat], self.prompt_mask[flat],
            guidance_scale=cfg.guidance_scale if guidance_scale is None else guidance_scale,
            latent_hw=hw, lora=stacked_theta, lora_scale=self.lora_scale, noise=noise,
        )
        images = dcae.decode(self.vae, latents / cfg.vae.scaling_factor)
        return images.reshape(n, b, *images.shape[1:])

    def generate(self, theta: Optional[Params], flat_ids: Sequence[int], key: torch.Tensor) -> torch.Tensor:
        """One adapter, one request: ``[b]`` prompt indices → ``[b, H, W, 3]``."""
        stacked = None
        if theta is not None:
            stacked = {k: {f: t.to(self.device)[None] for f, t in v.items()} for k, v in theta.items()}
        return self.generate_p(stacked, [list(flat_ids)], key[None])[0]


def build_serve_backend(
    bcfg: SanaBackendConfig,
    base_quant: str,
    device: DeviceLike = None,
    prompts: Optional[Sequence[str]] = None,
    param_dtype: Any = "bfloat16",
    seed: int = 0,
) -> SanaBackend:
    """The serving backend as the JAX package's ``bench.py`` builds it
    (``_build_serve_backend``): ``split(PRNGKey(seed), 3)`` into the DiT's,
    the DC-AE decoder's and the prompt embeddings' keys (one normal draw
    ``[prompts, PROMPT_EMBED_LEN, caption_dim]``; prompts default to
    ``BENCH_PROMPT_SET``), every float leaf cast to ``param_dtype``, then
    the ``base_quant`` knob (``"int8"`` quantizes every kernel of at least
    ``ops.quant.DEFAULT_MIN_SIZE`` elements)."""
    dev = resolve_device(device)
    prompts = list(prompts) if prompts else list(BENCH_PROMPT_SET)
    kt, kv, ke = threefry.split(threefry.prng_key(seed, dev), 3)
    dtype = resolve_float_dtype(param_dtype)
    params = maybe_quantize_tree(cast_floating(sana.init_sana(bcfg.model, kt), dtype), base_quant)
    vae = maybe_quantize_tree(cast_floating(dcae.init_decoder(bcfg.vae, kv), dtype), base_quant)
    backend = SanaBackend(bcfg, dev, params=params, vae_params=vae, prompts=prompts)
    backend.set_prompt_embeds(threefry.normal(ke, (len(prompts), bcfg.prompt_embed_len, bcfg.model.caption_dim)))
    backend.setup()
    return backend


def build_train_backend(scale: str, device: DeviceLike = None, base_quant: Optional[str] = None, seed: int = 0):
    """The generator backend and the reward suite of one ES rung, built as
    the JAX package's ``bench.py`` builds them over ``BENCH_PROMPT_SET``:
    the generator from ``PRNGKey(seed)`` (split three ways into the DiT,
    the DC-AE decoder and the prompt embeddings), float leaves cast to
    bf16; the reward suite from ``PRNGKey(seed + 1)``
    (``rewards.suite.build_random_reward_suite``: the CLIP text tables from
    random token ids while the towers are still float, the towers in the
    rung's ``tower_dtype``); then the ``base_quant`` knob on the DiT, the
    DC-AE decoder and both CLIP trees. ``base_quant`` defaults to the rung's
    ``RUNG_OPT``; ``"off"`` keeps a float base, whose adapted sites run K2
    instead of K3. Returns ``(backend, reward_fn)``."""
    from ..rewards.suite import build_random_reward_suite

    opt = rung_opt(scale)
    base_quant = opt["base_quant"] if base_quant is None else base_quant
    dev = resolve_device(device)
    spec = sana_rung_model(scale, tower_dtype=opt["tower_dtype"])
    bcfg = spec["bcfg"]
    dtype = torch.bfloat16
    prompts = list(BENCH_PROMPT_SET)

    kt, kv, ke = threefry.split(threefry.prng_key(seed, dev), 3)
    params = cast_floating(sana.init_sana(bcfg.model, kt), dtype)
    vae = cast_floating(dcae.init_decoder(bcfg.vae, kv), dtype)
    reward = build_random_reward_suite(spec["clip_b"], spec["clip_h"], len(prompts),
                                       threefry.prng_key(seed + 1, dev), dtype, base_quant)
    backend = SanaBackend(bcfg, dev, params=maybe_quantize_tree(params, base_quant),
                          vae_params=maybe_quantize_tree(vae, base_quant), prompts=prompts)
    del params, vae
    backend.set_prompt_embeds(threefry.normal(ke, (len(prompts), bcfg.prompt_embed_len, bcfg.model.caption_dim)))
    backend.setup()
    return backend, reward
