"""Z-Image backend: few-step flow generation with two evolvable adapters.

Port of ``hyperscalees_t2i_tpu/backends/zimage_backend.py``. θ is the dual
adapter ``{"transformer": LoRA on qkv/attn_proj/fc1/fc2, "vae_decoder":
conv LoRA on conv1/conv2/conv_out}`` (the second only with
``train_vae_decoder_lora``), evolved as one tree. The prompt catalog comes
from an encoded-prompt cache (``utils/prompt_cache``'s Z-Image kind) or,
without one, from a prompt file (``a photo of a cat`` without one) with
synthetic embeddings: 24 positions of ``caption_dim`` standard normals a
prompt, drawn as the JAX package draws them from ``fold_in(PRNGKey(4321),
stable_text_seed(p))``, prompt ``i``'s last ``i % 4`` positions masked out
(the ragged lengths the mask path needs).

Image ``i``'s starting latents are ``normal(fold_in(key, i))`` at its global
position in the batch (:meth:`ZImageBackend.sample_gen_noise`), so neither
member chunks nor reward tiles change an image: an ES epoch draws one
``[B, h, w, C]`` block that every member shares.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..lora import LoRASpec, init_lora
from ..models import sana, vaekl, zimage
from ..ops.quant import quantize_tree
from ..utils import threefry
from ..utils.pytree import tree_leaves_with_path, tree_map
from ..utils.seeding import stable_text_seed
from .base import StepInfo, default_step_info, lane_keys

Params = Dict[str, Any]
SYNTH_TEXT_LEN = 24  # positions of a synthetic prompt embedding
SYNTH_TEXT_SEED = 4321


@dataclasses.dataclass
class ZImageBackendConfig:
    model: zimage.ZImageConfig = dataclasses.field(default_factory=zimage.ZImageConfig)
    vae: vaekl.VAEDecoderConfig = dataclasses.field(default_factory=vaekl.VAEDecoderConfig)
    prompts_txt_path: Optional[str] = None
    encoded_prompt_path: Optional[str] = None
    num_steps: int = 8
    guidance_scale: float = 0.0
    width_latent: int = 16
    height_latent: int = 16
    decode_images: bool = True
    quantize_transformer: bool = False  # the GGUF-equivalent int8 transformer
    lora_r: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = zimage.ZIMAGE_LORA_TARGETS
    train_vae_decoder_lora: bool = False
    vae_lora_r: int = 4
    vae_lora_alpha: float = 8.0
    seed_params: int = 0


def synthetic_text(prompts: Sequence[str], caption_dim: int,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([P, 24, caption_dim] f32, [P, 24] bool)`` on ``device``: prompt
    ``p``'s embedding from ``fold_in(PRNGKey(4321), stable_text_seed(p))``,
    prompt ``i``'s last ``i % 4`` positions masked."""
    seeds = torch.tensor([stable_text_seed(p) for p in prompts], device=device)
    emb = threefry.normal(threefry.fold_in(threefry.prng_key(SYNTH_TEXT_SEED, device), seeds),
                          (SYNTH_TEXT_LEN, caption_dim))
    mask = torch.stack([torch.arange(SYNTH_TEXT_LEN, device=device) < SYNTH_TEXT_LEN - (i % 4)
                        for i in range(len(prompts))])
    return emb, mask


def is_quantized(params: Params) -> bool:
    """True when any node of the tree is an int8 ``kernel_q8`` node."""
    return any("kernel_q8/" in p for p, _ in tree_leaves_with_path(params))


class ZImageBackend:
    """Holds the frozen :class:`~..models.zimage.ZImageTransformer` and
    :class:`~..models.vaekl.KLDecoder` on ``device`` and generates images for
    lane-stacked adapter batches. ``params``/``vae_params`` are trees in the
    JAX package's layout; missing ones are drawn from ``split(PRNGKey(
    cfg.seed_params))`` by :meth:`setup` (the transformer from the first
    key, the decoder from the second). ``quantize_transformer`` quantizes
    the transformer (``ops.quant.quantize_tree``); then ``prepare`` is
    applied to each tree, to a drawn transformer node by node as its
    weights are drawn (where the train CLI applies ``--base_quant``).
    ``prompts`` replaces the prompt file and ``text = (embeds [P, Lt, D],
    mask [P, Lt])`` the catalog's embeddings."""

    # the ES step is a CUDA graph on the card
    cuda_graphs = True

    def __init__(self, cfg: ZImageBackendConfig, device: DeviceLike = None, params: Optional[Params] = None,
                 vae_params: Optional[Params] = None, prompts: Optional[List[str]] = None,
                 text: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 prepare: Optional[Callable[[Params], Params]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = "zimage"
        self._params = params
        self._vae_params = vae_params
        self._prepare = prepare or (lambda tree: tree)
        self.model: Optional[zimage.ZImageTransformer] = None
        self.vae: Optional[vaekl.KLDecoder] = None
        self.param_shapes: Optional[Params] = None
        self.vae_param_shapes: Optional[Params] = None
        self.prompts: List[str] = list(prompts) if prompts is not None else []
        self._given_prompts = prompts is not None
        self.prompt_cache_sha: Optional[str] = None
        self.prompt_embeds: Optional[torch.Tensor] = None  # [P, Lt, caption_dim] f32
        self.prompt_mask: Optional[torch.Tensor] = None  # [P, Lt] bool
        if text is not None:
            self.prompt_embeds = text[0].to(self.device, torch.float32)
            self.prompt_mask = text[1].to(self.device, torch.bool)
        self._spec = LoRASpec(rank=cfg.lora_r, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
        self._vae_spec = LoRASpec(rank=cfg.vae_lora_r, alpha=cfg.vae_lora_alpha,
                                  targets=vaekl.VAE_DECODER_LORA_TARGETS)

    def setup(self) -> None:
        kt, kv = threefry.split(threefry.prng_key(self.cfg.seed_params, self.device))
        meta = lambda tree: tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)  # noqa: E731
        if self.model is None:
            quant = (lambda tree: quantize_tree(tree)) if self.cfg.quantize_transformer else (lambda tree: tree)
            params = self._params
            if params is None:
                params = zimage.init_zimage(self.cfg.model, kt, node_fn=lambda node: self._prepare(quant(node)))
            else:
                # applies to passed-in (real) weights too, the flag's main use
                params = self._prepare(params if is_quantized(params) else quant(params))
            self.param_shapes = meta(params)
            self.model = zimage.ZImageTransformer(self.cfg.model, params).to(self.device)
            self._params = params = None
        if self.vae is None and self.cfg.decode_images:
            vp = self._vae_params
            vp = self._prepare(vaekl.init_decoder(self.cfg.vae, kv) if vp is None else vp)
            self.vae_param_shapes = meta(vp)
            self.vae = vaekl.KLDecoder(self.cfg.vae, vp).to(self.device)
            self._vae_params = vp = None
        if self.prompt_embeds is None:
            self._load_prompts()

    def _load_prompts(self) -> None:
        from ..utils.prompt_cache import load_cache, load_prompts_txt

        path = self.cfg.encoded_prompt_path
        if path and Path(path).exists():
            data = load_cache(path, "zimage")
            self.prompt_cache_sha = data["content_sha256"]
            self.prompts = [str(p) for p in data["prompts"]]
            self.prompt_embeds = torch.as_tensor(data["prompt_embeds"], dtype=torch.float32).to(self.device)
            self.prompt_mask = torch.as_tensor(data["prompt_mask"]).to(self.device, torch.bool)
            return
        prompts = self.prompts if self._given_prompts else ["a photo of a cat"]
        if not self._given_prompts and self.cfg.prompts_txt_path and Path(self.cfg.prompts_txt_path).exists():
            prompts = load_prompts_txt(self.cfg.prompts_txt_path) or prompts
        self.prompts = prompts
        self.prompt_embeds, self.prompt_mask = synthetic_text(prompts, self.cfg.model.caption_dim, self.device)

    # -- protocol ------------------------------------------------------------
    def init_theta(self, key: torch.Tensor) -> Dict[str, Any]:
        """The dual adapter ``{"transformer", "vae_decoder"}`` from ``split(
        key)``'s two keys, identity at init (the reference's two PEFT adapter
        directories as one evolvable tree)."""
        kt, kv = threefry.split(key)
        cpu = torch.device("cpu")
        theta: Dict[str, Any] = {"transformer": init_lora(self.param_shapes, self._spec, kt, device=cpu)}
        if self.cfg.train_vae_decoder_lora and self.vae is not None:
            theta["vae_decoder"] = init_lora(self.vae_param_shapes, self._vae_spec, kv, device=cpu)
        return theta

    @property
    def lora_scale(self) -> float:
        return self._spec.scale

    @property
    def vae_lora_scale(self) -> float:
        return self._vae_spec.scale

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
        """One image's draw: its starting latents ``[h, w, C]``."""
        return (self.cfg.height_latent, self.cfg.width_latent, self.cfg.model.in_channels)

    def sample_gen_noise(self, key: torch.Tensor, item_index: Sequence[int]) -> torch.Tensor:
        """Starting latents ``[..., len(item_index), h, w, C]`` on the key's
        device: image ``i`` from ``fold_in(key, item_index[i])``."""
        return sana.per_image_normal(key, item_index, self.noise_shape)

    def generate_p(
        self,
        stacked_theta: Optional[Params],
        flat_ids: Any,
        keys: Optional[torch.Tensor],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """``[n, b]`` prompt indices with ``n`` lane-stacked dual adapters
        and ``n`` keys ``[n, 2]`` → images ``[n, b, H, W, 3]`` (latents ``[n,
        b, h, w, C]`` without ``decode_images``). Image ``j`` of lane ``i``
        starts from ``keys[i]`` folded with ``j``; ``noise [n, b, h, w, C]``
        replaces the draw. The lanes' adapter may be one ES member chunk:
        ``lora.FactoredDelta`` leaves, laned or not."""
        cfg = self.cfg
        ids = torch.as_tensor(flat_ids, dtype=torch.long, device=self.device)
        n, b = ids.shape
        if noise is None:
            noise = self.sample_gen_noise(lane_keys(keys, n, self.device), range(b))
        noise = noise.reshape(n * b, *self.noise_shape)
        flat = ids.reshape(-1)
        theta = stacked_theta or {}
        latents = zimage.generate_latents(
            self.model, self.prompt_embeds[flat], self.prompt_mask[flat], noise, num_steps=cfg.num_steps,
            guidance_scale=cfg.guidance_scale if guidance_scale is None else guidance_scale,
            lora=theta.get("transformer"), lora_scale=self.lora_scale,
        )
        if not cfg.decode_images:
            return latents.reshape(n, b, *latents.shape[1:])
        images = vaekl.decode(self.vae, latents, lora=theta.get("vae_decoder"), lora_scale=self.vae_lora_scale)
        return images.reshape(n, b, *images.shape[1:])

    def generate(self, theta: Optional[Params], flat_ids: Sequence[int], key: torch.Tensor) -> torch.Tensor:
        """One dual adapter, one request: ``[b]`` prompt indices → ``[b, H,
        W, 3]``."""
        stacked = None if theta is None else tree_map(lambda t: t.to(self.device)[None], theta)
        return self.generate_p(stacked, [list(flat_ids)], key[None])[0]

