"""Infinity backend: text-conditional bitwise AR ES over the BSQ pyramid.

Port of ``hyperscalees_t2i_tpu/backends/infinity_backend.py``. The prompt
catalog comes from an encoded-prompt cache (``utils/prompt_cache``'s
Infinity kind) or, without one, from a prompt file (``a photo of a cat``
without one) with hash-fallback text features: 16 positions of
``text_dim`` standard-normal features a prompt, drawn as the JAX package
draws them from ``fold_in(PRNGKey(777), stable_text_seed(p))``, and prompt
``i``'s last ``i % 3`` positions masked out.

Generation noise is Gumbel noise ``[L, bits, 2]`` per image, from the JAX
package's per-scale ``jax.random.categorical`` keys
(``ops.sampling.per_scale_gumbel``): a served lane draws it from the
request's key, and an ES epoch draws one ``[B, L, bits, 2]`` block that
every member shares (:meth:`InfinityBackend.sample_gen_noise`).

The backend owns the KV cache of its generate calls: one workspace per row
count, allocated at the first call with that many rows and zeroed by every
call (``models.infinity.generate``'s ``workspace``). A CUDA graph of the ES
step then reads it as a static input outside the graph's private pool, and
the graph's eager warm-up and its capture share it (at Infinity-2B's 8 rows
it is 19.8 GB).

:func:`build_train_backend` builds the backend and the reward suite of the
``inf_2b`` rung (``rungs.infinity_rung_model``), on a float or an int8 base.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..lora import LoRASpec, init_lora
from ..models import bsq, infinity as inf_mod
from ..ops.quant import maybe_quantize_tree
from ..ops.sampling import per_scale_gumbel
from ..rungs import BENCH_PROMPT_SET, infinity_rung_model, rung_opt
from ..utils import threefry
from ..utils.pytree import cast_floating, resolve_float_dtype, tree_map
from ..utils.seeding import stable_text_seed
from .base import StepInfo, default_step_info, lane_keys

Params = Dict[str, Any]
HASH_TEXT_LEN = 16  # positions of a hash-fallback prompt
HASH_TEXT_SEED = 777


@dataclasses.dataclass
class InfinityBackendConfig:
    model: inf_mod.InfinityConfig = dataclasses.field(default_factory=inf_mod.InfinityConfig)
    prompts_txt_path: Optional[str] = None
    encoded_prompt_path: Optional[str] = None
    vae_weights: Optional[str] = None  # the BSQ tokenizer's checkpoint (weights.infinity.load_bsq_vae)
    # append the face-quality suffix to person prompts (hash-fallback
    # prompts only: an encoded cache is used as it was encoded)
    enable_positive_prompt: bool = False
    cfg_list: Optional[Tuple[float, ...]] = None  # per-scale guidance schedule
    tau_list: Optional[Tuple[float, ...]] = None  # per-scale temperature
    lora_r: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = inf_mod.INFINITY_LORA_TARGETS
    seed_params: int = 0


def hash_text_features(prompts: Sequence[str], text_dim: int,
                       device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([P, 16, text_dim] f32, [P, 16] bool)`` on ``device``: prompt
    ``p``'s features from ``fold_in(PRNGKey(777), stable_text_seed(p))``,
    prompt ``i``'s last ``i % 3`` positions masked."""
    seeds = torch.tensor([stable_text_seed(p) for p in prompts], device=device)
    emb = threefry.normal(threefry.fold_in(threefry.prng_key(HASH_TEXT_SEED, device), seeds), (HASH_TEXT_LEN, text_dim))
    mask = torch.stack([torch.arange(HASH_TEXT_LEN, device=device) < HASH_TEXT_LEN - (i % 3)
                        for i in range(len(prompts))])
    return emb, mask


class InfinityBackend:
    """Holds the frozen :class:`~..models.infinity.InfinityTransformer` (with
    its BSQ tokenizer) and the prompt catalog's text features on
    ``device``, and generates images for lane-stacked adapter batches.
    ``params`` is a tree in the JAX package's layout; a missing one is drawn
    from ``PRNGKey(cfg.seed_params)`` by :meth:`setup`. ``cfg.vae_weights``
    replaces the tree's ``"vq"`` with the converted tokenizer checkpoint
    (over a random one and over one the tree carries, as in the JAX
    package), and a tree without ``"vq"`` otherwise gets a random tokenizer
    from the same key. ``prepare(tree)``, applied to the whole tree before
    the modules are built, is where the train CLI casts it and applies
    ``--base_quant``. ``prompts`` replaces the prompt file and
    ``text = (text_emb [P, Lt, text_dim], text_mask [P, Lt])`` the
    catalog's features (the tests carry the JAX package's across)."""

    # the ES step is a CUDA graph on the card; the KV cache lives outside its
    # pool, in the backend's workspace
    cuda_graphs = True

    def __init__(self, cfg: InfinityBackendConfig, device: DeviceLike = None, params: Optional[Params] = None,
                 prompts: Optional[List[str]] = None, text: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 prepare: Optional[Callable[[Params], Params]] = None):
        self.cfg = cfg
        self._prepare = prepare
        self.device = resolve_device(device)
        self.name = "infinity"
        self._params = params
        self.model: Optional[inf_mod.InfinityTransformer] = None
        self.param_shapes: Optional[Params] = None
        self.prompts: List[str] = list(prompts) if prompts is not None else []
        self._given_prompts = prompts is not None
        self.prompt_cache_sha: Optional[str] = None
        self.text_emb: Optional[torch.Tensor] = None
        self.text_mask: Optional[torch.Tensor] = None
        if text is not None:
            self.text_emb = text[0].to(self.device, torch.float32)
            self.text_mask = text[1].to(self.device, torch.bool)
        self._spec = LoRASpec(rank=cfg.lora_r, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
        self._workspaces: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def setup(self) -> None:
        if self.model is None:
            params = self._params
            key = threefry.prng_key(self.cfg.seed_params, self.device)
            if params is None:
                params = inf_mod.init_infinity(self.cfg.model, key)
            if self.cfg.vae_weights:
                from ..weights.from_jax import tree_from_numpy
                from ..weights.infinity import load_bsq_vae

                params = dict(params, vq=tree_from_numpy(load_bsq_vae(self.cfg.vae_weights, self.cfg.model.vq),
                                                         self.device))
                print(f"[infinity] BSQ VAE loaded: {self.cfg.vae_weights}", flush=True)
            elif "vq" not in params:
                print("[infinity] BSQ VAE is random-init (transformer-only tree): decoded pixels are not "
                      "meaningful", flush=True)
                params = dict(params, vq=bsq.init_bsq(self.cfg.model.vq, key))
            if self._prepare is not None:
                params = self._prepare(params)
            self.param_shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
            self.model = inf_mod.InfinityTransformer(self.cfg.model, params).to(self.device)
            self._params = None
        if self.text_emb is None:
            self._load_prompts()

    def _load_prompts(self) -> None:
        from ..utils.prompt_cache import aug_with_positive_prompt, load_cache, load_prompts_txt

        path = self.cfg.encoded_prompt_path
        if path and Path(path).exists():
            if self.cfg.enable_positive_prompt:
                print("[infinity] WARNING: --enable_positive_prompt has no effect on an encoded-prompt cache: "
                      "augmentation happens at encode time", flush=True)
            data = load_cache(path, "infinity")
            self.prompt_cache_sha = data["content_sha256"]
            self.prompts = list(data["prompts"])
            self.text_emb = torch.as_tensor(data["text_emb"], dtype=torch.float32).to(self.device)
            self.text_mask = torch.as_tensor(data["text_mask"]).to(self.device, torch.bool)
            return
        prompts = self.prompts if self._given_prompts else ["a photo of a cat"]
        if not self._given_prompts and self.cfg.prompts_txt_path and Path(self.cfg.prompts_txt_path).exists():
            prompts = load_prompts_txt(self.cfg.prompts_txt_path) or prompts
        if self.cfg.enable_positive_prompt:
            prompts = [aug_with_positive_prompt(p) for p in prompts]
        self.prompts = prompts
        self.text_emb, self.text_mask = hash_text_features(prompts, self.cfg.model.text_dim, self.device)

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
        return (self.cfg.model.seq_len, self.cfg.model.vq.bits, 2)

    def kv_workspace(self, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The KV cache ``(kC, vC)``, each ``[depth, rows, L, H, dh]`` in the
        compute dtype, of calls with ``rows`` CFG rows: allocated at the
        first such call, never inside a CUDA graph's capture (a capture's
        warm-up call allocates it first)."""
        ws = self._workspaces.get(rows)
        if ws is None:
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the KV workspace of {rows} rows would be allocated inside a CUDA graph's "
                                   "capture: run the call once before capturing it")
            m = self.cfg.model
            shape = (m.depth, rows, m.seq_len, m.n_heads, m.head_dim)
            with torch.inference_mode(False):  # written in place by calls in and out of inference mode
                ws = (torch.empty(shape, dtype=m.compute_dtype, device=self.device),
                      torch.empty(shape, dtype=m.compute_dtype, device=self.device))
            self._workspaces[rows] = ws
        return ws

    @property
    def workspace_bytes(self) -> int:
        """Device bytes of the KV workspaces allocated so far."""
        return sum(t.numel() * t.element_size() for ws in self._workspaces.values() for t in ws)

    def sample_gen_noise(self, key: torch.Tensor, item_index: Sequence[int]) -> torch.Tensor:
        """Sampling noise ``[len(item_index), L, bits, 2]`` on the key's
        device: the Gumbel noise of the JAX package's per-scale, per-image
        keys."""
        return per_scale_gumbel(key, item_index, self.cfg.model.patch_nums, (self.cfg.model.vq.bits, 2))

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
        ``noise [n, b, L, bits, 2]`` replaces the draw. ``guidance_scale``
        replaces the CFG schedule by one constant."""
        cfg = self.cfg
        ids = torch.as_tensor(flat_ids, dtype=torch.long, device=self.device)
        n, b = ids.shape
        if noise is None:
            noise = self.sample_gen_noise(lane_keys(keys, n, self.device), range(b))
        noise = noise.reshape(n, b, *self.noise_shape)
        return inf_mod.generate(
            self.model, self.text_emb[ids], self.text_mask[ids], noise,
            cfg_list=cfg.cfg_list if guidance_scale is None else (guidance_scale,), tau_list=cfg.tau_list,
            lora=stacked_theta, lora_scale=self.lora_scale, workspace=self.kv_workspace(2 * n * b),
        )

    def generate(self, theta: Optional[Params], flat_ids: Sequence[int], key: torch.Tensor) -> torch.Tensor:
        """One adapter, one request: ``[b]`` catalog indices → ``[b, H, W, 3]``."""
        stacked = None
        if theta is not None:
            stacked = {k: {f: t.to(self.device)[None] for f, t in v.items()} for k, v in theta.items()}
        return self.generate_p(stacked, [list(flat_ids)], key[None])[0]


def build_train_backend(scale: str = "2b", device: DeviceLike = None, seed: int = 0,
                        base_quant: Optional[str] = None, depth: Optional[int] = None):
    """The Infinity backend and the reward suite of the ``inf_2b`` rung:
    random weights from ``split(PRNGKey(seed))``'s first key on the device
    (the reward suite from its second), their float leaves cast to
    the model's compute dtype (bf16 at ``"2b"``; ``"tiny"`` stays f32), the
    ``BENCH_PROMPT_SET`` catalog with hash-fallback text features, CLIP-B/32
    and the CLIP-H/14 PickScore tower at their published widths (``"2b"``)
    with text tables from random token ids, in the rung's ``tower_dtype``.
    ``base_quant`` (default: the rung's ``RUNG_OPT``, a float base) is the
    JAX CLI's knob: ``"int8"`` quantizes the generator's tree, the BSQ
    tokenizer included, and the towers' image sides after their text tables
    are built (``ops.quant.maybe_quantize_tree``). ``depth`` cuts the
    transformer to that many blocks, every width kept. Returns ``(backend,
    reward_fn)``."""
    from ..rewards.suite import build_random_reward_suite

    opt = rung_opt("inf_2b")
    base_quant = opt["base_quant"] if base_quant is None else base_quant
    dev = resolve_device(device)
    spec = infinity_rung_model(scale, tower_dtype=opt["tower_dtype"])
    bcfg = spec["bcfg"]
    if depth is not None:
        bcfg = dataclasses.replace(bcfg, model=dataclasses.replace(bcfg.model, depth=int(depth)))
    kt, kc = threefry.split(threefry.prng_key(seed, dev))
    params = cast_floating(inf_mod.init_infinity(bcfg.model, kt), bcfg.model.compute_dtype)
    backend = InfinityBackend(bcfg, dev, params=maybe_quantize_tree(params, base_quant),
                              prompts=list(BENCH_PROMPT_SET))
    del params
    backend.setup()
    return backend, build_random_reward_suite(spec["clip_b"], spec["clip_h"], backend.num_items, kc,
                                              resolve_float_dtype(opt["tower_dtype"]), base_quant)
