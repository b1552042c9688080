"""Batched CLIP/PickScore rewards (port of
``hyperscalees_t2i_tpu/rewards/suite.py``).

- CLIP-B/32 cosine similarities against the aesthetic text, the image's own
  prompt and the negative text, each mapped ``(s+1)/2`` into [0, 1];
  ``no_artifacts = 1 − sim(negative)``.
- PickScore v1: ``exp(logit_scale)·dot(text̂, imĝ)`` with the CLIP-H towers;
  zeros without them.
- ``combined = 0.3·aesthetic + 0.3·align + 0.2·no_artifacts + 0.2·pick``.

Text tables are built once, before the towers are quantized. The rungs
build theirs from random token ids; the train CLI tokenizes its prompts
with :func:`tokenize_with_hf`'s deterministic hash fallback (the Hugging
Face branch is not ported: no tokenizer is cached offline).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models import clip as clip_mod
from ..utils import threefry
from ..utils.seeding import stable_text_seed

AESTHETIC_TEXT = "a high quality, professional, beautiful, aesthetically pleasing image"
NEGATIVE_TEXT = "blurry, low resolution, noisy, pixelated, washed out colors, oversaturated "


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    aesthetic: float = 0.3
    align: float = 0.3
    no_artifacts: float = 0.2
    pickscore: float = 0.2


def _normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.to(torch.float32), dim=-1, keepdim=True)
    return x / n.clamp_min(eps)


def tokenize_with_hf(prompts: Sequence[str], name: str = "openai/clip-vit-base-patch32"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(input_ids [N, 77] int32, eot_index [N] int32, attention_mask [N,
    77] bool)``. With ``transformers`` installed and ``name`` a tokenizer
    directory (or a model cached locally), the Hugging Face tokenizer pads
    and truncates to 77 and the EOT is ``argmax(ids)``, as the JAX package
    tokenizes; nothing is downloaded (``local_files_only``). Otherwise the
    JAX package's hash fallback: word ``j`` of prompt ``p`` is token
    ``stable_text_seed(f"{p}\\x00{j}") % 40000 + 2`` after a BOS of 1, then
    EOT 49407, padding 1. Fine for smoke runs, not for scoring parity with
    real CLIP."""
    L = 77
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
        out = tok(list(prompts), padding="max_length", truncation=True, max_length=L, return_tensors="np")
    except Exception:
        out = None
    if out is not None:
        ids = torch.from_numpy(out["input_ids"].astype("int32"))
        return ids, ids.argmax(dim=-1).to(torch.int32), torch.from_numpy(out["attention_mask"].astype(bool))
    ids = torch.ones((len(prompts), L), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks = [(stable_text_seed(f"{p}\x00{j}") % 40000) + 2 for j in range(min(len(p.split()), L - 2))]
        ids[i, 1:1 + len(toks)] = torch.tensor(toks, dtype=torch.int32)
        ids[i, 1 + len(toks)] = 49407  # EOT, the largest id of CLIP's vocabulary
    return ids, ids.argmax(dim=-1).to(torch.int32), torch.ones((len(prompts), L), dtype=torch.bool)


def clip_text_embed_table(model: clip_mod.CLIPModel, input_ids: torch.Tensor,
                          eot_index: Optional[torch.Tensor] = None,
                          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The normalized CLIP text table ``[M+2, P]`` (rows: the M prompts, the
    aesthetic text, the negative text), built once per run."""
    return _normalize(clip_mod.text_features(model, input_ids, eot_index, attention_mask))


def pickscore_text_embeds(model: clip_mod.CLIPModel, input_ids: torch.Tensor,
                          eot_index: Optional[torch.Tensor] = None,
                          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized PickScore text embeddings per prompt, ``[M, P]``."""
    return _normalize(clip_mod.text_features(model, input_ids, eot_index, attention_mask))


def compute_rewards_batch(
    clip_model: clip_mod.CLIPModel,
    images: torch.Tensor,  # [B, H, W, 3] in [0, 1]
    clip_text_table: torch.Tensor,  # [M+2, P] normalized
    prompt_ids: torch.Tensor,  # [B] row of each image's prompt in the table
    weights: RewardWeights = RewardWeights(),
    pick_model: Optional[clip_mod.CLIPModel] = None,
    pick_text_embeds: Optional[torch.Tensor] = None,  # [M, P2] normalized
) -> Dict[str, torch.Tensor]:
    """Per-image rewards, every value a ``[B]`` f32 tensor."""
    M = clip_text_table.shape[0] - 2
    pixels = clip_mod.preprocess_images(images, clip_model.cfg)
    img = _normalize(clip_mod.image_features(clip_model, pixels))
    table = clip_text_table.to(img.dtype)
    to01 = lambda s: (s + 1.0) / 2.0  # noqa: E731
    clip_aesthetic = to01(img @ table[M])
    clip_text = to01((img * table[prompt_ids]).sum(-1))
    no_artifacts = 1.0 - to01(img @ table[M + 1])
    if pick_model is not None and pick_text_embeds is not None:
        pimg = _normalize(clip_mod.image_features(pick_model, clip_mod.preprocess_images(images, pick_model.cfg)))
        pickscore = torch.exp(pick_model.logit_scale.to(torch.float32)) * (
            pimg * pick_text_embeds.to(pimg.dtype)[prompt_ids]).sum(-1)
    else:
        pickscore = torch.zeros(images.shape[0], dtype=torch.float32, device=images.device)
    combined = (weights.aesthetic * clip_aesthetic + weights.align * clip_text
                + weights.no_artifacts * no_artifacts + weights.pickscore * pickscore)
    out = dict(clip_aesthetic=clip_aesthetic, clip_text=clip_text, no_artifacts=no_artifacts,
               pickscore=pickscore, combined=combined)
    return {k: v.to(torch.float32) for k, v in out.items()}


class RewardSuite:
    """The trainer's reward object: ``suite(images, prompt_ids)`` → the
    reward dict. The towers are modules holding their frozen weights."""

    def __init__(self, clip_model: clip_mod.CLIPModel, clip_text_table: torch.Tensor,
                 weights: RewardWeights = RewardWeights(),
                 pick_model: Optional[clip_mod.CLIPModel] = None,
                 pick_text_embeds: Optional[torch.Tensor] = None):
        self.clip_model = clip_model
        self.clip_text_table = clip_text_table
        self.weights = weights
        have_pick = pick_model is not None and pick_text_embeds is not None
        self.pick_model = pick_model if have_pick else None
        self.pick_text_embeds = pick_text_embeds if have_pick else None

    def __call__(self, images: torch.Tensor, prompt_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        return compute_rewards_batch(
            self.clip_model, images, self.clip_text_table, prompt_ids, self.weights,
            self.pick_model, self.pick_text_embeds,
        )


def make_clip_reward_fn(clip_model: clip_mod.CLIPModel, clip_text_table: torch.Tensor,
                        weights: RewardWeights = RewardWeights(),
                        pick_model: Optional[clip_mod.CLIPModel] = None,
                        pick_text_embeds: Optional[torch.Tensor] = None) -> RewardSuite:
    """Bind the reward towers into the trainer's reward-function contract."""
    return RewardSuite(clip_model, clip_text_table, weights, pick_model, pick_text_embeds)


def build_random_reward_suite(clip_b: clip_mod.CLIPConfig, clip_h: Optional[clip_mod.CLIPConfig],
                              num_prompts: int, key: torch.Tensor, dtype: torch.dtype,
                              base_quant: str = "off") -> RewardSuite:
    """A benchmark rung's reward suite from random weights, drawn as the JAX
    package's ``bench.py`` draws it (``_init_rewards``) on the key's device:
    ``key`` splits into the CLIP-B, PickScore and PickScore-token keys; the
    CLIP-B key splits again into its tower (cast to ``dtype``) and its text
    table's random token ids (``num_prompts`` + 2 rows of
    ``rungs.PROMPT_TOKEN_LEN``, ``randint``); where there is a PickScore
    tower, it and its text embeddings the same way. The tables are built
    while the towers are still float; ``base_quant`` then applies to both
    towers."""
    from ..ops.quant import maybe_quantize_tree
    from ..rungs import PROMPT_TOKEN_LEN
    from ..utils.pytree import cast_floating

    kc, kp, ki = threefry.split(key, 3)
    kc_tower, kc_ids = threefry.split(kc)
    cparams = cast_floating(clip_mod.init_clip(clip_b, kc_tower), dtype)
    ids = threefry.randint(kc_ids, (num_prompts + 2, PROMPT_TOKEN_LEN), 0, clip_b.vocab_size)
    with torch.inference_mode():
        table = clip_text_embed_table(clip_mod.CLIPModel(clip_b, cparams), ids)
    pick_model = ptable = None
    if clip_h is not None:
        pparams = cast_floating(clip_mod.init_clip(clip_h, kp), dtype)
        pids = threefry.randint(ki, (num_prompts, PROMPT_TOKEN_LEN), 0, clip_h.vocab_size)
        with torch.inference_mode():
            ptable = pickscore_text_embeds(clip_mod.CLIPModel(clip_h, pparams), pids)
        pick_model = clip_mod.CLIPModel(clip_h, maybe_quantize_tree(pparams, base_quant))
        del pparams
    clip_model = clip_mod.CLIPModel(clip_b, maybe_quantize_tree(cparams, base_quant))
    return make_clip_reward_fn(clip_model, table, pick_model=pick_model, pick_text_embeds=ptable)
