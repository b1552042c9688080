"""CLIP dual towers (vision ViT + causal text transformer), the reward models.

Port of ``hyperscalees_t2i_tpu/models/clip.py``: CLIP-B/32 scores
aesthetics, text alignment and artifacts, CLIP-H/14 is PickScore v1's
backbone. :func:`init_clip` builds the JAX package's parameter tree (layers
stacked ``[L, ...]``); :class:`CLIPModel` holds it as buffers, one
:class:`EncoderLayer` per layer. Every dense site goes through
``nn.dense``, so an int8 tower runs the kernel K1, and the patch embed
through the ``nn.Conv`` patch route (K1 too, when int8).

HF ``CLIPAttention`` details kept: q is pre-scaled by ``head_dim**-0.5`` and
the softmax is unscaled; masks are ``-3.4e38`` on f32 logits (causal in the
text tower); ``quick_gelu`` is ``x·σ(1.702x)``, CLIP-H uses the erf GELU;
layer-norm eps 1e-5; text pooling at the EOT token, ``argmax(ids)`` (first
occurrence).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..device import constant
from ..utils import threefry
from ..utils.pytree import tree_map
from . import nn
from .resize import resize

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    d_model: int
    n_layers: int
    n_heads: int
    d_mlp: int


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPTowerConfig = CLIPTowerConfig(768, 12, 12, 3072)
    text: CLIPTowerConfig = CLIPTowerConfig(512, 12, 8, 2048)
    image_size: int = 224
    patch_size: int = 32
    vocab_size: int = 49408
    max_positions: int = 77
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"  # openai CLIP; laion CLIP-H uses "gelu"
    compute_dtype: Any = torch.float32


# openai/clip preprocessing constants (CLIPProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

CLIP_B32 = CLIPConfig()
# laion/CLIP-ViT-H-14-laion2B-s32B-b79K geometry (PickScore v1 backbone)
CLIP_H14 = CLIPConfig(
    vision=CLIPTowerConfig(1280, 32, 16, 5120),
    text=CLIPTowerConfig(1024, 24, 16, 4096),
    patch_size=14,
    projection_dim=1024,
    hidden_act="gelu",
)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: F.gelu(x)


def _encoder_layer_init(key: torch.Tensor, L: int, d: int, d_mlp: int) -> Params:
    ks = threefry.split(key, 6)
    dev = key.device
    return {
        "ln1": {"scale": torch.ones(L, d, device=dev), "bias": torch.zeros(L, d, device=dev)},
        "q": nn.stacked_dense_init(ks[0], L, d, d),
        "k": nn.stacked_dense_init(ks[1], L, d, d),
        "v": nn.stacked_dense_init(ks[2], L, d, d),
        "out": nn.stacked_dense_init(ks[3], L, d, d),
        "ln2": {"scale": torch.ones(L, d, device=dev), "bias": torch.zeros(L, d, device=dev)},
        "fc1": nn.stacked_dense_init(ks[4], L, d, d_mlp),
        "fc2": nn.stacked_dense_init(ks[5], L, d_mlp, d),
    }


def init_clip(cfg: CLIPConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn on the
    key's device from its key tree (``init_clip(key, cfg)``)."""
    kv, kt, kp = threefry.split(key, 3)
    v, t = cfg.vision, cfg.text
    dev = key.device
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    kvs = threefry.split(kv, 6)
    kts = threefry.split(kt, 4)
    return {
        "vision": {
            "patch_embed": {"kernel": threefry.normal(kvs[0], (cfg.patch_size, cfg.patch_size, 3, v.d_model)) * 0.02},
            "class_embed": threefry.normal(kvs[1], (v.d_model,)) * 0.02,
            "pos_embed": threefry.normal(kvs[2], (n_patches + 1, v.d_model)) * 0.02,
            "pre_ln": nn.norm_init(v.d_model, dev),
            "layers": _encoder_layer_init(kvs[3], v.n_layers, v.d_model, v.d_mlp),
            "post_ln": nn.norm_init(v.d_model, dev),
        },
        "text": {
            "token_embed": threefry.normal(kts[0], (cfg.vocab_size, t.d_model)) * 0.02,
            "pos_embed": threefry.normal(kts[1], (cfg.max_positions, t.d_model)) * 0.02,
            "layers": _encoder_layer_init(kts[2], t.n_layers, t.d_model, t.d_mlp),
            "final_ln": nn.norm_init(t.d_model, dev),
        },
        "visual_projection": {"kernel": threefry.normal(kp, (v.d_model, cfg.projection_dim)) * 0.02},
        "text_projection": {"kernel": threefry.normal(kts[3], (t.d_model, cfg.projection_dim)) * 0.02},
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=dev),
    }


class LayerNorm(tnn.Module):
    """Affine layer norm (eps 1e-5) over one ``{"scale", "bias"}`` node."""

    def __init__(self, p: Params):
        super().__init__()
        self.register_buffer("scale", p["scale"])
        self.register_buffer("bias", p["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.layer_norm(x, {"scale": self.scale, "bias": self.bias}, eps=1e-5)


class EncoderLayer(tnn.Module):
    """One pre-LN transformer layer, from the layer's slice of the stack."""

    def __init__(self, p: Params, tower: CLIPTowerConfig, act: str):
        super().__init__()
        self.tower, self.act = tower, _act(act)
        self.ln1, self.ln2 = LayerNorm(p["ln1"]), LayerNorm(p["ln2"])
        for name in ("q", "k", "v", "out", "fc1", "fc2"):
            setattr(self, name, nn.Dense(p[name]))

    def forward(self, x: torch.Tensor, causal: bool, mask: Optional[torch.Tensor]) -> torch.Tensor:
        H = self.tower.n_heads
        B, L, D = x.shape
        h = self.ln1(x)
        q = self.q(h) * (D // H) ** -0.5
        k, v = self.k(h), self.v(h)
        sh = lambda a: a.reshape(B, L, H, D // H)  # noqa: E731
        logits = torch.einsum("blhd,bmhd->bhlm", sh(q), sh(k)).to(torch.float32)
        if causal:
            keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, -3.4e38)
        if mask is not None:
            logits = logits.masked_fill(~mask.bool()[:, None, None, :], -3.4e38)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhlm,bmhd->blhd", attn, sh(v)).reshape(B, L, D)
        x = x + self.out(o)
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class Encoder(tnn.Module):
    def __init__(self, layers: Params, tower: CLIPTowerConfig, act: str):
        super().__init__()
        self.layers = tnn.ModuleList(
            EncoderLayer(tree_map(lambda a, i=i: a[i], layers), tower, act) for i in range(tower.n_layers)
        )

    def forward(self, x: torch.Tensor, causal: bool, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal, mask)
        return x


class CLIPModel(tnn.Module):
    """Both towers and projections of one CLIP parameter tree (float or
    int8 nodes, any dtype) as buffers."""

    def __init__(self, cfg: CLIPConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        vp, tp = params["vision"], params["text"]
        self.patch_embed = nn.Conv(vp["patch_embed"], stride=cfg.patch_size)
        self.register_buffer("class_embed", vp["class_embed"])
        self.register_buffer("vision_pos_embed", vp["pos_embed"])
        self.pre_ln, self.post_ln = LayerNorm(vp["pre_ln"]), LayerNorm(vp["post_ln"])
        self.vision = Encoder(vp["layers"], cfg.vision, cfg.hidden_act)
        self.register_buffer("token_embed", tp["token_embed"])
        self.register_buffer("text_pos_embed", tp["pos_embed"])
        self.text = Encoder(tp["layers"], cfg.text, cfg.hidden_act)
        self.final_ln = LayerNorm(tp["final_ln"])
        self.visual_projection = nn.Dense(params["visual_projection"])
        self.text_projection = nn.Dense(params["text_projection"])
        self.register_buffer("logit_scale", params["logit_scale"])


def preprocess_images(images: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] → normalized ``[B, S, S, 3]``: cast to the
    tower dtype, resized there (antialiased bicubic, as the JAX package's
    ``jax.image.resize``), mean/std normalized in f32, output in the tower
    dtype."""
    s, dt = cfg.image_size, cfg.compute_dtype
    images = resize(images.to(dt), s, s, "cubic")
    mean = constant(CLIP_IMAGE_MEAN, torch.float32, images.device)  # no host copy: the step is captured whole
    std = constant(CLIP_IMAGE_STD, torch.float32, images.device)
    return ((images.to(torch.float32) - mean) / std).to(dt)


def image_features(model: CLIPModel, pixel_values: torch.Tensor) -> torch.Tensor:
    """Preprocessed pixels → projected, unnormalized image embeddings ``[B, P]``."""
    cfg = model.cfg
    d = cfg.vision.d_model
    x = model.patch_embed(pixel_values)
    B = x.shape[0]
    x = x.reshape(B, -1, d)
    cls = model.class_embed.to(x.dtype).expand(B, 1, d)
    x = torch.cat([cls, x], dim=1) + model.vision_pos_embed.to(x.dtype)[None]
    x = model.vision(model.pre_ln(x), causal=False)
    return model.visual_projection(model.post_ln(x[:, 0]))


def text_features(model: CLIPModel, input_ids: torch.Tensor, eot_index: Optional[torch.Tensor] = None,
                  attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids ``[B, L]`` → projected, unnormalized text embeddings
    ``[B, P]``, pooled at the EOT position (``argmax(ids)`` unless given)."""
    cfg = model.cfg
    L = input_ids.shape[1]
    x = model.token_embed[input_ids].to(cfg.compute_dtype)
    x = x + model.text_pos_embed[:L].to(x.dtype)[None]
    x = model.final_ln(model.text(x, causal=True, mask=attention_mask))
    if eot_index is None:
        eot_index = input_ids.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_index]
    return model.text_projection(pooled)


def convert_hf_clip_state_dict(state_dict: Dict[str, Any], cfg: CLIPConfig) -> Params:
    """A ``transformers.CLIPModel`` state dict (torch tensors or numpy
    arrays) → the JAX package's tree of f32 numpy leaves, bitwise its
    ``convert_hf_clip_state_dict``'s: Linear ``[out, in]`` → ``[in, out]``,
    the patch conv OIHW → HWIO, layers stacked ``[L, ...]``. Works for
    openai/clip-vit-base-patch32, PickScore v1's CLIP-H backbone and any
    other HF CLIPModel geometry; ``weights.from_jax.clip_from_jax`` builds
    the module from it."""
    import numpy as np

    def g(name: str) -> np.ndarray:
        v = state_dict[name]
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    def stack(fmt: str, L: int) -> Params:
        out = {"kernel": np.stack([g(fmt.format(i) + ".weight") for i in range(L)]).transpose(0, 2, 1)}
        if fmt.format(0) + ".bias" in state_dict:
            out["bias"] = np.stack([g(fmt.format(i) + ".bias") for i in range(L)])
        return out

    def ln_stack(fmt: str, L: int) -> Params:
        return {"scale": np.stack([g(fmt.format(i) + ".weight") for i in range(L)]),
                "bias": np.stack([g(fmt.format(i) + ".bias") for i in range(L)])}

    def ln(name: str) -> Params:
        return {"scale": g(f"{name}.weight"), "bias": g(f"{name}.bias")}

    def tower(prefix: str, L: int) -> Params:
        enc = f"{prefix}.encoder.layers.{{}}"
        return {"ln1": ln_stack(enc + ".layer_norm1", L), "q": stack(enc + ".self_attn.q_proj", L),
                "k": stack(enc + ".self_attn.k_proj", L), "v": stack(enc + ".self_attn.v_proj", L),
                "out": stack(enc + ".self_attn.out_proj", L), "ln2": ln_stack(enc + ".layer_norm2", L),
                "fc1": stack(enc + ".mlp.fc1", L), "fc2": stack(enc + ".mlp.fc2", L)}

    vm, tm = "vision_model", "text_model"
    return {
        "vision": {
            "patch_embed": {"kernel": g(f"{vm}.embeddings.patch_embedding.weight").transpose(2, 3, 1, 0)},
            "class_embed": g(f"{vm}.embeddings.class_embedding"),
            "pos_embed": g(f"{vm}.embeddings.position_embedding.weight"),
            "pre_ln": ln(f"{vm}.pre_layrnorm"),
            "layers": tower(vm, cfg.vision.n_layers),
            "post_ln": ln(f"{vm}.post_layernorm"),
        },
        "text": {
            "token_embed": g(f"{tm}.embeddings.token_embedding.weight"),
            "pos_embed": g(f"{tm}.embeddings.position_embedding.weight"),
            "layers": tower(tm, cfg.text.n_layers),
            "final_ln": ln(f"{tm}.final_layer_norm"),
        },
        "visual_projection": {"kernel": g("visual_projection.weight").T},
        "text_projection": {"kernel": g("text_projection.weight").T},
        "logit_scale": g("logit_scale"),
    }
