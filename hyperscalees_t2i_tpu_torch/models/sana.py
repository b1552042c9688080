"""Sana-Sprint text-conditional DiT and the one-step TrigFlow/SCM sampler.

Port of ``hyperscalees_t2i_tpu/models/sana.py``: linear-attention DiT over
DC-AE latents with AdaLN-single time conditioning, guidance embedding, cross
attention to text embeddings and a gated mix-FFN. :func:`init_sana` builds
the same parameter tree as the JAX package (blocks stacked ``[L, ...]``);
:class:`SanaTransformer` holds it as buffers, one :class:`SanaBlock` per
layer. Serving runs under ``torch.inference_mode()``, so the ``remat`` field
is kept for parity and does nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..lora import LoRASpec, lookup, slice_layer
from ..utils import threefry
from ..utils.pytree import tree_map
from . import nn

Params = Dict[str, Any]

SANA_LORA_TARGETS: Tuple[str, ...] = (
    "to_q", "to_k", "to_v", "to_out", "linear_1", "linear_2", "proj_out", r"time_embed/linear",
)
_ATTN = ("to_q", "to_k", "to_v", "to_out")


@dataclasses.dataclass(frozen=True)
class SanaConfig:
    """Architecture and sampler constants; defaults are Sana-Sprint 1.6B at
    1024px (32-channel latents on a 32×32 grid, patch 1)."""

    in_channels: int = 32
    out_channels: int = 32
    patch_size: int = 1
    d_model: int = 2240
    n_layers: int = 20
    n_heads: int = 70
    cross_n_heads: int = 20
    caption_dim: int = 2304
    ff_ratio: float = 2.5
    guidance_embeds: bool = True
    guidance_embeds_scale: float = 0.1
    sigma_data: float = 0.5
    time_freq_dim: int = 256
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def lora_spec(self, rank: int = 8, alpha: float = 16.0) -> LoRASpec:
        return LoRASpec(rank=rank, alpha=alpha, targets=SANA_LORA_TARGETS)


def init_sana(cfg: SanaConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn on the
    key's device from the JAX package's key tree (``init_sana(key, cfg)``)."""
    d, L = cfg.d_model, cfg.n_layers
    dev = key.device
    ks = threefry.split(key, 20)
    hidden2 = int(round(d * cfg.ff_ratio)) * 2
    params: Params = {
        "patch_embed": nn.conv_init(ks[0], cfg.patch_size, cfg.patch_size, cfg.in_channels, d),
        "caption_norm": nn.norm_init(cfg.caption_dim, dev, bias=False),
        "caption_proj": {
            "linear_1": nn.dense_init(ks[1], cfg.caption_dim, d),
            "linear_2": nn.dense_init(ks[2], d, d),
        },
        "time_embed": {
            "timestep": nn.mlp_embedder_init(ks[3], cfg.time_freq_dim, d),
            "linear": nn.dense_init(ks[4], d, 6 * d),
        },
        "blocks": {
            "scale_shift_table": threefry.normal(ks[5], (L, 6, d)) / d**0.5,
            "attn1": {
                "to_q": nn.stacked_dense_init(ks[6], L, d, d, bias=False),
                "to_k": nn.stacked_dense_init(ks[7], L, d, d, bias=False),
                "to_v": nn.stacked_dense_init(ks[8], L, d, d, bias=False),
                "to_out": nn.stacked_dense_init(ks[9], L, d, d),
            },
            "attn2": {
                "to_q": nn.stacked_dense_init(ks[10], L, d, d, bias=False),
                "to_k": nn.stacked_dense_init(ks[11], L, d, d, bias=False),
                "to_v": nn.stacked_dense_init(ks[12], L, d, d, bias=False),
                "to_out": nn.stacked_dense_init(ks[13], L, d, d),
            },
            "ff": {
                "conv_inverted": {
                    "kernel": threefry.normal(ks[14], (L, 1, 1, d, hidden2)) / d**0.5,
                    "bias": torch.zeros(L, hidden2, device=dev),
                },
                "conv_depth": {
                    "kernel": threefry.normal(ks[15], (L, 3, 3, 1, hidden2)) / 3.0,
                    "bias": torch.zeros(L, hidden2, device=dev),
                },
                "conv_point": {
                    "kernel": threefry.normal(ks[16], (L, 1, 1, hidden2 // 2, d)) / (hidden2 // 2) ** 0.5,
                },
            },
        },
        "scale_shift_table": threefry.normal(ks[17], (2, d)) / d**0.5,
        "proj_out": nn.dense_init(ks[18], d, cfg.patch_size * cfg.patch_size * cfg.out_channels),
    }
    if cfg.guidance_embeds:
        params["time_embed"]["guidance"] = nn.mlp_embedder_init(ks[19], cfg.time_freq_dim, d)
    return params


class SanaBlock(tnn.Module):
    """One transformer layer, built from the layer's slice of the stacked tree."""

    def __init__(self, bp: Params):
        super().__init__()
        self.register_buffer("scale_shift_table", bp["scale_shift_table"])
        self.attn1 = tnn.ModuleDict({k: nn.Dense(bp["attn1"][k]) for k in _ATTN})
        self.attn2 = tnn.ModuleDict({k: nn.Dense(bp["attn2"][k]) for k in _ATTN})
        self.ff = nn.GLUMBConv(bp["ff"])

    def forward(self, x, c, shared6, caption_mask, cfg: SanaConfig, hw, lora: Dict[str, Any], lora_scale):
        B = x.shape[0]
        dt = cfg.compute_dtype
        mods = self.scale_shift_table.to(torch.float32)[None] + shared6  # [B, 6, d]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = [
            m.to(dt)[:, None, :] for m in mods.unbind(1)
        ]
        heads = lambda t, n: t.reshape(B, t.shape[1], n, t.shape[-1] // n)  # noqa: E731
        merge = lambda t: t.reshape(B, t.shape[1], -1)  # noqa: E731

        h = nn.layer_norm(x) * (1 + scale_msa) + shift_msa
        q = heads(self.attn1["to_q"](h, lora.get("attn1/to_q"), lora_scale), cfg.n_heads)
        k = heads(self.attn1["to_k"](h, lora.get("attn1/to_k"), lora_scale), cfg.n_heads)
        v = heads(self.attn1["to_v"](h, lora.get("attn1/to_v"), lora_scale), cfg.n_heads)
        a = self.attn1["to_out"](merge(nn.linear_attention(q, k, v)), lora.get("attn1/to_out"), lora_scale)
        x = x + gate_msa * a

        q = heads(self.attn2["to_q"](x, lora.get("attn2/to_q"), lora_scale), cfg.cross_n_heads)
        k2 = heads(self.attn2["to_k"](c, lora.get("attn2/to_k"), lora_scale), cfg.cross_n_heads)
        v2 = heads(self.attn2["to_v"](c, lora.get("attn2/to_v"), lora_scale), cfg.cross_n_heads)
        a2 = merge(nn.attention(q, k2, v2, mask=caption_mask))
        x = x + self.attn2["to_out"](a2, lora.get("attn2/to_out"), lora_scale)

        h = nn.layer_norm(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(h, hw)


class SanaTransformer(tnn.Module):
    """The DiT over one parameter tree (float or int8 nodes, any dtype)."""

    def __init__(self, cfg: SanaConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Conv(params["patch_embed"], stride=cfg.patch_size)
        self.register_buffer("caption_norm_scale", params["caption_norm"]["scale"])
        self.caption_proj = tnn.ModuleDict({k: nn.Dense(params["caption_proj"][k]) for k in ("linear_1", "linear_2")})
        te = params["time_embed"]
        self.time_embed_timestep = nn.MLPEmbedder(te["timestep"])
        self.time_embed_linear = nn.Dense(te["linear"])
        self.time_embed_guidance = nn.MLPEmbedder(te["guidance"]) if cfg.guidance_embeds else None
        blocks = params["blocks"]
        self.blocks = tnn.ModuleList(
            SanaBlock(tree_map(lambda a, i=i: a[i], blocks)) for i in range(cfg.n_layers)
        )
        self.register_buffer("scale_shift_table", params["scale_shift_table"])
        self.proj_out = nn.Dense(params["proj_out"])

    def lora_sites(self) -> Dict[str, str]:
        """Module name → adapter path of every dense site to which the
        forward hands an adapter leaf. The time and guidance MLP embedders
        read none, as in the JAX package, though θ holds factors for them."""
        sites = {"time_embed_linear": "time_embed/linear", "proj_out": "proj_out"}
        sites.update({f"caption_proj.{k}": f"caption_proj/{k}" for k in self.caption_proj})
        for i in range(len(self.blocks)):
            for site in ("attn1", "attn2"):
                sites.update({f"blocks.{i}.{site}.{k}": f"blocks/{site}/{k}" for k in _ATTN})
        return sites

    def forward(
        self,
        latents: torch.Tensor,  # [B, H, W, C_in]
        timestep: torch.Tensor,  # [B]
        caption: torch.Tensor,  # [B, Ltxt, caption_dim]
        caption_mask: Optional[torch.Tensor] = None,  # [B, Ltxt] bool
        guidance: Optional[torch.Tensor] = None,  # [B]
        lora: Optional[Params] = None,
        lora_scale: float = 1.0,
    ) -> torch.Tensor:
        """ε-prediction ``[B, H, W, C_out]`` in f32. ``lora`` is one adapter
        or a lane-stacked batch of ``n`` adapters for ``B = n·b`` rows."""
        cfg = self.cfg
        B, H, W, _ = latents.shape
        d, p = cfg.d_model, cfg.patch_size
        hw = (H // p, W // p)
        dt = cfg.compute_dtype

        x = self.patch_embed(latents.to(dt)).reshape(B, hw[0] * hw[1], d)

        t_emb = self.time_embed_timestep(nn.timestep_embedding(timestep, cfg.time_freq_dim))
        if cfg.guidance_embeds:
            g = guidance if guidance is not None else torch.zeros(B, device=latents.device)
            t_emb = t_emb + self.time_embed_guidance(nn.timestep_embedding(g, cfg.time_freq_dim))
        shared6 = self.time_embed_linear(
            F.silu(t_emb), lookup(lora, "time_embed/linear"), lora_scale
        ).reshape(B, 6, d)

        c = nn.rms_norm(caption.to(dt), {"scale": self.caption_norm_scale})
        c = self.caption_proj["linear_1"](c, lookup(lora, "caption_proj/linear_1"), lora_scale)
        c = self.caption_proj["linear_2"](F.silu(c), lookup(lora, "caption_proj/linear_2"), lora_scale)

        block_lora = {}
        for site in ("attn1", "attn2"):
            for name in _ATTN:
                leaf = lookup(lora, f"blocks/{site}/{name}")
                if leaf is not None:
                    block_lora[f"{site}/{name}"] = leaf
        for i, block in enumerate(self.blocks):
            bl = {k: slice_layer(v, i) for k, v in block_lora.items()}
            x = block(x, c, shared6, caption_mask, cfg, hw, bl, lora_scale)

        table = self.scale_shift_table.to(torch.float32)[None] + t_emb[:, None, :]  # [B, 2, d]
        shift, scale = table[:, 0, None, :].to(dt), table[:, 1, None, :].to(dt)
        x = nn.layer_norm(x) * (1 + scale) + shift
        x = self.proj_out(x, lookup(lora, "proj_out"), lora_scale)

        x = x.reshape(B, hw[0], hw[1], p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, H, W, cfg.out_channels).to(torch.float32)


def sana_forward(model: SanaTransformer, *args, **kwargs) -> torch.Tensor:
    """Functional spelling of ``model(...)`` (the JAX package's name)."""
    return model(*args, **kwargs)


def per_image_normal(key: torch.Tensor, item_index: Sequence[int], shape: Tuple[int, ...]) -> torch.Tensor:
    """``[..., len(item_index), *shape]`` standard normals on the key's
    device: image ``i`` is ``normal(fold_in(key, item_index[i]), shape)``,
    the JAX package's ``_per_image_normal``, so it is the same in every
    batch; a batch of keys ``[..., 2]`` draws each key's images."""
    return threefry.normal(threefry.fold_in(key[..., None, :], threefry.indices(item_index, key.device)), shape)


def one_step_generate(
    model: SanaTransformer,
    prompt_embeds: torch.Tensor,  # [B, Ltxt, caption_dim]
    prompt_mask: Optional[torch.Tensor],
    key: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    latent_hw: Tuple[int, int] = (32, 32),
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
    alpha_t: float = 0.267,
    sigma_t: float = 0.964,
    noise: Optional[torch.Tensor] = None,
    item_index: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """One-step TrigFlow/SCM generation → latents divided by σ_d.

    The JAX package's sampler math: latents ~ N(0, σ_d²) (``noise`` given,
    or image ``i`` drawn from ``fold_in(key, item_index[i])``, default
    ``item_index = range(B)``), the model evaluated at t = 1.571 with SCM
    timestep sin t/(cos t + sin t), NaN/inf in the ε-prediction zeroed, and
    the fixed α_t = 0.267, σ_t = 0.964 step."""
    B = prompt_embeds.shape[0]
    h, w = latent_hw
    cfg = model.cfg
    sd = cfg.sigma_data
    dev = prompt_embeds.device
    if noise is None:
        if key is None:
            raise ValueError("one_step_generate needs a key or explicit noise")
        noise = per_image_normal(key, range(B) if item_index is None else item_index, (h, w, cfg.in_channels))
    latents = noise.to(dev, torch.float32) * sd
    latent_in = latents / sd

    t = torch.full((B,), 1.571, dtype=torch.float32, device=dev)
    scm_t = torch.sin(t) / (torch.cos(t) + torch.sin(t))
    s = scm_t[:, None, None, None]
    guidance = torch.full((B,), guidance_scale * cfg.guidance_embeds_scale, dtype=torch.float32, device=dev)

    eps_pred = model(latent_in, scm_t, prompt_embeds, prompt_mask, guidance, lora, lora_scale)
    eps_pred = torch.nan_to_num(eps_pred, nan=0.0, posinf=0.0, neginf=0.0)

    noise_pred = ((1 - 2 * s) * latent_in + (1 - 2 * s + 2 * s**2) * eps_pred) / torch.sqrt(
        s**2 + (1 - s) ** 2
    )
    noise_pred = noise_pred * sd
    pred_x0 = alpha_t * latents - sigma_t * noise_pred
    return pred_x0 / sd
