"""DC-AE deep-compression autoencoder (port of
``hyperscalees_t2i_tpu/models/dcae.py``).

Decoder: conv stem, per-stage residual conv blocks or ReLU-linear-attention
(LiteMLA) blocks in the deepest stages, 2× depth-to-space upsampling with
channel-repeating shortcuts, RMS norm and a conv head. Encoder (on no hot
path; it completes the autoencoder): the mirror image, RGB → latents, with
stride-2 convs down and residual blocks. NHWC throughout; an int8 conv node
runs through the same ``nn.Conv`` either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..utils import threefry
from . import nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DCAEConfig:
    latent_channels: int = 32
    # decoder stage widths, deepest→shallowest; len-1 upsamples of 2× each
    channels: Tuple[int, ...] = (1024, 1024, 512, 512, 256, 128)
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)
    attn_stages: Tuple[int, ...] = (0, 1)
    attn_heads: int = 16
    scaling_factor: float = 0.41407
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.channels) - 1)


def init_decoder(cfg: DCAEConfig, key: torch.Tensor) -> Params:
    """Random f32 decoder parameters in the JAX package's tree layout, drawn
    on the key's device from its key tree (``init_decoder(key, cfg)``)."""
    chs = cfg.channels
    dev = key.device
    ki = iter(threefry.split(key, 3 + len(chs) * (1 + max(cfg.blocks_per_stage))))
    params: Params = {"conv_in": nn.conv_init(next(ki), 3, 3, cfg.latent_channels, chs[0])}
    stages = []
    for si, ch in enumerate(chs):
        stage: Params = {}
        if si > 0:
            stage["up"] = nn.conv_init(next(ki), 3, 3, chs[si - 1], ch * 4)
        blocks = []
        for _ in range(cfg.blocks_per_stage[si]):
            if si in cfg.attn_stages:
                k1, k2, k3 = threefry.split(next(ki), 3)
                blocks.append({"mla": {
                    "norm": nn.norm_init(ch, dev, bias=False),
                    "qkv": nn.dense_init(k1, ch, 3 * ch, bias=False),
                    "proj": nn.dense_init(k2, ch, ch),
                    "ffn": nn.glumb_conv_init(k3, ch, ratio=2.0),
                    "ffn_norm": nn.norm_init(ch, dev, bias=False),
                }})
            else:
                k1, k2 = threefry.split(next(ki))
                blocks.append({"res": {"conv1": nn.conv_init(k1, 3, 3, ch, ch),
                                       "conv2": nn.conv_init(k2, 3, 3, ch, ch)}})
        stage["blocks"] = blocks
        stages.append(stage)
    params["stages"] = stages
    params["norm_out"] = nn.norm_init(chs[-1], dev, bias=False)
    params["conv_out"] = nn.conv_init(next(ki), 3, 3, chs[-1], 3)
    return params


class ResBlock(tnn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.conv1 = nn.Conv(p["conv1"])
        self.conv2 = nn.Conv(p["conv2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.silu(self.conv1(x)))


class LiteMLA(tnn.Module):
    """RMS norm → qkv → ReLU linear attention → proj, then a GLUMBConv FFN."""

    def __init__(self, p: Params, heads: int):
        super().__init__()
        self.heads = heads
        self.register_buffer("norm_scale", p["norm"]["scale"])
        self.qkv = nn.Dense(p["qkv"])
        self.proj = nn.Dense(p["proj"])
        self.ffn = nn.GLUMBConv(p["ffn"])
        self.register_buffer("ffn_norm_scale", p["ffn_norm"]["scale"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        t = nn.rms_norm(x, {"scale": self.norm_scale}).reshape(B, H * W, C)
        q, k, v = torch.chunk(self.qkv(t), 3, dim=-1)
        heads = min(self.heads, C)
        sh = lambda a: a.reshape(B, H * W, heads, C // heads)  # noqa: E731
        a = nn.linear_attention(sh(q), sh(k), sh(v)).reshape(B, H * W, C)
        x = x + self.proj(a).reshape(B, H, W, C)
        t = nn.rms_norm(x, {"scale": self.ffn_norm_scale}).reshape(B, H * W, C)
        return x + self.ffn(t, (H, W)).reshape(B, H, W, C)


class DecoderStage(tnn.Module):
    """Optional 2× upsample (conv + repeated-channel shortcut + depth-to-space),
    then the stage's blocks."""

    def __init__(self, p: Params, heads: int):
        super().__init__()
        self.up = nn.Conv(p["up"]) if "up" in p else None
        self.blocks = tnn.ModuleList(
            LiteMLA(b["mla"], heads) if "mla" in b else ResBlock(b["res"]) for b in p["blocks"]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up is not None:
            up = self.up(x)
            rep = up.shape[-1] // x.shape[-1]
            shortcut = torch.repeat_interleave(x, rep, dim=-1) if rep > 0 else up
            x = nn.depth_to_space(up + shortcut, 2)
        for block in self.blocks:
            x = block(x)
        return x


class DCAEDecoder(tnn.Module):
    def __init__(self, cfg: DCAEConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv(params["conv_in"])
        self.stages = tnn.ModuleList(DecoderStage(s, cfg.attn_heads) for s in params["stages"])
        self.register_buffer("norm_out_scale", params["norm_out"]["scale"])
        self.conv_out = nn.Conv(params["conv_out"])

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """``[B, h, w, C_lat]`` (already divided by ``scaling_factor``) → RGB
        ``[B, h·f, w·f, 3]`` in [0, 1], f32."""
        x = self.conv_in(latents.to(self.cfg.compute_dtype))
        for stage in self.stages:
            x = stage(x)
        x = nn.rms_norm(x, {"scale": self.norm_out_scale})
        x = self.conv_out(F.silu(x))
        return (x.to(torch.float32) * 0.5 + 0.5).clamp(0.0, 1.0)


def decode(model: DCAEDecoder, latents: torch.Tensor) -> torch.Tensor:
    """Functional spelling of ``model(latents)`` (the JAX package's name)."""
    return model(latents)


def init_encoder(cfg: DCAEConfig, key: torch.Tensor) -> Params:
    """Random f32 encoder parameters in the JAX package's tree layout, drawn
    from its key tree (``init_encoder(key, cfg)``): stage widths are the
    decoder's reversed; stage ``i`` has ``blocks_per_stage[i]`` residual
    blocks."""
    chs = tuple(reversed(cfg.channels))
    ki = iter(threefry.split(key, 3 + len(chs) * (1 + max(cfg.blocks_per_stage))))
    params: Params = {"conv_in": nn.conv_init(next(ki), 3, 3, 3, chs[0])}
    stages = []
    for si, ch in enumerate(chs):
        stage: Params = {}
        if si > 0:
            stage["down"] = nn.conv_init(next(ki), 3, 3, chs[si - 1], ch)
        blocks = []
        for _ in range(cfg.blocks_per_stage[si]):
            k1, k2 = threefry.split(next(ki))
            blocks.append({"res": {"conv1": nn.conv_init(k1, 3, 3, ch, ch), "conv2": nn.conv_init(k2, 3, 3, ch, ch)}})
        stage["blocks"] = blocks
        stages.append(stage)
    params["stages"] = stages
    params["conv_out"] = nn.conv_init(next(ki), 3, 3, chs[-1], cfg.latent_channels)
    return params


class EncoderStage(tnn.Module):
    """Optional stride-2 conv down, then the stage's residual blocks."""

    def __init__(self, p: Params):
        super().__init__()
        self.down = nn.Conv(p["down"], stride=2) if "down" in p else None
        self.blocks = tnn.ModuleList(ResBlock(b["res"]) for b in p["blocks"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down is not None:
            x = self.down(x)
        for block in self.blocks:
            x = block(x)
        return x


class DCAEEncoder(tnn.Module):
    def __init__(self, cfg: DCAEConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv(params["conv_in"])
        self.stages = tnn.ModuleList(EncoderStage(s) for s in params["stages"])
        self.conv_out = nn.Conv(params["conv_out"])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """RGB ``[B, H, W, 3]`` in [0, 1] → latents ``[B, H/f, W/f, C_lat]``
        f32 (multiply by ``scaling_factor`` for the model's scale)."""
        x = (images.to(self.cfg.compute_dtype) - 0.5) * 2.0
        x = self.conv_in(x)
        for stage in self.stages:
            x = stage(x)
        return self.conv_out(x).to(torch.float32)


def encode(model: DCAEEncoder, images: torch.Tensor) -> torch.Tensor:
    """Functional spelling of ``model(images)`` (the JAX package's name)."""
    return model(images)
