"""Multi-scale residual VQ (next-scale prediction) and the CompVis decoder.

Port of ``hyperscalees_t2i_tpu/models/msvq.py``. The token pyramid follows
the static ``patch_nums`` (1..16 → L = Σpn² = 680 at 256 px). φ is the
partially shared residual-blend conv: ``phi_partial`` 3×3 convs, scale
``si`` picks one by the reference's nearest-tick rule (:func:`phi_index`).
Resizes follow ``jax.image.resize``: antialiased bicubic up to the full
grid, area (average pool) down to the next scale for integer ratios and the
antialiased triangle kernel for the others (``models/resize.py``).

:func:`init_msvq` builds the JAX package's tree (``"attn_1": None`` without
the mid attention, ``up`` a list of levels); :class:`MSVQ` holds it as
buffers. The generation side is :func:`accumulate_scale` (embed the sampled
ids, upsample, φ, add to f̂, downsample to the next scale), the encode side
:func:`encode_to_scales`, the image side :func:`decode_img` through
:class:`CompVisDecoder`, whose single-head spatial attention is plain torch
(the JAX package computes it outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..utils import threefry
from . import nn
from .resize import resize

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MSVQConfig:
    """CompVis-parameterized like ``vae_ch160v4096z32.pth`` (ch 160, ch_mult
    (1,1,2,2,4), 2 res blocks, mid and deepest-level self-attention, 3×3
    post-quant conv)."""

    vocab_size: int = 4096
    c_vae: int = 32
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    phi_partial: int = 4
    ch: int = 160
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    using_sa: bool = True
    using_mid_sa: bool = True
    compute_dtype: Any = torch.bfloat16

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def seq_len(self) -> int:
        return int(sum(p * p for p in self.patch_nums))

    @property
    def grid(self) -> int:
        return self.patch_nums[-1]


def _res_block_init(key: torch.Tensor, cin: int, cout: int) -> Params:
    k1, k2, k3 = threefry.split(key, 3)
    p: Params = {
        "norm1": nn.norm_init(cin, key.device),
        "conv1": nn.conv_init(k1, 3, 3, cin, cout),
        "norm2": nn.norm_init(cout, key.device),
        "conv2": nn.conv_init(k2, 3, 3, cout, cout),
    }
    if cin != cout:
        p["nin"] = nn.conv_init(k3, 1, 1, cin, cout)
    return p


def _attn_block_init(key: torch.Tensor, c: int) -> Params:
    k1, k2 = threefry.split(key)
    return {
        "norm": nn.norm_init(c, key.device),
        "qkv": nn.conv_init(k1, 1, 1, c, 3 * c),
        "proj": nn.conv_init(k2, 1, 1, c, c),
    }


def init_msvq(cfg: MSVQConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout, drawn on the
    key's device from its key tree (``init_msvq(key, cfg)``)."""
    C = cfg.c_vae
    dev = key.device
    n_levels = len(cfg.ch_mult)
    ks = threefry.split(key, 16 + n_levels * (cfg.num_res_blocks + 1) * 4)
    ki = iter(range(len(ks)))
    params: Params = {
        "codebook": threefry.normal(ks[next(ki)], (cfg.vocab_size, C)) / math.sqrt(C),
        "phi": {
            "kernel": threefry.normal(ks[next(ki)], (cfg.phi_partial, 3, 3, C, C)) / math.sqrt(9 * C),
            "bias": torch.zeros((cfg.phi_partial, C), device=dev),
        },
    }
    block_in = cfg.ch * cfg.ch_mult[-1]
    dec: Params = {
        "post_quant_conv": nn.conv_init(ks[next(ki)], 3, 3, C, C),
        "conv_in": nn.conv_init(ks[next(ki)], 3, 3, C, block_in),
        "mid": {
            "block_1": _res_block_init(ks[next(ki)], block_in, block_in),
            "attn_1": _attn_block_init(ks[next(ki)], block_in) if cfg.using_mid_sa else None,
            "block_2": _res_block_init(ks[next(ki)], block_in, block_in),
        },
    }
    # up[i_level] for i_level 0..n-1 (shallowest..deepest), drawn deepest-first
    up: List[Optional[Params]] = [None] * n_levels
    cin = block_in
    for i_level in reversed(range(n_levels)):
        cout = cfg.ch * cfg.ch_mult[i_level]
        level: Params = {"block": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            level["block"].append(_res_block_init(ks[next(ki)], cin, cout))
            cin = cout
            if i_level == n_levels - 1 and cfg.using_sa:
                level["attn"].append(_attn_block_init(ks[next(ki)], cout))
        if i_level != 0:
            level["upsample"] = nn.conv_init(ks[next(ki)], 3, 3, cout, cout)
        up[i_level] = level
    dec["up"] = up
    dec["norm_out"] = nn.norm_init(cin, dev)
    dec["conv_out"] = nn.conv_init(ks[next(ki)], 3, 3, cin, 3)
    params["decoder"] = dec
    return params


# ---------------------------------------------------------------------------
# The CompVis decoder (basic_vae.py:163-226 of the reference)
# ---------------------------------------------------------------------------

class GroupNorm(tnn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.register_buffer("scale", p["scale"])
        self.register_buffer("bias", p["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.group_norm(x, {"scale": self.scale, "bias": self.bias})


class ResBlock(tnn.Module):
    """GroupNorm → SiLU → conv, twice; a 1×1 shortcut where channels change."""

    def __init__(self, p: Params):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(p["norm1"]), nn.Conv(p["conv1"])
        self.norm2, self.conv2 = GroupNorm(p["norm2"]), nn.Conv(p["conv2"])
        self.nin = nn.Conv(p["nin"]) if p.get("nin") is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin is None else self.nin(x)) + h


class AttnBlock(tnn.Module):
    """Single-head spatial self-attention over H·W, f32 logits and softmax."""

    def __init__(self, p: Params):
        super().__init__()
        self.norm, self.qkv, self.proj = GroupNorm(p["norm"]), nn.Conv(p["qkv"]), nn.Conv(p["proj"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        q, k, v = torch.chunk(self.qkv(self.norm(x)).reshape(B, H * W, 3 * C), 3, dim=-1)
        w = torch.einsum("bic,bjc->bij", q.to(torch.float32), k.to(torch.float32))
        w = torch.softmax(w * (C ** -0.5), dim=-1)
        h = torch.einsum("bij,bjc->bic", w, v.to(torch.float32)).to(x.dtype)
        return x + self.proj(h.reshape(B, H, W, C))


class UpLevel(tnn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.block = tnn.ModuleList(ResBlock(b) for b in p["block"])
        self.attn = tnn.ModuleList(AttnBlock(a) for a in p["attn"])
        self.upsample = nn.Conv(p["upsample"]) if p.get("upsample") is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for bi, blk in enumerate(self.block):
            x = blk(x)
            if len(self.attn):
                x = self.attn[bi](x)
        if self.upsample is not None:
            # nearest ×2 (jax.image.resize "nearest" at an integer ratio)
            x = self.upsample(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return x


class CompVisDecoder(tnn.Module):
    """The decoder subtree (``run_decoder``); ``post_quant_conv`` optional."""

    def __init__(self, dec: Params, compute_dtype: Any):
        super().__init__()
        self.dt = compute_dtype
        self.post_quant_conv = nn.Conv(dec["post_quant_conv"]) if dec.get("post_quant_conv") is not None else None
        self.conv_in = nn.Conv(dec["conv_in"])
        mid = dec["mid"]
        self.mid_block_1 = ResBlock(mid["block_1"])
        self.mid_attn_1 = AttnBlock(mid["attn_1"]) if mid.get("attn_1") is not None else None
        self.mid_block_2 = ResBlock(mid["block_2"])
        self.up = tnn.ModuleList(UpLevel(level) for level in dec["up"])
        self.norm_out = GroupNorm(dec["norm_out"])
        self.conv_out = nn.Conv(dec["conv_out"])

    def forward(self, f_hat: torch.Tensor) -> torch.Tensor:
        """f̂ ``[B, pN, pN, C]`` → images ``[B, H, W, 3]`` in [0, 1], f32."""
        x = f_hat.to(self.dt)
        if self.post_quant_conv is not None:
            x = self.post_quant_conv(x)
        x = self.mid_block_1(self.conv_in(x))
        if self.mid_attn_1 is not None:
            x = self.mid_attn_1(x)
        x = self.mid_block_2(x)
        for level in reversed(self.up):
            x = level(x)
        x = self.conv_out(F.silu(self.norm_out(x)))
        return (x.to(torch.float32).clamp(-1.0, 1.0) + 1.0) / 2.0


class MSVQ(tnn.Module):
    """Codebook, φ convs and decoder of one VQ parameter tree, as buffers."""

    def __init__(self, cfg: MSVQConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("codebook", params["codebook"])
        phi = params["phi"]
        self.phi = tnn.ModuleList(nn.Conv({"kernel": phi["kernel"][k], "bias": phi["bias"][k]})
                                  for k in range(phi["kernel"].shape[0]))
        self.decoder = CompVisDecoder(params["decoder"], cfg.compute_dtype)


# ---------------------------------------------------------------------------
# The token pyramid
# ---------------------------------------------------------------------------

def up_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, h, w, C]`` → ``[B, size, size, C]``, antialiased bicubic."""
    return x if x.shape[1] == size else resize(x, size, size, "cubic")


def down_area(x: torch.Tensor, size: int) -> torch.Tensor:
    """Area downsample to ``[B, size, size, C]``: an average pool for integer
    ratios, the antialiased triangle resize for the others (16→13, 16→10)."""
    B, h, w, C = x.shape
    if h == size:
        return x
    if h % size == 0:
        f = h // size
        return x.reshape(B, size, f, size, f, C).sum(dim=(2, 4)) / float(f * f)
    return resize(x, size, size, "linear")


def phi_index(cfg: MSVQConfig, si: int) -> int:
    """φ conv of scale ``si``: the nearest of the ticks ``linspace(1/3K,
    1-1/3K, K)`` for K=4 (else ``1/2K``) to ``si/(S-1)``, float ties and all."""
    S, K = cfg.num_scales, cfg.phi_partial
    if S <= 1 or K <= 1:
        return 0
    lo = 1 / 3 / K if K == 4 else 1 / 2 / K
    ticks = np.linspace(lo, 1 - lo, K)
    return int(np.argmin(np.abs(ticks - si / (S - 1))))


def phi_apply(vq: MSVQ, h: torch.Tensor, si: int) -> torch.Tensor:
    """Residual blend ``0.5·h + 0.5·conv_k(h)``, ``k = phi_index(si)``."""
    return 0.5 * h + 0.5 * vq.phi[phi_index(vq.cfg, si)](h)


def embed_ids(vq: MSVQ, ids: torch.Tensor) -> torch.Tensor:
    """Token ids ``[...]`` → codebook vectors ``[..., C]``."""
    return vq.codebook[ids]


def accumulate_scale(vq: MSVQ, f_hat: torch.Tensor, ids: torch.Tensor, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One generation-side pyramid step → ``(f̂', next_input)``:
    ``next_input`` is f̂' downsampled to scale ``si+1``'s grid (f̂' itself
    after the last scale)."""
    cfg = vq.cfg
    B, pn = f_hat.shape[0], cfg.patch_nums[si]
    h = up_bicubic(embed_ids(vq, ids).reshape(B, pn, pn, cfg.c_vae), cfg.grid)
    f_hat = f_hat + phi_apply(vq, h.to(f_hat.dtype), si)
    nxt = down_area(f_hat, cfg.patch_nums[si + 1]) if si + 1 < cfg.num_scales else f_hat
    return f_hat, nxt


def encode_to_scales(vq: MSVQ, f: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Encode-side greedy residual quantization: latent ``f [B, pN, pN, C]``
    → (per-scale ids ``[B, pn²]``, f̂), f̂ equal to replaying the ids
    through :func:`accumulate_scale`."""
    cfg = vq.cfg
    B = f.shape[0]
    f_hat = torch.zeros_like(f)
    cb = vq.codebook
    ids_list: List[torch.Tensor] = []
    for si, pn in enumerate(cfg.patch_nums):
        z = down_area(f - f_hat, pn).reshape(B * pn * pn, cfg.c_vae)
        d = (z ** 2).sum(-1, keepdim=True) - 2.0 * z @ cb.T + (cb ** 2).sum(-1)[None, :]
        idx = torch.argmin(d, dim=-1).reshape(B, pn * pn)
        ids_list.append(idx)
        h = embed_ids(vq, idx).reshape(B, pn, pn, cfg.c_vae)
        f_hat = f_hat + phi_apply(vq, up_bicubic(h, cfg.grid), si)
    return ids_list, f_hat


def decode_img(vq: MSVQ, f_hat: torch.Tensor) -> torch.Tensor:
    """f̂ ``[B, pN, pN, C]`` → images ``[B, H, W, 3]`` in [0, 1]: the
    post-quant conv, the CompVis decoder and ``(clip(x, -1, 1) + 1) / 2``."""
    return vq.decoder(f_hat)
