"""Z-Image-Turbo-style single-stream flow-matching DiT.

Port of ``hyperscalees_t2i_tpu/models/zimage.py``: text tokens and 2×2
patchified image tokens share one sequence (padded text key-masked with
``-1e30``), timestep AdaLN-6 modulation, axial 3-band RoPE (text index, row,
column) on q/k, per-head QK-RMSNorm with learned scales, a SwiGLU FFN whose
gate and up projections are one ``[d, 2·hid]`` matmul, and the rectified-flow
Euler sampler over the SD3-shifted times.

:func:`init_zimage` builds the JAX package's tree (blocks stacked ``[L,
...]``); :class:`ZImageTransformer` holds it as buffers, one
:class:`ZImageBlock` per layer (``nn.slice_stacked`` views). On the int8
base (``ops.quant.quantize_tree``) the four adapted block sites ``qkv``,
``attn_proj``, ``fc1``, ``fc2`` run K3 under ``pop_fuse`` (K1 plus the
adapter's delta otherwise), the embedders, ``final_ada`` and ``proj_out``
run K1's f32 route, and the AdaLN modulation dequantizes ``ada_lin`` one
layer at a time (the numbers of the JAX package's whole-stack
``resolve_kernel``, without a 10.6 GB f32 copy at Z-Image-Turbo's widths).
The joint attention is a plain f32 softmax, as the JAX package's einsum.

Rows are lane-major: ``n`` lanes of ``b`` images, so a lane-stacked adapter
(or a laned ``lora.FactoredDelta``) gives each lane its own adapter.
Nothing in :func:`generate_latents` copies from the host (the flow times are
``device.constant`` tensors), so a CUDA graph can capture a call whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..device import constant
from ..lora import LoRASpec, lookup, slice_layer
from ..ops.quant import dequantize_kernel
from ..utils import threefry
from . import nn, sana

Params = Dict[str, Any]

ZIMAGE_LORA_TARGETS: Tuple[str, ...] = ("qkv", "attn_proj", "fc1", "fc2")
NEG_INF = -1e30  # the joint attention's key-mask logit (the JAX package's)


@dataclasses.dataclass(frozen=True)
class ZImageConfig:
    in_channels: int = 16
    patch_size: int = 2
    d_model: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    caption_dim: int = 2048
    ff_ratio: float = 4.0
    time_freq_dim: int = 256
    num_steps: int = 8  # Turbo: few-step distilled
    shift: float = 3.0  # SD3/flow time shift
    guidance_scale: float = 0.0  # distilled: no CFG by default
    qk_norm: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden(self) -> int:
        # round, not truncate: ff_ratio may be an inferred hid/d float
        return round(self.d_model * self.ff_ratio)

    def lora_spec(self, rank: int = 8, alpha: float = 16.0) -> LoRASpec:
        return LoRASpec(rank=rank, alpha=alpha, targets=ZIMAGE_LORA_TARGETS)


def init_zimage(cfg: ZImageConfig, key: torch.Tensor,
                node_fn: Optional[Callable[[Params], Params]] = None) -> Params:
    """The JAX package's ``init_zimage`` draws on the key's device.
    ``node_fn`` (default: none) is applied to each dense node as soon as it
    is drawn, so a caller can cast and quantize the tree node by node and
    never hold it whole in f32 (≈ 32 GB at Z-Image-Turbo's widths)."""
    fn = node_fn or (lambda p: p)
    d, L, hid, dh = cfg.d_model, cfg.n_layers, cfg.hidden, cfg.head_dim
    pp = cfg.patch_size * cfg.patch_size * cfg.in_channels
    dev = key.device
    ks = threefry.split(key, 12)
    te = nn.mlp_embedder_init(ks[2], cfg.time_freq_dim, d)
    p: Params = {
        "patch_embed": fn(nn.dense_init(ks[0], pp, d)),
        "caption_norm": {"scale": torch.ones(cfg.caption_dim, device=dev)},
        "caption_proj": fn(nn.dense_init(ks[1], cfg.caption_dim, d)),
        "time_embed": {k: fn(v) for k, v in te.items()},
        "blocks": {
            "ada_lin": fn(nn.stacked_dense_init(ks[3], L, d, 6 * d, std=0.02)),
            "qkv": fn(nn.stacked_dense_init(ks[4], L, d, 3 * d)),
            "attn_proj": fn(nn.stacked_dense_init(ks[5], L, d, d, std=0.02 / math.sqrt(2 * L))),
            "fc1": fn(nn.stacked_dense_init(ks[6], L, d, 2 * hid)),
            "fc2": fn(nn.stacked_dense_init(ks[7], L, hid, d, std=0.02 / math.sqrt(2 * L))),
        },
        "final_ada": fn(nn.dense_init(ks[8], d, 2 * d, std=0.02)),
        "proj_out": fn(nn.dense_init(ks[9], d, pp)),
    }
    if cfg.qk_norm:
        p["blocks"]["q_norm"] = torch.ones(L, dh, device=dev)
        p["blocks"]["k_norm"] = torch.ones(L, dh, device=dev)
    return p


def axial_rope(Lt: int, gh: int, gw: int, dh: int, theta: float,
               device: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin) [Lt + gh·gw, dh/2]`` f32 of the joint sequence: the head
    dim splits into three rotary bands, text index (text tokens count
    ``0..Lt-1``, image tokens sit at ``Lt``), row and column (0 for text)."""
    f32 = torch.float32
    dhh = ((dh // 4) // 2) * 2
    dhw = dhh
    dt_ = dh - dhh - dhw
    n_img = gh * gw
    t_pos = torch.cat([torch.arange(Lt, dtype=f32, device=device), torch.full((n_img,), float(Lt), device=device)])
    h_pos = torch.cat([torch.zeros(Lt, device=device),
                       torch.arange(gh, dtype=f32, device=device).repeat_interleave(gw)])
    w_pos = torch.cat([torch.zeros(Lt, device=device), torch.arange(gw, dtype=f32, device=device).repeat(gh)])
    cos, sin = [], []
    for pos, dim in ((t_pos, dt_), (h_pos, dhh), (w_pos, dhw)):
        if dim:
            freqs = torch.pow(theta, -torch.arange(0, dim, 2, dtype=f32, device=device) / dim)
            ang = pos[:, None] * freqs[None]
            cos.append(torch.cos(ang))
            sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def joint_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kmask: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``softmax(q·kᵀ/√dh)`` over the keys ``kmask [R, S]`` lets through
    (others get ``-1e30``), f32 logits and softmax (q, k f32 ``[R, S, H,
    dh]``), the probabilities cast to ``dtype`` against v in ``dtype`` →
    ``[R, S, H·dh]``."""
    R, S, H, dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    logits = logits.masked_fill(~kmask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    del logits
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype)).reshape(R, S, H * dh)


class ZImageBlock(tnn.Module):
    """One block, from layer ``i`` of the stacked tree."""

    def __init__(self, bp: Params, i: int):
        super().__init__()
        for k in ZIMAGE_LORA_TARGETS:
            setattr(self, k, nn.Dense(nn.slice_stacked(bp[k], i)))
        self.qk_norm = "q_norm" in bp
        if self.qk_norm:
            self.register_buffer("q_norm", bp["q_norm"][i])
            self.register_buffer("k_norm", bp["k_norm"][i])

    def forward(self, x: torch.Tensor, cond6: torch.Tensor, kmask: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], cfg: ZImageConfig, lora: Dict[str, Any],
                lora_scale: float) -> torch.Tensor:
        """``x [R, S, d]`` in the compute dtype, ``cond6 [R, 6, d]`` f32 in
        the (gate, scale, shift) × (attention, FFN) order."""
        R, S, d = x.shape
        H, dh, dt, eps = cfg.n_heads, cfg.head_dim, cfg.compute_dtype, cfg.norm_eps
        g1, s1, b1, g2, s2, b2 = (cond6[:, j][:, None, :].to(dt) for j in range(6))
        h = nn.layer_norm(x, eps=eps) * (1.0 + s1) + b1
        q, k, v = (t.reshape(R, S, H, dh) for t in torch.chunk(self.qkv(h, lora.get("qkv"), lora_scale), 3, dim=-1))
        if self.qk_norm:
            q = nn.rms_norm(q, eps=eps) * self.q_norm.to(q.dtype)
            k = nn.rms_norm(k, eps=eps) * self.k_norm.to(k.dtype)
        q = nn.apply_rope(q.to(torch.float32), *rope)
        k = nn.apply_rope(k.to(torch.float32), *rope)
        out = joint_attention(q, k, v, kmask, dt).to(dt)
        x = x + g1 * self.attn_proj(out, lora.get("attn_proj"), lora_scale)
        h = nn.layer_norm(x, eps=eps) * (1.0 + s2) + b2
        gate, up = torch.chunk(self.fc1(h, lora.get("fc1"), lora_scale), 2, dim=-1)
        h = self.fc2(F.silu(gate) * up, lora.get("fc2"), lora_scale)
        return x + g2 * h.to(dt)


class ZImageTransformer(tnn.Module):
    """The DiT of one parameter tree: embedders, ``ada_lin`` (stacked), the
    blocks, the final AdaLN and the output projection."""

    def __init__(self, cfg: ZImageConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Dense(params["patch_embed"])
        cap = params.get("caption_norm")
        self.register_buffer("caption_norm", None if cap is None else cap["scale"])
        self.caption_proj = nn.Dense(params["caption_proj"])
        self.time_embed = nn.MLPEmbedder(params["time_embed"])
        self.ada_lin = nn.Dense(params["blocks"]["ada_lin"])  # stacked [L, d, 6d]
        self.blocks = tnn.ModuleList(ZImageBlock(params["blocks"], i) for i in range(cfg.n_layers))
        self.final_ada = nn.Dense(params["final_ada"])
        self.proj_out = nn.Dense(params["proj_out"])

    def lora_sites(self) -> Dict[str, str]:
        """Module name → adapter path of every dense site that reads an adapter."""
        return {f"blocks.{i}.{k}": f"blocks/{k}" for i in range(len(self.blocks)) for k in ZIMAGE_LORA_TARGETS}

    def cond6(self, c: torch.Tensor) -> List[torch.Tensor]:
        """AdaLN-6 of each layer from ``silu(temb)`` (f32 ``[R, d]``): a ``[R,
        6, d]`` f32 tensor per layer; an int8 ``ada_lin`` dequantized one
        layer at a time."""
        node = self.ada_lin.node()
        d, f32 = self.cfg.d_model, torch.float32
        out = []
        for i in range(self.cfg.n_layers):
            layer = nn.slice_stacked(node, i)
            w = layer["kernel"].to(f32) if "kernel" in layer else dequantize_kernel(layer["kernel_q8"], f32)
            out.append((c @ w + layer["bias"].to(f32)).reshape(-1, 6, d))
        return out

    def forward(self, latents: torch.Tensor, t: torch.Tensor, text_emb: torch.Tensor, text_mask: torch.Tensor,
                lora: Optional[Params] = None, lora_scale: float = 1.0,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """Velocity ``v(x_t, t)`` → ``[R, h, w, C]`` f32. ``latents [R, h, w,
        C]``, ``t [R]`` flow times, ``text_emb [R, Lt, caption_dim]``,
        ``text_mask [R, Lt]`` bool; ``rope`` the :func:`axial_rope` tables
        of this geometry (made here when not given)."""
        cfg = self.cfg
        R, h, w, C = latents.shape
        p, dt, f32 = cfg.patch_size, cfg.compute_dtype, torch.float32
        gh, gw = h // p, w // p
        N, Lt = gh * gw, text_emb.shape[1]
        x = latents.reshape(R, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5).reshape(R, N, p * p * C)
        x = self.patch_embed(x.to(f32))
        cap = None if self.caption_norm is None else {"scale": self.caption_norm}
        txt = self.caption_proj(nn.rms_norm(text_emb.to(f32), cap, eps=cfg.norm_eps))
        seq = torch.cat([txt, x], dim=1).to(dt)
        kmask = torch.cat([text_mask.to(torch.bool), torch.ones(R, N, dtype=torch.bool, device=seq.device)], dim=1)
        if rope is None:
            rope = axial_rope(Lt, gh, gw, cfg.head_dim, cfg.rope_theta, seq.device)
        temb = self.time_embed(nn.timestep_embedding(t, cfg.time_freq_dim, scale=1000.0))
        cond6 = self.cond6(F.silu(temb.to(f32)))
        layer_lora = [{} for _ in self.blocks]
        for k in ZIMAGE_LORA_TARGETS:
            leaf = lookup(lora, f"blocks/{k}")
            if leaf is not None:
                for i in range(len(self.blocks)):
                    layer_lora[i][k] = slice_layer(leaf, i)
        for i, blk in enumerate(self.blocks):
            seq = blk(seq, cond6[i], kmask, rope, cfg, layer_lora[i], lora_scale)
        img = seq[:, Lt:]
        fs, fb = torch.chunk(self.final_ada(F.silu(temb)), 2, dim=-1)
        img = nn.layer_norm(img, eps=cfg.norm_eps) * (1.0 + fs[:, None, :].to(dt)) + fb[:, None, :].to(dt)
        out = self.proj_out(img.to(f32))
        return out.reshape(R, gh, gw, p, p, C).permute(0, 1, 3, 2, 4, 5).reshape(R, h, w, C)


def shifted_times(cfg: ZImageConfig, num_steps: Optional[int] = None) -> List[float]:
    """``num_steps + 1`` descending flow times with the SD3 shift ``σ(u) =
    s·u / (1 + (s−1)·u)``, ``u = jnp.linspace(1, 0, num_steps + 1)`` as XLA
    computes it (``sana.pipeline_timesteps``), in f32 (Python floats)."""
    steps = cfg.num_steps if num_steps is None else num_steps
    f = np.float32
    u = np.asarray(sana.pipeline_timesteps(steps, 1.0), f)
    s = f(cfg.shift)
    return [float(v) for v in (s * u) / (f(1.0) + (s - f(1.0)) * u)]


def generate_latents(
    model: ZImageTransformer,
    text_emb: torch.Tensor,  # [R, Lt, caption_dim]
    text_mask: torch.Tensor,  # [R, Lt]
    noise: torch.Tensor,  # [R, h, w, C] starting latents
    num_steps: Optional[int] = None,
    guidance_scale: Optional[float] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """Rectified-flow Euler sampling from ``noise`` → final latents ``[R, h,
    w, C]`` f32: ``num_steps`` velocity passes over :func:`shifted_times`,
    ``x ← x + (σ_{i+1} − σ_i)·v``; with ``guidance_scale > 0`` each pass
    also runs with zero text under an all-masked text mask and takes ``(1 +
    g)·v − g·v_uncond``."""
    cfg = model.cfg
    steps = cfg.num_steps if num_steps is None else num_steps
    g = cfg.guidance_scale if guidance_scale is None else guidance_scale
    R, h, w, _ = noise.shape
    dev = noise.device
    sig = shifted_times(cfg, steps)
    p = cfg.patch_size
    rope = axial_rope(text_emb.shape[1], h // p, w // p, cfg.head_dim, cfg.rope_theta, dev)
    x = noise.to(torch.float32)
    for i in range(steps):
        t = constant([sig[i]], torch.float32, dev).expand(R)
        v = model(x, t, text_emb, text_mask, lora, lora_scale, rope)
        if g > 0.0:
            v_un = model(x, t, torch.zeros_like(text_emb), torch.zeros_like(text_mask), lora, lora_scale, rope)
            v = (1.0 + g) * v - g * v_un
        x = x + float(np.float32(sig[i + 1]) - np.float32(sig[i])) * v.to(torch.float32)
    return x
