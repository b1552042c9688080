"""Text-conditional bitwise next-scale AR transformer (Infinity).

Port of ``hyperscalees_t2i_tpu/models/infinity.py``. Each block: AdaLN-6
from the pooled text, KV-cached block-causal self-attention over the scale
pyramid (optionally QK-l2 with learned per-head scales and 2D RoPE),
cross-attention into the padded text behind a learned always-visible null
token, and a tanh-GELU MLP. The head predicts ``bits`` binary logits per
position, sampled per bit after classifier-free guidance ``t(si)`` and
temperature ``τ(si)`` from per-scale schedules, then the BSQ pyramid
(``models/bsq.py``) and its decoder.

:func:`init_infinity` builds the JAX package's tree (blocks stacked
``[depth, ...]``); :class:`InfinityTransformer` holds it as buffers, one
:class:`InfinityBlock` per layer (``nn.slice_stacked`` views). In
:func:`generate` the text K/V of every layer is projected once
(:func:`precompute_cross_kv`), the self-attention cache ``[depth, rows, L,
H, dh]`` is zeroed once a call (a caller-owned workspace, or allocated by
the call) and written in place at each scale's static offset, and both
attentions of every layer are the kernel K4
(``ops.attention.decode_attention``): against the cache prefix, and
against the text under its key mask.

Under the int8 base (``ops.quant.quantize_tree``) every stacked block
projection is an int8 node: the adapted sites run K3 (``pop_fuse``) or K1
plus the adapter's delta, ``text_proj``, ``pool_proj``, ``word_embed`` and
``head`` run K1, and the AdaLN modulation dequantizes ``ada_lin`` one
layer at a time, as the JAX package's ``resolve_kernel`` does for the
whole stack.

Nothing in :func:`generate` copies from the host: the 2D RoPE tables are
the model's buffers (built once, :func:`rope2d_pyramid`), so a CUDA graph
can capture a call whole.

Lanes and CFG rows: as in ``models/var.py``, ``n`` lanes (adapters) of
``b`` images run together, rows ordered ``[lane][cond | uncond][image]``,
so a lane-stacked LoRA gives each lane its own adapter on its cond and
uncond rows, the text projections of ``cross_kv`` included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..lora import lookup, slice_layer
from ..ops.attention import decode_attention
from ..ops.quant import dequantize_kernel
from ..utils import threefry
from . import bsq, nn

Params = Dict[str, Any]

# the seven projections of a block; the adapter paths are blocks/<site>
INFINITY_LORA_TARGETS: Tuple[str, ...] = ("qkv", "attn_proj", "cross_q", "cross_kv", "cross_proj", "fc1", "fc2")

# model-size presets (depth, width, heads)
INFINITY_PRESETS: Dict[str, Dict[str, int]] = {
    "layer12": dict(depth=12, d_model=768, n_heads=12),
    "layer16": dict(depth=16, d_model=1024, n_heads=16),
    "layer24": dict(depth=24, d_model=1536, n_heads=16),
    "layer32": dict(depth=32, d_model=2080, n_heads=20),
    "layer40": dict(depth=40, d_model=2688, n_heads=24),
    "layer48": dict(depth=48, d_model=3360, n_heads=28),
    "2b": dict(depth=32, d_model=2048, n_heads=16),
    "8b": dict(depth=40, d_model=3584, n_heads=28),
}

# scale schedules ("pn"); 1M is the 1024×1024 schedule, 14 scales to 64×64
PN_PRESETS: Dict[str, Tuple[int, ...]] = {
    "0.06M": (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    "0.25M": (1, 2, 3, 4, 6, 9, 13, 18, 24, 32),
    "1M": (1, 2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 36, 48, 64),
}

# BSQ bits of a variant's released tokenizer (Infinity-2B's is 32-bit)
RELEASED_BSQ_BITS: Dict[str, int] = {"2b": 32}


@dataclasses.dataclass(frozen=True)
class InfinityConfig:
    depth: int = 16
    d_model: int = 1024
    n_heads: int = 16
    ff_ratio: float = 4.0
    text_dim: int = 2048  # T5-XL hidden size
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    vq: bsq.BSQConfig = dataclasses.field(default_factory=bsq.BSQConfig)
    cfg_scale: float = 3.0
    tau: float = 0.5
    # the released checkpoints' attention: QK-l2 with learned per-head
    # scales, 2D RoPE over the pyramid, QK-l2 cross-attention
    attn_l2_norm: bool = False
    cross_attn_l2_norm: bool = False
    use_rope2d: bool = False
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def seq_len(self) -> int:
        return int(sum(p * p for p in self.patch_nums))


def from_preset(model_type: str, **overrides) -> InfinityConfig:
    kw = dict(INFINITY_PRESETS[model_type])
    kw.update(overrides)
    return InfinityConfig(**kw)


def released_config(variant: str, pn: Optional[str] = None) -> InfinityConfig:
    """A preset as its released checkpoint configures it, for the variants
    whose tokenizer is recorded in :data:`RELEASED_BSQ_BITS` (others raise):
    the QK-l2, 2D RoPE and QK-l2 cross-attention flags that
    ``weights/infinity.py``'s ``infer_infinity_config`` sets from such a
    checkpoint, the tokenizer's bits, and the ``pn`` schedule on both the
    transformer and the tokenizer."""
    if variant not in RELEASED_BSQ_BITS:
        raise ValueError(f"no released configuration is recorded for infinity variant {variant!r} "
                         f"(recorded: {sorted(RELEASED_BSQ_BITS)})")
    pns = PN_PRESETS[pn] if pn else InfinityConfig.patch_nums
    vq = bsq.BSQConfig(bits=RELEASED_BSQ_BITS[variant], patch_nums=pns)
    return from_preset(variant, attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True, patch_nums=pns, vq=vq)


def init_infinity(cfg: InfinityConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout (the BSQ tree
    included), drawn on the key's device from its key tree
    (``init_infinity(key, cfg)``)."""
    d, D, H = cfg.d_model, cfg.depth, cfg.n_heads
    hid = int(d * cfg.ff_ratio)
    S, L, C = len(cfg.patch_nums), cfg.seq_len, cfg.vq.bits
    dev = key.device
    out_std = 0.02 / math.sqrt(2 * D)
    ks = threefry.split(key, 20)
    params: Params = {
        "text_proj": nn.dense_init(ks[0], cfg.text_dim, d),
        "null_text": threefry.normal(ks[1], (1, 1, d)) * 0.02,
        "pool_proj": nn.dense_init(ks[2], d, d),
        "pos_start": threefry.normal(ks[3], (1, 1, d)) * 0.02,
        "lvl_emb": threefry.normal(ks[4], (S, d)) * 0.02,
        # with 2D RoPE, RoPE carries all positional structure: no learned
        # table on top (the JAX package draws one and zeroes it)
        "pos_emb": torch.zeros((L, d), device=dev) if cfg.use_rope2d else threefry.normal(ks[5], (L, d)) * 0.02,
        "word_embed": nn.dense_init(ks[6], C, d),
        "blocks": {
            "ada_lin": nn.stacked_dense_init(ks[7], D, d, 6 * d, std=0.02),
            "qkv": nn.stacked_dense_init(ks[8], D, d, 3 * d),
            "attn_proj": nn.stacked_dense_init(ks[9], D, d, d, std=out_std),
            "cross_q": nn.stacked_dense_init(ks[10], D, d, d),
            "cross_kv": nn.stacked_dense_init(ks[11], D, d, 2 * d),
            "cross_proj": nn.stacked_dense_init(ks[12], D, d, d, std=out_std),
            "fc1": nn.stacked_dense_init(ks[13], D, d, hid),
            "fc2": nn.stacked_dense_init(ks[14], D, hid, d, std=out_std),
        },
        "head_norm": nn.norm_init(d, dev),
        "head": nn.dense_init(ks[15], d, 2 * C, std=0.02),
        "vq": bsq.init_bsq(cfg.vq, ks[16]),
    }
    if cfg.attn_l2_norm:
        params["blocks"]["scale_mul"] = torch.full((D, H), math.log(4.0), device=dev)
    if cfg.cross_attn_l2_norm:
        params["blocks"]["cross_scale_mul"] = torch.full((D, H), math.log(4.0), device=dev)
    return params


def schedule(vals: Optional[Sequence[float]], default: float, S: int) -> List[float]:
    """Per-scale schedule: a scalar or list padded with its last value (or
    truncated) to ``S`` entries; ``None`` → ``default`` everywhere."""
    if vals is None:
        return [float(default)] * S
    vals = [float(v) for v in (vals if isinstance(vals, (list, tuple)) else [vals])]
    if len(vals) >= S:
        return vals[:S]
    return vals + [vals[-1]] * (S - len(vals))


def scale_slices(patch_nums: Sequence[int]) -> List[Tuple[int, int]]:
    """Static ``(start, n)`` of each scale in the flat L-sequence."""
    out, pos = [], 0
    for pn in patch_nums:
        out.append((pos, pn * pn))
        pos += pn * pn
    return out


def rope2d_pyramid(cfg: InfinityConfig, device: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin) [L, dh/2]`` f32, interleaved-pair angles for the whole
    pyramid: the head dim splits into a row band and a column band (dh/4
    pairs each), positions are patch centres normalized to the final grid,
    ``(r + 0.5) / pn · grid``, so a spatial location has one phase at every
    scale. Built in float64 numpy, then cast and copied to ``device``
    (:class:`InfinityTransformer` does it once, for its buffers)."""
    dh = cfg.head_dim
    if dh % 4:
        raise ValueError(f"use_rope2d needs head_dim % 4 == 0, got {dh}")
    grid = cfg.patch_nums[-1]
    rows, cols = [], []
    for pn in cfg.patch_nums:
        r = (np.arange(pn, dtype=np.float64) + 0.5) / pn * grid
        rr, cc = np.meshgrid(r, r, indexing="ij")
        rows.append(rr.reshape(-1))
        cols.append(cc.reshape(-1))
    half = dh // 2
    cos_l, sin_l = [], []
    for pos in (np.concatenate(rows), np.concatenate(cols)):
        freqs = cfg.rope_theta ** (-np.arange(0, half, 2, dtype=np.float64) / half)
        ang = pos[:, None] * freqs[None]
        cos_l.append(np.cos(ang))
        sin_l.append(np.sin(ang))
    to = lambda a: torch.from_numpy(np.concatenate(a, -1).astype(np.float32)).to(device)  # noqa: E731
    return to(cos_l), to(sin_l)


class InfinityBlock(tnn.Module):
    """One block, from layer ``i`` of the stacked tree."""

    def __init__(self, bp: Params, i: int):
        super().__init__()
        for k in INFINITY_LORA_TARGETS:
            setattr(self, k, nn.Dense(nn.slice_stacked(bp[k], i)))
        for k in ("scale_mul", "cross_scale_mul"):
            if k in bp:
                self.register_buffer(k, bp[k][i])

    def forward(self, x: torch.Tensor, cond6: torch.Tensor, kC: torch.Tensor, vC: torch.Tensor, pos: int,
                ck: torch.Tensor, cv: torch.Tensor, text_mask: torch.Tensor, cfg: InfinityConfig,
                lora: Dict[str, Any], lora_scale: float,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """``x [R, n, d]`` of one scale: writes its K, V into ``kC``/``vC
        [R, L, H, dh]`` at ``pos``, attends to the prefix ``[0, pos+n)``,
        then to the text ``ck``/``cv [R, Lt, H, dh]`` under ``text_mask``."""
        R, n, d = x.shape
        H, dh, dt = cfg.n_heads, cfg.head_dim, cfg.compute_dtype
        g1, s1, b1, g2, s2, b2 = (cond6[:, j][:, None, :].to(dt) for j in range(6))

        h = nn.layer_norm(x) * (1.0 + s1) + b1
        q, k, v = (t.reshape(R, n, H, dh) for t in torch.chunk(self.qkv(h, lora.get("qkv"), lora_scale), 3, dim=-1))
        if cfg.attn_l2_norm:
            q, k = nn.qk_l2(q, k, self.scale_mul)
        if rope is not None:
            cos, sin = rope[0][pos:pos + n], rope[1][pos:pos + n]
            q = nn.apply_rope(q.to(torch.float32), cos, sin).to(dt)
            k = nn.apply_rope(k.to(torch.float32), cos, sin).to(dt)
        kC[:, pos:pos + n] = k
        vC[:, pos:pos + n] = v
        out = decode_attention(q, kC, vC, kv_len=pos + n, sm_scale=1.0 if cfg.attn_l2_norm else None)
        x = x + g1 * self.attn_proj(out.to(dt).reshape(R, n, d), lora.get("attn_proj"), lora_scale)

        cq = self.cross_q(nn.layer_norm(x), lora.get("cross_q"), lora_scale).reshape(R, n, H, dh)
        ca_scale = None
        if cfg.cross_attn_l2_norm:
            cq, ca_scale = nn.q_l2(cq, self.cross_scale_mul), 1.0
        cout = decode_attention(cq, ck, cv, kv_mask=text_mask, sm_scale=ca_scale)
        x = x + self.cross_proj(cout.to(dt).reshape(R, n, d), lora.get("cross_proj"), lora_scale)

        h2 = nn.layer_norm(x) * (1.0 + s2) + b2
        h2 = self.fc2(nn.gelu_tanh(self.fc1(h2, lora.get("fc1"), lora_scale)), lora.get("fc2"), lora_scale)
        return x + g2 * h2.to(dt)


class InfinityTransformer(tnn.Module):
    """The transformer, its text and head layers and the BSQ tokenizer of
    one parameter tree. A tree with ``head_ada`` (a converted checkpoint)
    modulates the head's LayerNorm; a random-init one keeps the affine
    ``head_norm``."""

    def __init__(self, cfg: InfinityConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for k in ("null_text", "pos_start", "lvl_emb", "pos_emb"):
            self.register_buffer(k, params[k])
        for k in ("text_proj", "pool_proj", "word_embed", "head"):
            setattr(self, k, nn.Dense(params[k]))
        self.ada_lin = nn.Dense(params["blocks"]["ada_lin"])  # stacked [depth, d, 6d]
        self.blocks = tnn.ModuleList(InfinityBlock(params["blocks"], i) for i in range(cfg.depth))
        if "head_ada" in params:
            self.head_ada = nn.Dense(params["head_ada"])
        else:
            self.head_ada = None
            self.register_buffer("head_scale", params["head_norm"]["scale"])
            self.register_buffer("head_bias", params["head_norm"]["bias"])
        self.vq = bsq.BSQ(cfg.vq, params["vq"])
        if cfg.use_rope2d:
            cos, sin = rope2d_pyramid(cfg, self.pos_emb.device)
            self.register_buffer("rope_cos", cos)
            self.register_buffer("rope_sin", sin)

    @property
    def rope(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """``(cos, sin) [L, dh/2]`` of the 2D RoPE, or ``None`` without it."""
        return (self.rope_cos, self.rope_sin) if self.cfg.use_rope2d else None

    def lora_sites(self) -> Dict[str, str]:
        """Module name → adapter path of every dense site that reads an adapter."""
        return {f"blocks.{i}.{k}": f"blocks/{k}" for i in range(len(self.blocks)) for k in INFINITY_LORA_TARGETS}

    def cond6(self, c: torch.Tensor) -> List[torch.Tensor]:
        """AdaLN modulation of each layer from ``silu(cond)``, in f32: a
        ``[rows, 6, d]`` tensor per layer. An int8 ``ada_lin`` is
        dequantized one layer at a time (the numbers of the JAX package's
        whole-stack ``resolve_kernel``, without an f32 copy of the stack)."""
        node = self.ada_lin.node()
        d, f32 = self.cfg.d_model, torch.float32
        out = []
        for i in range(self.cfg.depth):
            layer = nn.slice_stacked(node, i)
            w = layer["kernel"].to(f32) if "kernel" in layer else dequantize_kernel(layer["kernel_q8"], f32)
            out.append((c @ w + layer["bias"].to(f32)).reshape(-1, 6, d))
        return out

    def head_logits(self, h: torch.Tensor, hs: Optional[torch.Tensor], hb: Optional[torch.Tensor]) -> torch.Tensor:
        """Head LayerNorm (AdaLN with ``head_ada``) and the bit head → f32."""
        dt = self.cfg.compute_dtype
        if self.head_ada is not None:
            h = nn.layer_norm(h) * (1.0 + hs[:, None, :].to(dt)) + hb[:, None, :].to(dt)
        else:
            h = nn.layer_norm(h, {"scale": self.head_scale, "bias": self.head_bias})
        return self.head(h).to(torch.float32)


def _layer_lora(lora: Optional[Params], i: int) -> Dict[str, Any]:
    out = {}
    for k in INFINITY_LORA_TARGETS:
        leaf = lookup(lora, f"blocks/{k}")
        if leaf is not None:
            out[k] = slice_layer(leaf, i)
    return out


def precompute_cross_kv(model: InfinityTransformer, text_kv: torch.Tensor, lora: Optional[Params],
                        lora_scale: float) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each layer's cross-attention K and V of the projected text ``[R, Lt,
    d]`` (null token first), computed once a generation: ``(ck, cv)``,
    lists of ``[R, Lt, H, dh]``; ck unit-normalized under
    ``cross_attn_l2_norm`` (the learned scale multiplies q only)."""
    cfg = model.cfg
    R, Lt, _ = text_kv.shape
    ck, cv = [], []
    for i, block in enumerate(model.blocks):
        leaf = slice_layer(lookup(lora, "blocks/cross_kv"), i)
        k, v = (t.reshape(R, Lt, cfg.n_heads, cfg.head_dim)
                for t in torch.chunk(block.cross_kv(text_kv, leaf, lora_scale), 2, dim=-1))
        if cfg.cross_attn_l2_norm:
            k = nn.l2_normalize(k).to(k.dtype)
        ck.append(k)
        cv.append(v)
    return ck, cv


def sample_bits(lg: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Each bit from its two guided, tempered logits ``lg [..., 2]`` and
    Gumbel noise of the same shape: ``argmax(lg + gumbel)`` in f32."""
    return torch.argmax(lg + gumbel.to(torch.float32), dim=-1)


def generate(
    model: InfinityTransformer,
    text_emb: torch.Tensor,  # [n, b, Lt, text_dim] padded text features, one row per lane
    text_mask: torch.Tensor,  # [n, b, Lt] bool
    gumbel: torch.Tensor,  # [n, b, L, bits, 2] sampling noise
    cfg_list: Optional[Sequence[float]] = None,
    tau_list: Optional[Sequence[float]] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
    decode: bool = True,
    workspace: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """KV-cached bitwise next-scale generation for ``n`` lanes of ``b``
    images → images ``[n, b, H, W, 3]`` in [0, 1] (f̂ ``[n, b, pN, pN,
    bits]`` f32 with ``decode=False``).

    ``workspace`` is the KV cache ``(kC, vC)``, each ``[depth, 2·n·b, L,
    H, dh]`` in the compute dtype on the model's device, owned by the
    caller and zeroed here (as the JAX package's ``jnp.zeros``); without it
    the call allocates its own. The outputs are the same either way.

    ``lora`` is one adapter, or ``n`` lane-stacked adapters. Scale ``si``
    samples image ``(i, j)``'s bits as ``argmax(lg + gumbel[i, j, pos_si :
    pos_si + pn²])`` over the bit's two logits, ``lg = ((1 + t)·cond − t·uncond)
    / max(τ, 1e-5)`` in f32: the JAX package's ``jax.random.categorical``
    with the noise given. ``cfg_list``/``tau_list`` are the per-scale
    schedules (default: ``cfg.cfg_scale``, ``cfg.tau``)."""
    cfg = model.cfg
    n, b, Lt, _ = text_emb.shape
    d, H, dh, S, L, C = cfg.d_model, cfg.n_heads, cfg.head_dim, len(cfg.patch_nums), cfg.seq_len, cfg.vq.bits
    dt, f32 = cfg.compute_dtype, torch.float32
    dev = model.pos_emb.device
    R = 2 * n * b
    cfgs = schedule(cfg_list, cfg.cfg_scale, S)
    taus = schedule(tau_list, cfg.tau, S)

    # project the text; prepend the null token, the uncond rows' whole text
    txt = model.text_proj(text_emb.to(device=dev, dtype=f32))  # [n, b, Lt, d]
    txt = torch.cat([model.null_text.to(f32).expand(n, b, 1, d), txt], dim=2)
    mask = torch.cat([torch.ones(n, b, 1, dtype=torch.bool, device=dev), text_mask.to(dev)], dim=2)
    null_only = torch.zeros_like(mask)
    null_only[..., 0] = True
    # rows [lane][cond | uncond][image]: both halves read the same text, the
    # uncond half only its null token
    txt2 = txt[:, None].expand(n, 2, b, Lt + 1, d).reshape(R, Lt + 1, d).to(dt)
    mask2 = torch.stack([mask, null_only], dim=1).reshape(R, Lt + 1)

    denom = mask2.sum(-1, keepdim=True).clamp(min=1).to(f32)
    pooled = (txt2.to(f32) * mask2[..., None]).sum(1) / denom
    cond = model.pool_proj(pooled)  # [R, d]
    c = F.silu(cond)
    cond6_all = model.cond6(c)
    hs = hb = None
    if model.head_ada is not None:
        hs, hb = torch.chunk(model.head_ada(c), 2, dim=-1)

    shape = (cfg.depth, R, L, H, dh)
    if workspace is None:
        kC = torch.zeros(shape, dtype=dt, device=dev)
        vC = torch.zeros_like(kC)
    else:
        kC, vC = workspace
        for t in (kC, vC):
            if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
                raise ValueError(f"the KV workspace is {tuple(t.shape)} {t.dtype} on {t.device}, the call needs "
                                 f"{shape} {dt} on {dev}")
            t.zero_()
    f_hat = torch.zeros((n * b, cfg.vq.grid, cfg.vq.grid, C), dtype=f32, device=dev)
    rope = model.rope
    ck, cv = precompute_cross_kv(model, txt2, lora, lora_scale)
    layer_lora = [_layer_lora(lora, i) for i in range(cfg.depth)]

    x = (cond[:, None, :] + model.pos_start + model.lvl_emb[0][None, None, :] + model.pos_emb[None, :1, :]).to(dt)
    for si, (pos, nt) in enumerate(scale_slices(cfg.patch_nums)):
        for i, block in enumerate(model.blocks):
            x = block(x, cond6_all[i], kC[i], vC[i], pos, ck[i], cv[i], mask2, cfg, layer_lora[i], lora_scale, rope)
        logits = model.head_logits(x, hs, hb).reshape(n, 2, b, nt, C, 2)
        t = cfgs[si]
        lg = ((1.0 + t) * logits[:, 0] - t * logits[:, 1]) / max(taus[si], 1e-5)
        bits = sample_bits(lg, gumbel[:, :, pos:pos + nt].to(dev))
        f_hat, nxt = bsq.accumulate_scale(model.vq, f_hat, bits.reshape(n * b, nt, C), si)
        if si + 1 < S:
            n1 = cfg.patch_nums[si + 1] ** 2
            emb = model.word_embed(nxt.reshape(n * b, n1, C).to(f32))
            nxt_x = emb + model.lvl_emb[si + 1][None, None, :] + model.pos_emb[None, pos + nt:pos + nt + n1, :]
            # cond and uncond rows share the next input
            x = nxt_x.reshape(n, 1, b, n1, d).expand(n, 2, b, n1, d).reshape(R, n1, d).to(dt)

    if not decode:
        return f_hat.reshape(n, b, *f_hat.shape[1:])
    images = bsq.decode_img(model.vq, f_hat)
    return images.reshape(n, b, *images.shape[1:])
