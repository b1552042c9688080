"""Class-conditional next-scale autoregressive transformer (VAR).

Port of ``hyperscalees_t2i_tpu/models/var.py``: class-sos, AdaLN
self-attention blocks with QK-l2 attention, the per-scale CFG ramp and
KV-cached generation over the static ``patch_nums`` pyramid, then the VQ
pyramid (``models/msvq.py``) and its decoder.

:func:`init_var` builds the JAX package's tree (blocks stacked ``[depth,
...]``); :class:`VARTransformer` holds it as buffers, one :class:`VARBlock`
per layer. In :func:`generate` the KV cache ``[depth, rows, L, H, dh]`` is
allocated once and written in place at each scale's static offset, and
every layer's attention against its cache prefix is the kernel K4
(``ops.attention.decode_attention``).

Lanes and CFG rows: the JAX package vmaps ES members, and each member's
batch is ``[cond b; uncond b]``. Here ``n`` lanes (adapters) of ``b``
images run together, rows ordered ``[lane][cond | uncond][image]``, so the
lane-stacked LoRA (``lora.lora_delta``: ``n`` equal row groups) gives each
lane its own adapter on both its cond and its uncond rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..lora import lookup, slice_layer
from ..ops.attention import decode_attention
from ..ops.sampling import sample_top_k_top_p
from ..utils import threefry
from ..utils.pytree import tree_map
from . import msvq, nn

Params = Dict[str, Any]

# the attention and MLP projections of the transformer (never the VQ decoder)
VAR_LORA_TARGETS: Tuple[str, ...] = (
    "blocks/qkv", "blocks/attn_proj", "blocks/fc1", "blocks/fc2",
)
_SITES = ("qkv", "attn_proj", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class VARConfig:
    """Defaults are VAR-d16 (depth 16, d 1024, 16 heads) over the
    ``vae_ch160v4096z32`` VQ-VAE at 256 px; QK-l2 attention as in every
    released VAR build. The sampler's CFG scale, top-k and top-p are
    :func:`generate`'s arguments (the backend's config holds them)."""

    num_classes: int = 1000
    depth: int = 16
    d_model: int = 1024
    n_heads: int = 16
    ff_ratio: float = 4.0
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    vq: msvq.MSVQConfig = dataclasses.field(default_factory=msvq.MSVQConfig)
    attn_l2_norm: bool = True
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def seq_len(self) -> int:
        return int(sum(p * p for p in self.patch_nums))

    @property
    def uncond_label(self) -> int:
        return self.num_classes  # the extra class-table row (CFG null)


def init_var(cfg: VARConfig, key: torch.Tensor) -> Params:
    """Random f32 parameters in the JAX package's tree layout (the VQ tree
    included), drawn on the key's device from its key tree
    (``init_var(key, cfg)``)."""
    d, D, H = cfg.d_model, cfg.depth, cfg.n_heads
    hid = int(d * cfg.ff_ratio)
    S, L = len(cfg.patch_nums), cfg.seq_len
    ks = threefry.split(key, 16)
    params: Params = {
        "class_emb": threefry.normal(ks[0], (cfg.num_classes + 1, d)) * 0.02,
        "pos_start": threefry.normal(ks[1], (1, 1, d)) * 0.02,
        "lvl_emb": threefry.normal(ks[2], (S, d)) * 0.02,
        "pos_emb": threefry.normal(ks[3], (L, d)) * 0.02,
        "word_embed": nn.dense_init(ks[4], cfg.vq.c_vae, d),
        "blocks": {
            "ada_lin": nn.stacked_dense_init(ks[5], D, d, 6 * d, std=0.02),
            "qkv": nn.stacked_dense_init(ks[6], D, d, 3 * d),
            "attn_proj": nn.stacked_dense_init(ks[7], D, d, d, std=0.02 / math.sqrt(2 * D)),
            "fc1": nn.stacked_dense_init(ks[8], D, d, hid),
            "fc2": nn.stacked_dense_init(ks[9], D, hid, d, std=0.02 / math.sqrt(2 * D)),
        },
        "head_ada": nn.dense_init(ks[10], d, 2 * d, std=0.02),
        "head": nn.dense_init(ks[11], d, cfg.vq.vocab_size, std=0.02),
        "vq": msvq.init_msvq(cfg.vq, ks[12]),
    }
    if cfg.attn_l2_norm:
        # learned per-head log attention scale, init log 4
        params["blocks"]["scale_mul"] = torch.full((D, H), math.log(4.0), device=key.device)
    return params


class VARBlock(tnn.Module):
    """One AdaLN self-attention block, from the layer's slice of the tree.
    The callers own the attention itself: :func:`generate` against the KV
    cache (K4), :func:`forward_teacher` block-causal over the sequence."""

    def __init__(self, bp: Params):
        super().__init__()
        for k in _SITES:
            setattr(self, k, nn.Dense(bp[k]))
        if "scale_mul" in bp:
            self.register_buffer("scale_mul", bp["scale_mul"])

    def attention_inputs(self, x: torch.Tensor, mods: Tuple[torch.Tensor, ...], cfg: VARConfig,
                         lora: Dict[str, Any], lora_scale: float):
        """``x [R, n, d]`` → ``(q, k, v [R, n, H, dh], softmax scale)``:
        AdaLN, the qkv projection, QK-l2 (scale 1) or the reference's
        ``0.25/sqrt(dh)`` without it."""
        R, n, _ = x.shape
        _, s1, b1 = mods[:3]
        h = nn.layer_norm(x) * (1.0 + s1) + b1
        q, k, v = (t.reshape(R, n, cfg.n_heads, cfg.head_dim)
                   for t in torch.chunk(self.qkv(h, lora.get("qkv"), lora_scale), 3, dim=-1))
        if cfg.attn_l2_norm:
            q, k = nn.qk_l2(q, k, self.scale_mul)
            return q, k, v, 1.0
        return q, k, v, 0.25 / math.sqrt(cfg.head_dim)

    def finish(self, x: torch.Tensor, attn: torch.Tensor, mods: Tuple[torch.Tensor, ...],
               lora: Dict[str, Any], lora_scale: float) -> torch.Tensor:
        """The gated attention projection and the gated tanh-GELU MLP on
        ``x``, given the attention output ``attn [R, n, d]``."""
        g1, _, _, g2, s2, b2 = mods
        x = x + g1 * self.attn_proj(attn, lora.get("attn_proj"), lora_scale)
        h = nn.layer_norm(x) * (1.0 + s2) + b2
        h = self.fc2(nn.gelu_tanh(self.fc1(h, lora.get("fc1"), lora_scale)), lora.get("fc2"), lora_scale)
        return x + g2 * h.to(x.dtype)

    def forward(self, x: torch.Tensor, cond6: torch.Tensor, kC: torch.Tensor, vC: torch.Tensor, pos: int,
                cfg: VARConfig, lora: Dict[str, Any], lora_scale: float) -> torch.Tensor:
        """``x [R, n, d]`` of one scale: writes its K, V into ``kC``/``vC
        [R, L, H, dh]`` at ``pos`` and attends to the prefix ``[0, pos+n)``."""
        R, n, _ = x.shape
        mods = _modulation(cond6, cfg.compute_dtype)
        q, k, v, sm_scale = self.attention_inputs(x, mods, cfg, lora, lora_scale)
        kC[:, pos:pos + n] = k
        vC[:, pos:pos + n] = v
        attn = decode_attention(q, kC, vC, kv_len=pos + n, sm_scale=sm_scale)
        return self.finish(x, attn.to(cfg.compute_dtype).reshape(R, n, cfg.d_model), mods, lora, lora_scale)


def _modulation(cond6: torch.Tensor, dt: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """``[R, 6, d]`` f32 → the six ``[R, 1, d]`` AdaLN terms (gate, scale,
    shift of attention, then of the MLP) in the compute dtype."""
    return tuple(cond6[:, i][:, None, :].to(dt) for i in range(6))


class VARTransformer(tnn.Module):
    """The transformer, its heads and the VQ-VAE of one parameter tree."""

    def __init__(self, cfg: VARConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        for k in ("class_emb", "pos_start", "lvl_emb", "pos_emb"):
            self.register_buffer(k, params[k])
        self.word_embed = nn.Dense(params["word_embed"])
        blocks = {k: v for k, v in params["blocks"].items() if k != "ada_lin"}
        self.ada_lin = nn.Dense(params["blocks"]["ada_lin"])  # stacked [depth, d, 6d]
        self.blocks = tnn.ModuleList(
            VARBlock(tree_map(lambda a, i=i: a[i], blocks)) for i in range(cfg.depth)
        )
        self.head_ada = nn.Dense(params["head_ada"])
        self.head = nn.Dense(params["head"])
        self.vq = msvq.MSVQ(cfg.vq, params["vq"])

    def lora_sites(self) -> Dict[str, str]:
        """Module name → adapter path of every dense site that reads an adapter."""
        return {f"blocks.{i}.{k}": f"blocks/{k}" for i in range(len(self.blocks)) for k in _SITES}

    def cond6(self, cond: torch.Tensor) -> torch.Tensor:
        """AdaLN modulation of every layer, in f32: ``[depth, rows, 6, d]``."""
        node = self.ada_lin.node()
        c = F.silu(cond.to(torch.float32))
        out = torch.einsum("bd,lde->lbe", c, node["kernel"].to(torch.float32))
        out = out + node["bias"].to(torch.float32)[:, None, :]
        return out.reshape(self.cfg.depth, cond.shape[0], 6, self.cfg.d_model)

    def head_logits(self, h: torch.Tensor, hs: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
        """Head AdaLN and the vocabulary head → f32 logits."""
        dt = self.cfg.compute_dtype
        h = nn.layer_norm(h) * (1.0 + hs[:, None, :].to(dt)) + hb[:, None, :].to(dt)
        return self.head(h).to(torch.float32)


def _layer_lora(lora: Optional[Params], i: int) -> Dict[str, Any]:
    out = {}
    for k in _SITES:
        leaf = lookup(lora, f"blocks/{k}")
        if leaf is not None:
            out[k] = slice_layer(leaf, i)
    return out


def scale_slices(cfg: VARConfig) -> List[Tuple[int, int]]:
    """Static ``(start, n)`` of each scale in the flat L-sequence."""
    out, pos = [], 0
    for pn in cfg.patch_nums:
        out.append((pos, pn * pn))
        pos += pn * pn
    return out


def generate(
    model: VARTransformer,
    labels: torch.Tensor,  # [n, b] class ids, one row per lane
    gumbel: torch.Tensor,  # [n, b, L, V] sampling noise
    cfg_scale: float,
    top_k: int,
    top_p: float,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
    decode: bool = True,
) -> torch.Tensor:
    """KV-cached next-scale generation for ``n`` lanes of ``b`` images →
    images ``[n, b, H, W, 3]`` in [0, 1] (f̂ ``[n, b, pN, pN, C]`` f32 with
    ``decode=False``).

    ``lora`` is one adapter, or ``n`` lane-stacked adapters (lane ``i``'s
    on its own rows). Scale ``si`` samples image ``(i, j)``'s tokens from
    ``gumbel[i, j, pos_si : pos_si + pn²]``: the JAX package's
    ``jax.random.categorical`` with the noise given."""
    cfg = model.cfg
    n, b = labels.shape
    d, H, dh, S, L = cfg.d_model, cfg.n_heads, cfg.head_dim, len(cfg.patch_nums), cfg.seq_len
    dt, vq_cfg = cfg.compute_dtype, cfg.vq
    dev = model.class_emb.device
    R = 2 * n * b

    # rows [lane][cond | uncond][image]
    lbl2 = torch.stack([labels, torch.full_like(labels, cfg.uncond_label)], dim=1).reshape(R).to(dev)
    cond = model.class_emb[lbl2]  # [R, d]
    cond6_all = model.cond6(cond)
    hs, hb = torch.chunk(model.head_ada(F.silu(cond)), 2, dim=-1)

    kC = torch.zeros((cfg.depth, R, L, H, dh), dtype=dt, device=dev)
    vC = torch.zeros_like(kC)
    f_hat = torch.zeros((n * b, vq_cfg.grid, vq_cfg.grid, vq_cfg.c_vae), dtype=torch.float32, device=dev)
    x = (cond[:, None, :] + model.pos_start + model.lvl_emb[0][None, None, :] + model.pos_emb[None, :1, :]).to(dt)
    layer_lora = [_layer_lora(lora, i) for i in range(cfg.depth)]

    for si, (pos, nt) in enumerate(scale_slices(cfg)):
        for i, block in enumerate(model.blocks):
            x = block(x, cond6_all[i], kC[i], vC[i], pos, cfg, layer_lora[i], lora_scale)
        logits = model.head_logits(x, hs, hb).reshape(n, 2, b, nt, -1)
        t = cfg_scale * si / max(S - 1, 1)  # per-scale CFG ramp
        lg = (1.0 + t) * logits[:, 0] - t * logits[:, 1]  # [n, b, nt, V]
        ids = sample_top_k_top_p(lg, gumbel[:, :, pos:pos + nt], top_k=top_k, top_p=top_p).reshape(n * b, nt)
        f_hat, nxt = msvq.accumulate_scale(model.vq, f_hat, ids, si)
        if si + 1 < S:
            n1 = cfg.patch_nums[si + 1] ** 2
            emb = model.word_embed(nxt.reshape(n * b, n1, vq_cfg.c_vae).to(torch.float32))
            nxt_x = emb + model.lvl_emb[si + 1][None, None, :] + model.pos_emb[None, pos + nt:pos + nt + n1, :]
            # cond and uncond rows share the next input
            x = nxt_x.reshape(n, 1, b, n1, d).expand(n, 2, b, n1, d).reshape(R, n1, d).to(dt)

    if not decode:
        return f_hat.reshape(n, b, *f_hat.shape[1:])
    images = msvq.decode_img(model.vq, f_hat)
    return images.reshape(n, b, *images.shape[1:])


def forward_teacher(
    model: VARTransformer,
    labels: torch.Tensor,  # [B]
    scale_inputs: torch.Tensor,  # [B, L, c_vae] next-scale inputs
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """Teacher-forced full-sequence forward → logits ``[B, L, V]`` f32, with
    block-causal attention (a token sees every earlier scale and its own).
    The tests hold the KV-cached path of :func:`generate` against it."""
    cfg = model.cfg
    B, L, dt = scale_inputs.shape[0], cfg.seq_len, cfg.compute_dtype
    dev = model.class_emb.device
    cond = model.class_emb[labels.to(dev)]
    cond6_all = model.cond6(cond)
    emb = model.word_embed(scale_inputs.to(torch.float32))
    sos = cond[:, None, :] + model.pos_start
    emb = torch.cat([sos + emb[:, :1] * 0.0, emb[:, 1:]], dim=1)
    lvl = torch.cat([torch.full((pn * pn,), i, dtype=torch.long, device=dev)
                     for i, pn in enumerate(cfg.patch_nums)])
    x = (emb + model.lvl_emb[lvl][None] + model.pos_emb[None]).to(dt)
    mask = lvl[:, None] >= lvl[None, :]  # [L, L]
    for i, block in enumerate(model.blocks):
        lo = _layer_lora(lora, i)
        mods = _modulation(cond6_all[i], dt)
        q, k, v, sm_scale = block.attention_inputs(x, mods, cfg, lo, lora_scale)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
        attn = torch.softmax(torch.where(mask[None, None], attn * sm_scale, torch.full((), -1e30, device=dev)), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(dt), v.to(dt)).reshape(B, L, cfg.d_model)
        x = block.finish(x, out, mods, lo, lora_scale)
    hs, hb = torch.chunk(model.head_ada(F.silu(cond)), 2, dim=-1)
    return model.head_logits(x, hs, hb)
