"""Pretrained-weight converters for the Z-Image family (port of
``hyperscalees_t2i_tpu/weights/zimage.py``).

- :func:`convert_zimage_transformer` — the Lumina-style single-stream DiT's
  module names (``x_embedder``, ``cap_embedder.{0,1}``,
  ``t_embedder.mlp.{0,2}``, ``layers.{i}.attention.to_{q,k,v}/norm_{q,k}/
  to_out.0``, ``layers.{i}.feed_forward.w{1,2,3}``,
  ``layers.{i}.adaLN_modulation.1``, ``final_layer.{adaLN_modulation.1,
  linear}``) → the ``models/zimage.py`` tree: per-layer tensors stacked
  ``[L, ...]``, q/k/v fused into one ``[d, 3d]`` kernel, SwiGLU w1 (gate)
  and w3 (up) into one ``[d, 2·hid]`` kernel, the AdaLN rows reordered from
  torch's (shift, scale, gate) to the model's (gate, scale, shift).
- :func:`convert_kl_decoder` — the diffusers ``AutoencoderKL`` decoder
  (``decoder.conv_in``, ``decoder.mid_block.{resnets,attentions}``,
  ``decoder.up_blocks.{i}.{resnets,upsamplers}``, ``decoder.conv_norm_out``,
  ``decoder.conv_out``, optional ``post_quant_conv``) → the
  ``models/vaekl.py`` tree; encoder tensors are ignored (decode only).

Strict consumption accounting as in ``weights/var.py``: an unread tensor
raises with its name. The trees are f32 numpy, bitwise the JAX converters'
(``weights/from_jax.tree_from_numpy`` puts them on a device). GGUF files
load through ``weights/gguf.py`` (``weights/io.load_state_dict`` routes
``.gguf`` there).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from ..models import vaekl, zimage
from .io import StateDict
from .sana import _conv_oihw as _conv  # torch OIHW → HWIO
from .var import _Consumer, _lin, _lin_stack

Params = Dict[str, Any]

_ZIMAGE_IGNORE = re.compile(r"num_batches_tracked$")
# full-VAE checkpoints carry the encoder + its quant conv; we decode only
_VAE_IGNORE = re.compile(r"^(encoder\.|quant_conv\.)|num_batches_tracked$")

# torch AdaLN-6 row order (shift, scale, gate) × (msa, mlp) → our cond6 order
# (gate, scale, shift) × (attn, mlp) — see models/zimage.py forward
_ADA6_PERM = [2, 1, 0, 5, 4, 3]
# final layer: torch (shift, scale) → our (scale, shift)
_ADA2_PERM = [1, 0]


def _fused_stack(g: _Consumer, fmts, L: int) -> Params:
    """Stack several per-layer Linears and fuse them along the output axis:
    [L, d_in, sum(d_out)] — the qkv / SwiGLU gate+up fusions."""
    ws, bs, any_bias = [], [], False
    for i in range(L):
        w = np.concatenate([g(f.format(i) + ".weight").T for f in fmts], axis=1)
        ws.append(w)
        if any(g.has(f.format(i) + ".bias") for f in fmts):
            any_bias = True
            bs.append(
                np.concatenate([
                    g(f.format(i) + ".bias")
                    if g.has(f.format(i) + ".bias")
                    else np.zeros(g(f.format(i) + ".weight").shape[0], np.float32)
                    for f in fmts
                ])
            )
    p: Params = {"kernel": np.asarray(np.stack(ws))}
    if any_bias:
        p["bias"] = np.asarray(np.stack(bs))
    return p


def _perm_rows(w: np.ndarray, perm, d: int) -> np.ndarray:
    """Reorder the output axis of a [k·d, ...] torch weight by d-sized groups."""
    parts = [w[j * d:(j + 1) * d] for j in perm]
    return np.concatenate(parts, axis=0)


def convert_zimage_transformer(sd: StateDict, cfg: zimage.ZImageConfig) -> Params:
    g = _Consumer(sd)
    L, d = cfg.n_layers, cfg.d_model
    blk = "layers.{}."

    ada: Params = {
        "kernel": np.asarray(np.stack([
            _perm_rows(g(blk.format(i) + "adaLN_modulation.1.weight"), _ADA6_PERM, d).T
            for i in range(L)
        ]))
    }
    if g.has("layers.0.adaLN_modulation.1.bias"):
        ada["bias"] = np.asarray(np.stack([
            _perm_rows(g(blk.format(i) + "adaLN_modulation.1.bias"), _ADA6_PERM, d)
            for i in range(L)
        ]))

    fin_w = _perm_rows(g("final_layer.adaLN_modulation.1.weight"), _ADA2_PERM, d)
    fin = {"kernel": np.asarray(fin_w.T)}
    if g.has("final_layer.adaLN_modulation.1.bias"):
        fin["bias"] = np.asarray(
            _perm_rows(g("final_layer.adaLN_modulation.1.bias"), _ADA2_PERM, d)
        )

    blocks: Params = {
        "ada_lin": ada,
        "qkv": _fused_stack(
            g, [blk + "attention.to_q", blk + "attention.to_k", blk + "attention.to_v"], L
        ),
        "attn_proj": _lin_stack(g, blk + "attention.to_out.0", L),
        "fc1": _fused_stack(
            g, [blk + "feed_forward.w1", blk + "feed_forward.w3"], L
        ),
        "fc2": _lin_stack(g, blk + "feed_forward.w2", L),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = np.asarray(
            np.stack([g(blk.format(i) + "attention.norm_q.weight") for i in range(L)])
        )
        blocks["k_norm"] = np.asarray(
            np.stack([g(blk.format(i) + "attention.norm_k.weight") for i in range(L)])
        )

    params: Params = {
        "patch_embed": _lin(g, "x_embedder"),
        "caption_norm": {"scale": np.asarray(g("cap_embedder.0.weight"))},
        "caption_proj": _lin(g, "cap_embedder.1"),
        "time_embed": {
            "linear_1": _lin(g, "t_embedder.mlp.0"),
            "linear_2": _lin(g, "t_embedder.mlp.2"),
        },
        "blocks": blocks,
        "final_ada": fin,
        "proj_out": _lin(g, "final_layer.linear"),
    }
    g.check_consumed(_ZIMAGE_IGNORE, "convert_zimage_transformer")
    return params


def infer_zimage_config(sd: StateDict, **overrides) -> zimage.ZImageConfig:
    """Best-effort geometry inference from a transformer state dict."""
    L = 1 + max(
        int(m.group(1)) for k in sd if (m := re.match(r"layers\.(\d+)\.", k))
    )
    d, pp = sd["x_embedder.weight"].shape
    cap = sd["cap_embedder.1.weight"].shape[1]
    hid = sd["layers.0.feed_forward.w2.weight"].shape[1]
    qk_norm = "layers.0.attention.norm_q.weight" in sd
    kw = dict(n_layers=L, d_model=d, caption_dim=cap, ff_ratio=hid / d, qk_norm=qk_norm)
    if qk_norm:
        dh = sd["layers.0.attention.norm_q.weight"].shape[0]
        kw["n_heads"] = d // dh
    patch = int(overrides.pop("patch_size", 2))
    kw["patch_size"] = patch
    kw["in_channels"] = pp // (patch * patch)
    kw.update(overrides)
    return zimage.ZImageConfig(**kw)


# ---------------------------------------------------------------------------
# KL-VAE decoder
# ---------------------------------------------------------------------------


def _gn(g: _Consumer, name: str) -> Params:
    return {"scale": np.asarray(g(f"{name}.weight")), "bias": np.asarray(g(f"{name}.bias"))}


def _resnet(g: _Consumer, pfx: str) -> Params:
    p: Params = {
        "norm1": _gn(g, f"{pfx}.norm1"),
        "conv1": _conv(g, f"{pfx}.conv1"),
        "norm2": _gn(g, f"{pfx}.norm2"),
        "conv2": _conv(g, f"{pfx}.conv2"),
    }
    if g.has(f"{pfx}.conv_shortcut.weight"):
        p["skip"] = _conv(g, f"{pfx}.conv_shortcut")
    return p


def _mid_attention(g: _Consumer, pfx: str) -> Params:
    """diffusers Attention (Linear q/k/v/out over [B,HW,C]) → our fused
    1×1-conv qkv layout (models/vaekl.py ``_mid_attn``: out channels split
    (3, C) group-major, order q,k,v)."""
    def lin_to_conv(name: str) -> np.ndarray:
        return g(f"{pfx}.{name}.weight").T  # [C_in, C_out]

    w = np.concatenate([lin_to_conv("to_q"), lin_to_conv("to_k"), lin_to_conv("to_v")], axis=1)
    b = np.concatenate([g(f"{pfx}.to_q.bias"), g(f"{pfx}.to_k.bias"), g(f"{pfx}.to_v.bias")])
    proj_w = g(f"{pfx}.to_out.0.weight").T
    return {
        "norm": _gn(g, f"{pfx}.group_norm"),
        "qkv": {"kernel": np.asarray(w[None, None]), "bias": np.asarray(b)},
        "proj": {
            "kernel": np.asarray(proj_w[None, None]),
            "bias": np.asarray(g(f"{pfx}.to_out.0.bias")),
        },
    }


def convert_kl_decoder(sd: StateDict, cfg: vaekl.VAEDecoderConfig) -> Params:
    g = _Consumer(sd)
    p: Params = {"conv_in": _conv(g, "decoder.conv_in")}
    p["mid"] = {
        "res1": _resnet(g, "decoder.mid_block.resnets.0"),
        "res2": _resnet(g, "decoder.mid_block.resnets.1"),
    }
    if cfg.mid_attn:
        p["mid"]["attn"] = _mid_attention(g, "decoder.mid_block.attentions.0")
    stages = []
    for s in range(len(cfg.ch)):
        pfx = f"decoder.up_blocks.{s}"
        stage: Params = {
            "blocks": [
                _resnet(g, f"{pfx}.resnets.{b}") for b in range(cfg.blocks_per_stage)
            ]
        }
        if s < len(cfg.ch) - 1:
            stage["up"] = _conv(g, f"{pfx}.upsamplers.0.conv")
        stages.append(stage)
    p["stages"] = stages
    p["norm_out"] = _gn(g, "decoder.conv_norm_out")
    p["conv_out"] = _conv(g, "decoder.conv_out")
    if g.has("post_quant_conv.weight"):
        p["post_quant"] = _conv(g, "post_quant_conv")
    g.check_consumed(_VAE_IGNORE, "convert_kl_decoder")
    return p


def infer_kl_decoder_config(sd: StateDict, **overrides) -> vaekl.VAEDecoderConfig:
    """Geometry from a decoder state dict. ``scaling_factor``/``shift_factor``
    live in the diffusers config.json, not the tensors — pass them as
    overrides when they differ from the 16-channel defaults."""
    chs = []
    s = 0
    while f"decoder.up_blocks.{s}.resnets.0.conv1.weight" in sd:
        chs.append(sd[f"decoder.up_blocks.{s}.resnets.0.conv1.weight"].shape[0])
        s += 1
    blocks = 0
    while f"decoder.up_blocks.0.resnets.{blocks}.conv1.weight" in sd:
        blocks += 1
    kw = dict(
        latent_channels=sd["decoder.conv_in.weight"].shape[1],
        ch=tuple(chs),
        blocks_per_stage=blocks,
        mid_attn="decoder.mid_block.attentions.0.group_norm.weight" in sd,
    )
    kw.update(overrides)
    return vaekl.VAEDecoderConfig(**kw)


def load_zimage_params(ckpt, cfg: zimage.ZImageConfig) -> Params:
    """File/dir (diffusers ``transformer/`` subfolder or single file) → pytree."""
    from .io import load_state_dict, strip_prefix

    sd = strip_prefix(load_state_dict(ckpt), "model")
    return convert_zimage_transformer(sd, cfg)


def load_kl_decoder(ckpt, cfg: vaekl.VAEDecoderConfig) -> Params:
    from .io import load_state_dict

    return convert_kl_decoder(load_state_dict(ckpt), cfg)
