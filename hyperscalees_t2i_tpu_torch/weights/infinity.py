"""Checkpoint converters of the Infinity family (port of
``hyperscalees_t2i_tpu/weights/infinity.py``).

The transformer converter targets the public VAR-derived layout and keeps
the whole mapping explicit; strict accounting makes a divergence loud.

==============================  =============================================
``word_embed.{weight,bias}``     ``word_embed`` (bit-label tokens → d)
``lvl_embed.weight``             ``lvl_emb`` (first ``S`` rows)
``pos_start``                    ``pos_start``
``text_proj_for_ca[.1]``         ``text_proj`` (plain Linear or the Linear of
                                 Sequential(norm, Linear); the norm must be
                                 the identity)
``text_proj_for_sos[.1]``        ``pool_proj``
``cfg_uncond``                   ``null_text`` = text_proj(mean(cfg_uncond))
                                 (the reference feeds the whole uncond
                                 sequence; folded into one null token)
``blocks.{i}.sa.mat_qkv`` +      ``blocks/qkv``, bias concat(q_bias, 0,
``q_bias``/``v_bias``            v_bias) (the zero-k buffer)
``blocks.{i}.sa.proj``           ``blocks/attn_proj``
``blocks.{i}.ca.mat_q/mat_kv``   ``blocks/cross_q``, ``blocks/cross_kv``
``blocks.{i}.ca.proj``           ``blocks/cross_proj``
``blocks.{i}.ffn.fc{1,2}``       ``blocks/fc{1,2}``
``blocks.{i}.ada_lin.1``         ``blocks/ada_lin`` (rows reordered as in
                                 ``weights/var.py``)
``shared_ada_lin.1`` +           the same: kernel_i = the shared kernel,
``blocks.{i}.ada_gss``           bias_i = shared bias + ada_gss_i
``head_nm.ada_lin.1``, ``head``  ``head_ada``, ``head``
==============================  =============================================

QK-l2 checkpoints (``sa.scale_mul_1H11``, optionally ``ca.scale_mul_1H11``)
give ``blocks/scale_mul`` and ``blocks/cross_scale_mul``;
:func:`infer_infinity_config` then sets ``attn_l2_norm`` and ``use_rope2d``
(released Infinity couples QK-l2 with 2D RoPE and has no learned position
table) and reads the head count off the scale's shape. The learned
``pos_emb`` has no checkpoint source and is zero-filled. The block prefix
is probed (``blocks.{i}.`` or ``unregistered_blocks.{i}.``).

:func:`convert_bsq_vae` reads a CompVis-style BSQ tokenizer checkpoint
(``decoder.*`` + ``quantize.quant_resi.qresi_ls.*`` φ convs) into the
``models/bsq.py`` tree; its encoder is ignored. Leaves are f32 numpy
arrays, bitwise the JAX converters'.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from ..models import bsq, infinity as inf_mod
from .io import StateDict
from .var import _ADA_PERM, _Consumer, _ada_lin_stack, _conv, _lin, _lin_stack, parse_compvis_decoder

Params = Dict[str, Any]

_INF_IGNORE = re.compile(
    r"(zero_k_bias|lvl_1L|attn_bias(_for_masking)?|freqs_cis|rope.*|num_batches_tracked|norm0_cond.*)$")


def _probe_lin(g: _Consumer, base: str) -> Params:
    """A Linear at ``base`` or at ``base.1`` (Sequential(norm, Linear)),
    whose leading norm is accepted only when it is the identity."""
    if g.has(f"{base}.weight"):
        return _lin(g, base)
    if g.has(f"{base}.1.weight"):
        p = _lin(g, f"{base}.1")
        if g.has(f"{base}.0.weight") and not np.allclose(g(f"{base}.0.weight"), 1.0, atol=1e-6):
            raise ValueError(f"{base}.0 carries a trained norm scale; this layout is not representable in "
                             f"models/infinity.py — refusing to drop it silently")
        if g.has(f"{base}.0.bias") and not np.allclose(g(f"{base}.0.bias"), 0.0, atol=1e-6):
            raise ValueError(f"{base}.0 carries a trained norm bias — see above")
        return p
    raise KeyError(f"no Linear found at {base}[.1].weight")


def convert_infinity_transformer(sd: StateDict, cfg: inf_mod.InfinityConfig) -> Params:
    g = _Consumer(sd)
    D, d, S = cfg.depth, cfg.d_model, len(cfg.patch_nums)
    blk = "blocks.{}." if g.has("blocks.0.sa.mat_qkv.weight") else "unregistered_blocks.{}."
    qkv_w = np.stack([g(blk.format(i) + "sa.mat_qkv.weight").T for i in range(D)])
    qkv_b = np.stack([np.concatenate([g(blk.format(i) + "sa.q_bias"), np.zeros((d,), np.float32),
                                      g(blk.format(i) + "sa.v_bias")]) for i in range(D)])
    if g.has(blk.format(0) + "ada_lin.1.weight"):
        ada = _ada_lin_stack(g, blk + "ada_lin.1", D, d)
    else:  # shared AdaLN: a per-block Linear whose bias absorbs the block's table
        w, b = g("shared_ada_lin.1.weight"), g("shared_ada_lin.1.bias")
        ws, bs = [], []
        for i in range(D):
            gss = g(blk.format(i) + "ada_gss").reshape(6, d)
            ws.append(w.reshape(6, d, d)[_ADA_PERM].reshape(6 * d, d).T)
            bs.append((b.reshape(6, d) + gss)[_ADA_PERM].reshape(6 * d))
        ada = {"kernel": np.stack(ws), "bias": np.stack(bs)}

    text_proj = _probe_lin(g, "text_proj_for_ca")
    pool_proj = _probe_lin(g, "text_proj_for_sos")
    if g.has("cfg_uncond"):
        uncond = g("cfg_uncond")
        u = uncond.reshape(-1, uncond.shape[-1]).mean(0)
        null = u @ np.asarray(text_proj["kernel"], np.float32)
        if "bias" in text_proj:
            null = null + np.asarray(text_proj["bias"], np.float32)
        null_text = null[None, None, :]
    else:
        null_text = np.zeros((1, 1, d), np.float32)

    lvl = g("lvl_embed.weight")
    if lvl.shape[0] < S:
        raise ValueError(f"lvl_embed has {lvl.shape[0]} rows < {S} scales")

    def _scales(key_fmt: str, flag: bool, flag_name: str):
        if g.has(key_fmt.format(0)):
            if not flag:
                raise ValueError(f"checkpoint carries {key_fmt.format(0)} (QK-l2 attention) but cfg.{flag_name} "
                                 f"is False — use infer_infinity_config or set the flag")
            sm = np.stack([g(key_fmt.format(i)).reshape(-1) for i in range(D)])
            if sm.shape[1] != cfg.n_heads:
                raise ValueError(f"scale_mul has {sm.shape[1]} heads but cfg.n_heads={cfg.n_heads}")
            return sm
        if flag:
            raise ValueError(f"cfg.{flag_name}=True but the checkpoint has no {key_fmt.format(0)}")
        return None

    sa_sm = _scales(blk + "sa.scale_mul_1H11", cfg.attn_l2_norm, "attn_l2_norm")
    ca_sm = _scales(blk + "ca.scale_mul_1H11", cfg.cross_attn_l2_norm, "cross_attn_l2_norm")
    if not cfg.use_rope2d:
        print("[weights/infinity] NOTE: the learned pos_emb has no checkpoint source and is zero-filled; released "
              "Infinity builds use 2D RoPE (set use_rope2d / rely on infer_infinity_config)", flush=True)
    params: Params = {
        "text_proj": text_proj,
        "null_text": null_text,
        "pool_proj": pool_proj,
        "pos_start": g("pos_start").reshape(1, 1, d),
        "lvl_emb": lvl[:S],
        "pos_emb": np.zeros((cfg.seq_len, d), np.float32),
        "word_embed": _lin(g, "word_embed"),
        "blocks": {
            "ada_lin": ada,
            "qkv": {"kernel": qkv_w, "bias": qkv_b},
            "attn_proj": _lin_stack(g, blk + "sa.proj", D),
            "cross_q": _lin_stack(g, blk + "ca.mat_q", D),
            "cross_kv": _lin_stack(g, blk + "ca.mat_kv", D),
            "cross_proj": _lin_stack(g, blk + "ca.proj", D),
            "fc1": _lin_stack(g, blk + "ffn.fc1", D),
            "fc2": _lin_stack(g, blk + "ffn.fc2", D),
        },
        "head_ada": _lin(g, "head_nm.ada_lin.1"),
        "head": _lin(g, "head"),
        # no "vq": the BSQ tokenizer ships as its own checkpoint (convert_bsq_vae)
    }
    if sa_sm is not None:
        params["blocks"]["scale_mul"] = sa_sm
    if ca_sm is not None:
        params["blocks"]["cross_scale_mul"] = ca_sm
    g.check_consumed(_INF_IGNORE, "convert_infinity_transformer")
    return params


def infer_infinity_config(sd: StateDict, **overrides) -> inf_mod.InfinityConfig:
    """Geometry from a transformer state dict (depth, width, ffn, text
    width, bits; heads and the attention flags from the QK-l2 scales, else
    a preset matched by (depth, d_model))."""
    blk = "blocks.{}." if "blocks.0.sa.mat_qkv.weight" in sd else "unregistered_blocks.{}."
    D = 1 + max(int(m.group(1)) for k in sd if (m := re.match(blk.format(r"(\d+)").replace(".", r"\."), k)))
    d = sd[blk.format(0) + "sa.mat_qkv.weight"].shape[1]
    hid = sd[blk.format(0) + "ffn.fc1.weight"].shape[0]
    tp = "text_proj_for_ca.weight" if "text_proj_for_ca.weight" in sd else "text_proj_for_ca.1.weight"
    vq_kw: Dict[str, Any] = dict(bits=sd["word_embed.weight"].shape[1])
    if "patch_nums" in overrides:  # the model's and the tokenizer's schedules stay one
        vq_kw["patch_nums"] = tuple(overrides["patch_nums"])
    kw: Dict[str, Any] = dict(depth=D, d_model=d, ff_ratio=hid / d, text_dim=sd[tp].shape[1],
                              vq=bsq.BSQConfig(**vq_kw))
    sa_sm = blk.format(0) + "sa.scale_mul_1H11"
    if sa_sm in sd:
        kw["n_heads"] = int(np.asarray(sd[sa_sm]).size)  # (1, H, 1, 1)
        kw["attn_l2_norm"] = True
        kw["use_rope2d"] = True
        if blk.format(0) + "ca.scale_mul_1H11" in sd:
            kw["cross_attn_l2_norm"] = True
    if "n_heads" not in kw and "n_heads" not in overrides:
        preset = next((p for p in inf_mod.INFINITY_PRESETS.values() if p["depth"] == D and p["d_model"] == d), None)
        if preset is not None:
            kw["n_heads"] = preset["n_heads"]
        else:
            print(f"[weights/infinity] WARNING: head count is not stored in the checkpoint and (depth={D}, d={d}) "
                  f"matches no preset — defaulting to n_heads={inf_mod.InfinityConfig.n_heads}; pass "
                  f"--infinity_variant (or an n_heads override) if this is wrong", flush=True)
    kw.update(overrides)
    return inf_mod.InfinityConfig(**kw)


def load_infinity_params(ckpt, cfg: inf_mod.InfinityConfig) -> Params:
    """A file or directory (plain or sharded) → the transformer tree; the
    tokenizer's ``vq`` comes from :func:`load_bsq_vae`."""
    from .io import load_state_dict, strip_prefix

    return convert_infinity_transformer(strip_prefix(load_state_dict(ckpt), "module"), cfg)


_BSQ_IGNORE = re.compile(r"^(encoder\.|quant_conv\.)|num_batches_tracked$")


def convert_bsq_vae(sd: StateDict, cfg: bsq.BSQConfig) -> Params:
    """A CompVis-style BSQ tokenizer checkpoint → ``{phi, decoder}``: the
    decoder's geometry from its key inventory, the φ convs of the
    ``quant_resi`` scheme, the encoder ignored; anything else unconsumed
    raises."""
    g = _Consumer(sd)
    K = 0
    while g.has(f"quantize.quant_resi.qresi_ls.{K}.weight"):
        K += 1
    if K == 0:
        raise ValueError("no quantize.quant_resi.qresi_ls.* φ convs found")
    if K != cfg.phi_partial:
        raise ValueError(f"checkpoint has {K} φ convs but cfg.phi_partial={cfg.phi_partial}")
    phi_k = np.stack([g(f"quantize.quant_resi.qresi_ls.{i}.weight").transpose(2, 3, 1, 0) for i in range(K)])
    phi_b = np.stack([g(f"quantize.quant_resi.qresi_ls.{i}.bias") for i in range(K)])
    if phi_k.shape[-1] != cfg.bits:
        raise ValueError(f"φ convs carry {phi_k.shape[-1]} channels but cfg.bits={cfg.bits}")
    dec = parse_compvis_decoder(g, sd)
    zc = dec["conv_in"]["kernel"].shape[2]
    if zc != cfg.bits:
        raise ValueError(f"decoder.conv_in expects {zc} latent channels but cfg.bits={cfg.bits}")
    if g.has("post_quant_conv.weight"):
        dec["post_quant_conv"] = _conv(g, "post_quant_conv")
    g.check_consumed(_BSQ_IGNORE, "convert_bsq_vae")
    return {"phi": {"kernel": phi_k, "bias": phi_b}, "decoder": dec}


def load_bsq_vae(ckpt, cfg: bsq.BSQConfig) -> Params:
    """A checkpoint file → the BSQ ``vq`` tree of ``models/infinity.py``."""
    from .io import load_state_dict, strip_prefix

    return convert_bsq_vae(strip_prefix(load_state_dict(ckpt), "module"), cfg)
