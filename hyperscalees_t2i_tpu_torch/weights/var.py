"""Checkpoint converters of the VAR family (port of
``hyperscalees_t2i_tpu/weights/var.py``).

Maps the released ``var_d{16,20,24,30}.pth`` (the AR transformer) and
``vae_ch160v4096z32.pth`` (the multi-scale VQ-VAE) onto the JAX package's
trees, which the port's modules take as they are (``models/var.py``,
``models/msvq.py``). Layout: torch Linear ``[out, in]`` → kernel ``[in,
out]``; Conv2d OIHW → HWIO; GroupNorm weight/bias → scale/bias; per-layer
tensors stacked into ``[depth, ...]``. Leaves are f32 numpy arrays, bitwise
the JAX converter's.

The converters are strict: every checkpoint tensor is consumed or
explicitly ignored (buffers, the VQ-VAE's encoder), and every leaf of the
tree is filled; leftovers raise with their names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Set

import numpy as np

from ..models import msvq, var as var_mod
from .io import StateDict

Params = Dict[str, Any]

# reference buffers that carry no learned weight
_VAR_IGNORE = re.compile(r"(lvl_1L|attn_bias_for_masking|zero_k_bias|num_batches_tracked)$")


class _Consumer:
    """State-dict view that records which tensors were read."""

    def __init__(self, sd: StateDict):
        self.sd = sd
        self.used: Set[str] = set()

    def __call__(self, name: str) -> np.ndarray:
        self.used.add(name)
        return np.asarray(self.sd[name], np.float32)

    def has(self, name: str) -> bool:
        return name in self.sd

    def check_consumed(self, ignore: re.Pattern, what: str) -> None:
        left = [k for k in self.sd if k not in self.used and not ignore.search(k)]
        if left:
            raise ValueError(f"{what}: {len(left)} unconsumed checkpoint tensors — geometry mismatch? "
                             f"e.g. {sorted(left)[:8]}")


def _lin(g: _Consumer, name: str) -> Params:
    p: Params = {"kernel": np.ascontiguousarray(g(f"{name}.weight").T)}
    if g.has(f"{name}.bias"):
        p["bias"] = g(f"{name}.bias")
    return p


def _lin_stack(g: _Consumer, fmt: str, L: int) -> Params:
    p: Params = {"kernel": np.stack([g(fmt.format(i) + ".weight").T for i in range(L)])}
    if g.has(fmt.format(0) + ".bias"):
        p["bias"] = np.stack([g(fmt.format(i) + ".bias") for i in range(L)])
    return p


def _conv(g: _Consumer, name: str) -> Params:
    p: Params = {"kernel": np.ascontiguousarray(g(f"{name}.weight").transpose(2, 3, 1, 0))}
    if g.has(f"{name}.bias"):
        p["bias"] = g(f"{name}.bias")
    return p


def _norm(g: _Consumer, name: str) -> Params:
    return {"scale": g(f"{name}.weight"), "bias": g(f"{name}.bias")}


# AdaLN 6-way output order: the reference unbinds (γ1, γ2, s1, s2, b1, b2);
# the block unpacks (γ1, s1, b1, γ2, s2, b2)
_ADA_PERM = np.asarray([0, 2, 4, 1, 3, 5])


def _ada_lin_stack(g: _Consumer, fmt: str, L: int, d: int) -> Params:
    ws, bs = [], []
    for i in range(L):
        w = g(fmt.format(i) + ".weight").reshape(6, d, d)[_ADA_PERM].reshape(6 * d, d)
        b = g(fmt.format(i) + ".bias").reshape(6, d)[_ADA_PERM].reshape(6 * d)
        ws.append(w.T)
        bs.append(b)
    return {"kernel": np.stack(ws), "bias": np.stack(bs)}


def infer_var_config(sd: StateDict, **overrides) -> var_mod.VARConfig:
    """Geometry from a ``var_d*.pth`` state dict: depth (block count),
    d_model (qkv width), n_heads (``attn.scale_mul_1H11``'s head axis),
    ff_ratio (fc1), num_classes (class table rows − 1 CFG null). The scale
    schedule is not in the shapes: the canonical 256 px one is kept unless
    overridden (``patch_nums`` also sets the VQ pyramid's), and checked
    against ``pos_1LC``'s length and the token geometry against the VQ
    config, loudly."""
    D = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k)))
    d = sd["blocks.0.attn.mat_qkv.weight"].shape[1]
    hid = sd["blocks.0.ffn.fc1.weight"].shape[0]
    kw: Dict[str, Any] = dict(depth=D, d_model=d, ff_ratio=hid / d, num_classes=sd["class_emb.weight"].shape[0] - 1)
    sm = sd.get("blocks.0.attn.scale_mul_1H11")
    if sm is not None:
        kw["n_heads"] = int(np.asarray(sm).size)
        kw["attn_l2_norm"] = True
    else:
        kw["attn_l2_norm"] = False
        if "n_heads" not in overrides:
            print(f"[weights/var] WARNING: no attn.scale_mul_1H11 — head count is not stored in the checkpoint; "
                  f"defaulting to n_heads={var_mod.VARConfig.n_heads} (override if wrong)", flush=True)
    kw.update(overrides)
    if "patch_nums" in kw and "vq" not in kw:
        kw["vq"] = dataclasses.replace(msvq.MSVQConfig(), patch_nums=tuple(kw["patch_nums"]))
    cfg = var_mod.VARConfig(**kw)
    if tuple(cfg.patch_nums) != tuple(cfg.vq.patch_nums):
        raise ValueError(f"patch_nums {cfg.patch_nums} != vq.patch_nums {cfg.vq.patch_nums} — the transformer and "
                         f"VQ pyramids must share one scale schedule")
    L = sd["pos_1LC"].shape[1]
    if L != cfg.seq_len:
        raise ValueError(f"checkpoint pos_1LC has {L} positions but patch_nums {cfg.patch_nums} sum to "
                         f"{cfg.seq_len} — pass the checkpoint's scale schedule (patch_nums=...)")
    cvae = sd["word_embed.weight"].shape[1]
    vocab = sd["head.weight"].shape[0]
    if cvae != cfg.vq.c_vae or vocab != cfg.vq.vocab_size:
        raise ValueError(f"checkpoint token geometry (c_vae={cvae}, vocab={vocab}) != vq config "
                         f"(c_vae={cfg.vq.c_vae}, vocab={cfg.vq.vocab_size}) — pass a matching MSVQConfig (vq=...)")
    return cfg


def convert_var_transformer(sd: StateDict, cfg: var_mod.VARConfig) -> Params:
    """``var_d*.pth`` → the transformer half of the VAR tree (no ``vq``)."""
    g = _Consumer(sd)
    D, d = cfg.depth, cfg.d_model
    blk = "blocks.{}."
    qkv_w = np.stack([g(blk.format(i) + "attn.mat_qkv.weight").T for i in range(D)])
    qkv_b = np.stack([np.concatenate([g(blk.format(i) + "attn.q_bias"), np.zeros((d,), np.float32),  # zero_k_bias
                                      g(blk.format(i) + "attn.v_bias")]) for i in range(D)])
    params: Params = {
        "class_emb": g("class_emb.weight"),
        "pos_start": g("pos_start"),
        "lvl_emb": g("lvl_embed.weight"),
        "pos_emb": g("pos_1LC")[0],
        "word_embed": _lin(g, "word_embed"),
        "blocks": {
            "ada_lin": _ada_lin_stack(g, blk + "ada_lin.1", D, d),
            "qkv": {"kernel": qkv_w, "bias": qkv_b},
            "attn_proj": _lin_stack(g, blk + "attn.proj", D),
            "fc1": _lin_stack(g, blk + "ffn.fc1", D),
            "fc2": _lin_stack(g, blk + "ffn.fc2", D),
        },
        "head_ada": _lin(g, "head_nm.ada_lin.1"),
        "head": _lin(g, "head"),
    }
    if cfg.attn_l2_norm:
        params["blocks"]["scale_mul"] = np.stack([g(blk.format(i) + "attn.scale_mul_1H11").reshape(-1)
                                                  for i in range(D)])
    g.check_consumed(_VAR_IGNORE, "convert_var_transformer")
    return params


def _res_block(g: _Consumer, name: str) -> Params:
    p: Params = {"norm1": _norm(g, f"{name}.norm1"), "conv1": _conv(g, f"{name}.conv1"),
                 "norm2": _norm(g, f"{name}.norm2"), "conv2": _conv(g, f"{name}.conv2")}
    if g.has(f"{name}.nin_shortcut.weight"):
        p["nin"] = _conv(g, f"{name}.nin_shortcut")
    return p


def _attn_block(g: _Consumer, name: str) -> Params:
    return {"norm": _norm(g, f"{name}.norm"), "qkv": _conv(g, f"{name}.qkv"), "proj": _conv(g, f"{name}.proj_out")}


_VQVAE_IGNORE = re.compile(r"^(encoder\.|quant_conv\.)|num_batches_tracked$|^quantize\.(ema|beta)")


def parse_compvis_decoder(g: _Consumer, sd: StateDict) -> Params:
    """A CompVis ``decoder.*`` subtree from its key inventory: level and
    block counts, attention placement, upsample convs and the optional mid
    attention. Shared by the VQ-VAE and BSQ converters."""
    n_levels = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"decoder\.up\.(\d+)\.", k)))
    up: List[Params] = []
    for i in range(n_levels):
        n_blk = 1 + max(int(m.group(1)) for k in sd if (m := re.match(rf"decoder\.up\.{i}\.block\.(\d+)\.", k)))
        level: Params = {"block": [_res_block(g, f"decoder.up.{i}.block.{j}") for j in range(n_blk)], "attn": []}
        if g.has(f"decoder.up.{i}.attn.0.norm.weight"):
            level["attn"] = [_attn_block(g, f"decoder.up.{i}.attn.{j}") for j in range(n_blk)]
        if g.has(f"decoder.up.{i}.upsample.conv.weight"):
            level["upsample"] = _conv(g, f"decoder.up.{i}.upsample.conv")
        up.append(level)
    return {
        "conv_in": _conv(g, "decoder.conv_in"),
        "mid": {
            "block_1": _res_block(g, "decoder.mid.block_1"),
            "attn_1": _attn_block(g, "decoder.mid.attn_1") if g.has("decoder.mid.attn_1.norm.weight") else None,
            "block_2": _res_block(g, "decoder.mid.block_2"),
        },
        "up": up,
        "norm_out": _norm(g, "decoder.norm_out"),
        "conv_out": _conv(g, "decoder.conv_out"),
    }


def convert_vqvae(sd: StateDict, cfg: msvq.MSVQConfig) -> Params:
    """``vae_ch160v4096z32.pth`` → the msvq tree (codebook, φ, decoder); the
    encoder and the pre-quant conv are ignored (generation never encodes)."""
    g = _Consumer(sd)
    K = cfg.phi_partial
    phi_k = np.stack([g(f"quantize.quant_resi.qresi_ls.{i}.weight").transpose(2, 3, 1, 0) for i in range(K)])
    phi_b = np.stack([g(f"quantize.quant_resi.qresi_ls.{i}.bias") for i in range(K)])
    dec = parse_compvis_decoder(g, sd)
    if len(dec["up"]) != len(cfg.ch_mult):
        raise ValueError(f"checkpoint decoder has {len(dec['up'])} levels but cfg.ch_mult has {len(cfg.ch_mult)}")
    if any(len(lv["block"]) != cfg.num_res_blocks + 1 for lv in dec["up"]):
        raise ValueError(f"checkpoint blocks-per-level {[len(lv['block']) for lv in dec['up']]} != "
                         f"cfg.num_res_blocks+1 = {cfg.num_res_blocks + 1}")
    if bool(dec["up"][-1]["attn"]) != cfg.using_sa:
        raise ValueError("checkpoint deepest-level attention disagrees with cfg.using_sa")
    if (dec["mid"]["attn_1"] is not None) != cfg.using_mid_sa:
        raise ValueError("checkpoint mid attention disagrees with cfg.using_mid_sa")
    dec["post_quant_conv"] = _conv(g, "post_quant_conv")
    params: Params = {"codebook": g("quantize.embedding.weight"), "phi": {"kernel": phi_k, "bias": phi_b},
                      "decoder": dec}
    g.check_consumed(_VQVAE_IGNORE, "convert_vqvae")
    return params


def load_var_params(var_ckpt, vae_ckpt, cfg: var_mod.VARConfig) -> Params:
    """The full VAR tree from the two checkpoint files; ``var_ckpt`` may be
    an already-loaded state dict (after :func:`infer_var_config`)."""
    from .io import load_state_dict

    sd = var_ckpt if isinstance(var_ckpt, dict) else load_state_dict(var_ckpt)
    params = convert_var_transformer(sd, cfg)
    params["vq"] = convert_vqvae(load_state_dict(vae_ckpt), cfg.vq)
    return params
