"""Checkpoint converter of the Sana-Sprint transformer (port of
``hyperscalees_t2i_tpu/weights/sana.py``).

Maps a diffusers ``SanaTransformer2DModel`` state dict onto the
``models/sana.py`` tree (``init_sana``'s layout):

- ``patch_embed.proj`` (Conv2d OIHW), ``caption_projection.linear_{1,2}``,
  ``caption_norm`` (RMSNorm);
- ``time_embed.*``: the Sprint guidance variant nests
  ``timestep_embedder``/``guidance_embedder`` under ``time_embed``, the
  ``AdaLayerNormSingle`` variant the timestep embedder under
  ``time_embed.emb``; both end in ``time_embed.linear`` (d → 6d). The
  converter probes which is present;
- ``transformer_blocks.{i}``: ``attn1``/``attn2`` with ``to_q/to_k/to_v``
  and ``to_out.0``; the GLUMBConv ``ff.conv_inverted`` (1×1),
  ``ff.conv_depth`` (3×3 depthwise), ``ff.conv_point`` (1×1, no bias); the
  block's ``scale_shift_table`` [6, d];
- the final ``scale_shift_table`` [2, d] and ``proj_out``.

Strict as ``weights/var.py``; leaves are f32 numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

from ..models import sana
from .io import StateDict
from .var import _Consumer, _lin, _lin_stack

Params = Dict[str, Any]

_SANA_IGNORE = re.compile(r"num_batches_tracked$")


def _conv_oihw(g: _Consumer, name: str) -> Params:
    p: Params = {"kernel": np.ascontiguousarray(g(f"{name}.weight").transpose(2, 3, 1, 0))}
    if g.has(f"{name}.bias"):
        p["bias"] = g(f"{name}.bias")
    return p


def _conv_stack(g: _Consumer, fmt: str, L: int) -> Params:
    p: Params = {"kernel": np.stack([g(fmt.format(i) + ".weight").transpose(2, 3, 1, 0) for i in range(L)])}
    if g.has(fmt.format(0) + ".bias"):
        p["bias"] = np.stack([g(fmt.format(i) + ".bias") for i in range(L)])
    return p


def _mlp_embedder(g: _Consumer, name: str) -> Params:
    return {"linear_1": _lin(g, f"{name}.linear_1"), "linear_2": _lin(g, f"{name}.linear_2")}


def convert_sana_transformer(sd: StateDict, cfg: sana.SanaConfig) -> Params:
    g = _Consumer(sd)
    L = cfg.n_layers
    blk = "transformer_blocks.{}."
    t_prefix = "time_embed" if g.has("time_embed.timestep_embedder.linear_1.weight") else "time_embed.emb"
    time_embed: Params = {"timestep": _mlp_embedder(g, f"{t_prefix}.timestep_embedder"),
                          "linear": _lin(g, "time_embed.linear")}
    if cfg.guidance_embeds:
        time_embed["guidance"] = _mlp_embedder(g, f"{t_prefix}.guidance_embedder")

    def attn(name: str) -> Params:
        return {"to_q": _lin_stack(g, blk + f"{name}.to_q", L), "to_k": _lin_stack(g, blk + f"{name}.to_k", L),
                "to_v": _lin_stack(g, blk + f"{name}.to_v", L), "to_out": _lin_stack(g, blk + f"{name}.to_out.0", L)}

    params: Params = {
        "patch_embed": _conv_oihw(g, "patch_embed.proj"),
        "caption_norm": {"scale": g("caption_norm.weight")},
        "caption_proj": {"linear_1": _lin(g, "caption_projection.linear_1"),
                         "linear_2": _lin(g, "caption_projection.linear_2")},
        "time_embed": time_embed,
        "blocks": {
            "scale_shift_table": np.stack([g(blk.format(i) + "scale_shift_table") for i in range(L)]),
            "attn1": attn("attn1"),
            "attn2": attn("attn2"),
            "ff": {"conv_inverted": _conv_stack(g, blk + "ff.conv_inverted", L),
                   "conv_depth": _conv_stack(g, blk + "ff.conv_depth", L),
                   "conv_point": _conv_stack(g, blk + "ff.conv_point", L)},
        },
        "scale_shift_table": g("scale_shift_table"),
        "proj_out": _lin(g, "proj_out"),
    }
    g.check_consumed(_SANA_IGNORE, "convert_sana_transformer")
    return params


def load_sana_params(ckpt, cfg: sana.SanaConfig) -> Params:
    """A file or directory (the diffusers ``transformer/`` folder or one
    file) → the tree."""
    from .io import load_state_dict, strip_prefix

    return convert_sana_transformer(strip_prefix(load_state_dict(ckpt), "model"), cfg)


def infer_sana_config(sd: StateDict, **overrides) -> sana.SanaConfig:
    """Geometry from a state dict: layer count and widths (the head counts
    are not in the shapes and keep the config's defaults)."""
    L = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"transformer_blocks\.(\d+)\.", k)))
    d = sd["proj_out.weight"].shape[1]
    pe = sd["patch_embed.proj.weight"]  # [d, Cin, p, p]
    kw: Dict[str, Any] = dict(
        n_layers=L, d_model=d, caption_dim=sd["caption_projection.linear_1.weight"].shape[1],
        in_channels=pe.shape[1], patch_size=pe.shape[2],
        out_channels=sd["proj_out.weight"].shape[0] // (pe.shape[2] ** 2),
        guidance_embeds="time_embed.guidance_embedder.linear_1.weight" in sd
        or "time_embed.emb.guidance_embedder.linear_1.weight" in sd,
    )
    kw.update(overrides)
    return sana.SanaConfig(**kw)
