"""Model geometries, ES plans, knobs and serving plans per rung (the port's
copy of the Sana and VAR parts of ``hyperscalees_t2i_tpu/rungs.py``, plus
the port's own ``ar_d16`` and ``inf_2b`` rungs).

Module-level code is stdlib-only; :func:`sana_rung_model`,
:func:`var_rung_model` and :func:`infinity_rung_model` import the model
configs when called.
"""

from __future__ import annotations

from typing import Any, Dict

# default serving geometry per rung: adapter lanes per dispatch, images per
# request, lanes per chunk inside a dispatch (0 = all)
SERVE_PLAN = {
    "tiny": {"adapter_batch": 16, "images_per_request": 1, "member_batch": 0},
    "small": {"adapter_batch": 4, "images_per_request": 1, "member_batch": 0},
    "mid": {"adapter_batch": 4, "images_per_request": 1, "member_batch": 1},
    "flagship": {"adapter_batch": 2, "images_per_request": 1, "member_batch": 1},
}

# open-loop capacity sweep per serving rung (tools/loadgen.py): the offered
# rate ladder (req/s), window, Zipf exponent, tenant population, store budget
# in adapters and the open-loop p99 SLO defining capacity (the JAX package's)
CAPACITY_PLAN = {
    "tiny": {"rates": [4.0, 16.0, 64.0, 128.0, 256.0, 512.0], "window_s": 4.0,
             "zipf_s": 1.1, "population": 64, "store_adapters": 24, "slo_p99_s": 2.0},
    "small": {"rates": [1.0, 2.0, 4.0, 8.0, 16.0], "window_s": 10.0,
              "zipf_s": 1.1, "population": 1000, "store_adapters": 128, "slo_p99_s": 5.0},
    "mid": {"rates": [0.5, 1.0, 2.0, 4.0, 8.0], "window_s": 20.0,
            "zipf_s": 1.1, "population": 10000, "store_adapters": 64, "slo_p99_s": 10.0},
    "flagship": {"rates": [0.25, 0.5, 1.0, 2.0], "window_s": 30.0,
                 "zipf_s": 1.1, "population": 100000, "store_adapters": 32, "slo_p99_s": 20.0},
}

# ES plan per rung: (scale, population, prompts per epoch, member_batch)
RUNG_PLAN = {
    "tiny": ("tiny", 4, 4, 1),
    "small": ("small", 4, 4, 1),
    "popscale": ("small", 128, 4, 8),
    "mid": ("mid", 4, 4, 1),
    "flagship": ("flagship", 4, 4, 1),
    "midpop": ("mid", 32, 4, 8),
    "flagpop": ("flagship", 16, 4, 4),
    # VAR next-scale AR, the path of the decode-attention kernel K4: the JAX
    # package's "ar" plan (pop 16, 4 classes, member_batch 4) at VAR-d16's
    # published geometry instead of its cut ar_small one, hence its own key
    "ar_d16": ("d16", 16, 4, 4),
    # Infinity-2B at its published 1024×1024 schedule (pn 1M, 14 scales),
    # the path of K4 at dh 128 and of its masked cross-attention; the JAX
    # package has no Infinity rung
    "inf_2b": ("2b", 4, 4, 1),
}
# the ladder the preflight walks by default, tiny first (the JAX package's)
RUNG_ORDER = ["tiny", "small", "popscale", "mid", "flagship"]

# Per-rung knobs (the Sana part of the JAX package's RUNG_OPT): member-interior
# reward tiling, the factored-noise store dtype, the reward towers' compute
# dtype, the factored member path (pop_fuse) and the frozen base's storage.
# The JAX package's remat knob has no counterpart: nothing is differentiated.
DEFAULT_OPT = {
    "reward_tile": 0, "noise_dtype": "float32", "tower_dtype": "float32",
    "pop_fuse": False, "base_quant": "off",
}
_BIG_OPT = {"noise_dtype": "bfloat16", "tower_dtype": "bfloat16", "base_quant": "int8"}
RUNG_OPT = {
    "tiny": dict(DEFAULT_OPT),
    "small": dict(DEFAULT_OPT),
    "popscale": {**DEFAULT_OPT, "pop_fuse": True, "base_quant": "int8"},
    "mid": {**DEFAULT_OPT, **_BIG_OPT, "reward_tile": 2, "pop_fuse": True},
    "midpop": {**DEFAULT_OPT, **_BIG_OPT, "reward_tile": 2, "pop_fuse": True},
    "flagship": {**DEFAULT_OPT, **_BIG_OPT, "reward_tile": 1, "pop_fuse": True},
    "flagpop": {**DEFAULT_OPT, **_BIG_OPT, "reward_tile": 1, "pop_fuse": True},
    "ar_d16": dict(DEFAULT_OPT),  # the JAX package's "ar" knobs
    "inf_2b": dict(DEFAULT_OPT),  # the JAX CLI's defaults: no pop_fuse, a float base
}


def rung_opt(rung: str) -> Dict[str, Any]:
    """The rung's knobs (all off for an unknown rung)."""
    return dict(RUNG_OPT.get(rung, DEFAULT_OPT))


# the frozen base's storage per serving rung
RUNG_BASE_QUANT = {r: RUNG_OPT[r]["base_quant"] for r in SERVE_PLAN}

BENCH_PROMPT_SET = [
    "a photo of a cat wearing a tiny hat",
    "an oil painting of a lighthouse in a storm",
    "a macro shot of a dew-covered spider web",
    "a watercolor fox in a snowy forest",
    "a neon-lit street market at night",
    "an astronaut riding a horse on the moon",
    "a bowl of ramen with chopsticks, studio light",
    "a stained-glass window of a blue whale",
]

PROMPT_EMBED_LEN = 32  # Ltxt
PROMPT_TOKEN_LEN = 8  # Ltok of the synthesized CLIP text tables


def small_clip_cfg(clip_mod: Any):
    """The ~15M-parameter CLIP reward tower of the ``small`` rungs."""
    tower = clip_mod.CLIPTowerConfig(256, 4, 4, 1024)
    return clip_mod.CLIPConfig(vision=tower, text=tower, image_size=128, patch_size=32, projection_dim=256)


def sana_rung_model(scale: str, tower_dtype: str = "float32") -> Dict[str, Any]:
    """``{"bcfg", "clip_b", "clip_h"}`` for ``tiny``/``small``/``mid``/
    ``flagship`` (flagship = Sana-Sprint 1.6B defaults, 32×32 latents →
    1024px, CLIP-B/32 and CLIP-H/14 at their published widths); ``clip_h``
    is ``None`` where the rung has no PickScore tower. ``tower_dtype`` is
    the reward towers' compute dtype."""
    import dataclasses

    from .backends.sana_backend import SanaBackendConfig
    from .models import clip, dcae, sana
    from .utils.pytree import resolve_float_dtype

    tower = lambda cfg: dataclasses.replace(cfg, compute_dtype=resolve_float_dtype(tower_dtype))  # noqa: E731
    if scale == "tiny":
        model = sana.SanaConfig(
            in_channels=4, out_channels=4, d_model=32, n_layers=2, n_heads=4,
            cross_n_heads=4, caption_dim=16, ff_ratio=2.0,
        )
        vae = dcae.DCAEConfig(latent_channels=4, channels=(16, 16, 8), blocks_per_stage=(1, 1, 1), attn_stages=())
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=8, height_latent=8)
        t = clip.CLIPTowerConfig(32, 2, 2, 64)
        clip_b = tower(clip.CLIPConfig(vision=t, text=t, image_size=32, patch_size=16,
                                       vocab_size=64, max_positions=8, projection_dim=32))
        clip_h = clip_b
    elif scale == "small":
        model = sana.SanaConfig(
            in_channels=8, out_channels=8, d_model=384, n_layers=4, n_heads=12,
            cross_n_heads=6, caption_dim=384, ff_ratio=2.5,
        )
        vae = dcae.DCAEConfig(latent_channels=8, channels=(128, 128, 64, 32), blocks_per_stage=(1, 1, 1, 1), attn_stages=(0,))
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=16, height_latent=16)
        clip_b = tower(small_clip_cfg(clip))
        clip_h = clip_b
    elif scale == "mid":
        model = sana.SanaConfig(
            d_model=1152, n_layers=12, n_heads=36, cross_n_heads=16, caption_dim=2304, ff_ratio=2.5,
        )
        vae = dcae.DCAEConfig(channels=(512, 512, 256, 256, 128, 64))
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=16, height_latent=16)
        clip_b, clip_h = tower(clip.CLIP_B32), None
    elif scale == "flagship":
        bcfg = SanaBackendConfig(width_latent=32, height_latent=32)
        clip_b, clip_h = tower(clip.CLIP_B32), tower(clip.CLIP_H14)
    else:
        raise ValueError(f"unknown sana rung scale: {scale!r}")
    return {"bcfg": bcfg, "clip_b": clip_b, "clip_h": clip_h}


def var_rung_model(scale: str, tower_dtype: str = "float32") -> Dict[str, Any]:
    """``{"bcfg", "clip_b", "clip_h"}`` of a VAR rung: ``tiny`` (the JAX
    package's ``train/cli.py --model_scale tiny`` geometry, f32, a tiny CLIP
    tower and no PickScore tower) or ``d16`` (VAR-d16 over the
    ``vae_ch160v4096z32`` VQ-VAE, bf16, a 16-class pool, CLIP-B/32 and
    CLIP-H/14 at their published widths)."""
    import dataclasses

    import torch

    from .backends.var_backend import VarBackendConfig
    from .models import clip, msvq, var
    from .utils.pytree import resolve_float_dtype

    tower = lambda cfg: dataclasses.replace(cfg, compute_dtype=resolve_float_dtype(tower_dtype))  # noqa: E731
    if scale == "tiny":
        vq = msvq.MSVQConfig(vocab_size=64, c_vae=8, patch_nums=(1, 2, 4), phi_partial=2, ch=8, ch_mult=(1, 1),
                             num_res_blocks=1, compute_dtype=torch.float32)
        model = var.VARConfig(vq=vq, num_classes=10, depth=2, d_model=32, n_heads=4, ff_ratio=2.0,
                              patch_nums=(1, 2, 4), compute_dtype=torch.float32)
        bcfg = VarBackendConfig(model=model)
        t = clip.CLIPTowerConfig(16, 2, 2, 32)
        clip_b = tower(clip.CLIPConfig(vision=t, text=t, image_size=32, patch_size=16, vocab_size=49408,
                                       max_positions=77, projection_dim=16))
        clip_h = None
    elif scale == "d16":
        bcfg = VarBackendConfig(model=var.VARConfig(), class_pool=tuple(range(16)))
        clip_b, clip_h = tower(clip.CLIP_B32), tower(clip.CLIP_H14)
    else:
        raise ValueError(f"unknown var rung scale: {scale!r}")
    return {"bcfg": bcfg, "clip_b": clip_b, "clip_h": clip_h}


def infinity_rung_model(scale: str, tower_dtype: str = "float32") -> Dict[str, Any]:
    """``{"bcfg", "clip_b", "clip_h"}`` of an Infinity rung: ``tiny`` (the
    JAX package's ``train/cli.py --model_scale tiny`` geometry: depth 2, d
    16, 2 heads, text_dim 12, patch_nums (1, 2, 4), a 4-bit tokenizer, f32;
    a tiny CLIP tower and no PickScore tower) or ``2b`` (Infinity-2B as its
    released checkpoint is configured, ``infinity.released_config("2b",
    "1M")``: depth 32, d 2048, 16 heads of 128, text_dim 2048, 14 scales to
    64×64, L 9451, the 32-bit tokenizer, QK-l2, 2D RoPE and QK-l2
    cross-attention, bf16; CLIP-B/32 and CLIP-H/14 at their published
    widths)."""
    import dataclasses

    import torch

    from .backends.infinity_backend import InfinityBackendConfig
    from .models import bsq, clip, infinity
    from .utils.pytree import resolve_float_dtype

    tower = lambda cfg: dataclasses.replace(cfg, compute_dtype=resolve_float_dtype(tower_dtype))  # noqa: E731
    if scale == "tiny":
        pns = (1, 2, 4)
        vq = bsq.BSQConfig(bits=4, patch_nums=pns, phi_partial=2, dec_ch=(8, 8), dec_blocks=1,
                           compute_dtype=torch.float32)
        model = infinity.InfinityConfig(depth=2, d_model=16, n_heads=2, ff_ratio=2.0, text_dim=12, patch_nums=pns,
                                        vq=vq, compute_dtype=torch.float32)
        t = clip.CLIPTowerConfig(16, 2, 2, 32)
        clip_b = tower(clip.CLIPConfig(vision=t, text=t, image_size=32, patch_size=16, vocab_size=49408,
                                       max_positions=77, projection_dim=16))
        clip_h = None
    elif scale == "2b":
        model = infinity.released_config("2b", "1M")
        clip_b, clip_h = tower(clip.CLIP_B32), tower(clip.CLIP_H14)
    else:
        raise ValueError(f"unknown infinity rung scale: {scale!r}")
    return {"bcfg": InfinityBackendConfig(model=model), "clip_b": clip_b, "clip_h": clip_h}
