"""Model geometries, ES plans, knobs, serving plans and the rung runner's
tables per rung (the port's copy of ``hyperscalees_t2i_tpu/rungs.py``, plus
the port's own ``ar_d16`` and ``inf_2b`` rungs).

Module-level code is stdlib-only (the rung runner's parent process,
``tools/bench.py``, reads these tables without importing torch);
:func:`sana_rung_model`, :func:`var_rung_model` and
:func:`infinity_rung_model` import the model configs when called.
"""

from __future__ import annotations

from typing import Any, Dict

# default serving geometry per rung: adapter lanes per dispatch, images per
# request, lanes per chunk inside a dispatch (0 = all)
SERVE_PLAN = {
    "tiny": {"adapter_batch": 16, "images_per_request": 1, "member_batch": 0},
    "small": {"adapter_batch": 4, "images_per_request": 1, "member_batch": 0},
    "popscale": {"adapter_batch": 8, "images_per_request": 1, "member_batch": 4},
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
    "popscale": {"rates": [2.0, 4.0, 8.0, 16.0, 32.0], "window_s": 10.0,
                 "zipf_s": 1.1, "population": 10000, "store_adapters": 256, "slo_p99_s": 5.0},
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
    # the flagship's generator alone (no DC-AE, no reward towers, the
    # latents' mean as the reward): flagship − flaggen is the decode-and-
    # reward share of an epoch
    "flaggen": ("flagship_gen", 4, 4, 1),
    # VAR next-scale AR at the JAX package's cut geometry (depth 6, d 512,
    # a small VQ-VAE and CLIP tower; bench.py's _build_ar)
    "ar": ("ar_small", 16, 4, 4),
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
    # the JAX table's flaggen is untiled (reward_tile 0), so its DiT runs 4
    # images a call where the flagship's runs 1, and flagship − flaggen also
    # holds the DiT's batching gain; the port's runs at the flagship's tile,
    # so the difference is decode and rewards alone (ROADMAP queue C)
    "flaggen": {**DEFAULT_OPT, **_BIG_OPT, "reward_tile": 1, "pop_fuse": True},
    "ar": dict(DEFAULT_OPT),
    "ar_d16": dict(DEFAULT_OPT),  # the JAX package's "ar" knobs
    "inf_2b": dict(DEFAULT_OPT),  # the JAX CLI's defaults: no pop_fuse, a float base
}


def rung_opt(rung: str) -> Dict[str, Any]:
    """The rung's knobs (all off for an unknown rung)."""
    return dict(RUNG_OPT.get(rung, DEFAULT_OPT))


# the frozen base's storage per serving rung
RUNG_BASE_QUANT = {r: RUNG_OPT[r]["base_quant"] for r in SERVE_PLAN}

# The rung runner (tools/bench.py). RUNG_EST_S: a rung's seconds in the
# ladder's child (build, counted warm-up, capture, the timed epochs), what
# the child checks against its remaining budget before it starts a rung (a
# skip line beats a kill). The card's (NVIDIA H100 80GB HBM3, 700.00 W):
# chip_smoke.py's phase_bench measured tiny 13.2 s (the process's first
# CUDA work included), flaggen 7.8 (at the flagship's reward_tile), flagship
# 14.1 and ar_d16 13.2, here at least doubled; the rungs it does not run are scaled from those by their
# epochs' work (popscale and midpop 8×, flagpop 4× a flagship-like epoch;
# inf_2b from its build and epoch in chip_smoke.py's Infinity phases).
RUNG_EST_S = {
    "tiny": 30, "small": 30, "popscale": 60, "mid": 30, "flagship": 40,
    "midpop": 90, "flagpop": 90, "flaggen": 20, "ar": 30, "ar_d16": 40, "inf_2b": 240,
}
# Steps a chained window replays before its one read-back (run_training's
# steps_per_dispatch): the counterpart of the JAX runner's fori_loop program.
# On the card a chain replays the step's one CUDA graph, so it costs no second
# program and no memory beyond the step's, only the chain's epochs; the rungs
# whose epoch is long against a read-back (the flagship, flaggen, the VAR-d16
# and Infinity-2B rungs: 0.5 s and more an epoch) time no chained window.
RUNG_CHAIN = {"tiny": 16, "small": 8, "popscale": 4, "mid": 2, "flagship": 0, "ar": 4}
# Rungs whose chained window runs only when the step's measured peak (the
# allocator's peak plus the graph's pool) fits the card's memory
# (utils/mfu.hbm_bytes_for_kind); an unknown capacity (the CPU) passes.
RUNG_CHAIN_FIT_GATED = ("mid", "midpop", "flagship", "flagpop")
# tools/bench.py --scaling: the default process counts of a scaling run
# (one tools/launch_local.py launch each; on one card the processes share it)
SCALING_DEVICE_COUNTS = (1, 2, 4)

# the JAX package's Pallas environment flags by their short names: the
# reference's bench records carry them (``pallas_env``), and the report
# renders them as its marks
PALLAS_ENV_FLAGS = {
    "HSES_USE_PALLAS": "flash",
    "HSES_POP_FUSE_PALLAS": "lora",
    "HSES_BASE_QUANT_PALLAS": "q8mm",
    "HSES_FUSED_QLORA_PALLAS": "qlora",
}


def pallas_flag_marks(flags: Dict[str, str]) -> str:
    """A record's ``pallas_env`` rendered by short names, opt-outs suffixed
    ``-`` (``"qlora,flash-"``); empty when nothing is set."""
    marks = []
    for flag, short in PALLAS_ENV_FLAGS.items():
        if flag in flags:
            v = flags[flag]
            marks.append(short if v == "1" else f"{short}-" if v.lower() in ("0", "off") else f"{short}={v}")
    return ",".join(marks)


def kernel_marks(d: Dict[str, Any]) -> list:
    """The comparability marks of a geometry or rung record: the factored
    member path (``fuse``), the int8 base (``q8``), and, on the JAX
    package's records, unified int8+LoRA routing turned off (``uq-``), the
    Pallas flags set (``P:...``) and the kernels whose probe failed
    (``P!:...``). Absent keys mark nothing."""
    marks = []
    if d.get("pop_fuse"):
        marks.append("fuse")
    if d.get("base_quant") == "int8":
        marks.append("q8")
    if d.get("fused_qlora") is False:
        marks.append("uq-")
    if d.get("pallas_env"):
        p = pallas_flag_marks(d["pallas_env"])
        if p:
            marks.append(f"P:{p}")
    failed = sorted(k for k, v in (d.get("pallas_probes") or {}).items() if v is False)
    if failed:
        marks.append("P!:" + ",".join(failed))
    return marks


def knobs_str(d: Dict[str, Any]) -> str:
    """The knobs of a geometry or rung record in one token,
    ``<remat>/t<tile>/n-<dt>/w-<dt>`` plus the :func:`kernel_marks` suffix:
    the one rendering of the preflight report and ``tools/bench_report``.
    The port rematerializes nothing; ``remat`` renders the reference's
    value where a record carries one, else ``none``."""
    def dt(v: Any) -> str:
        return "bf16" if str(v).startswith("bf") else "f32"

    return (
        f"{d.get('remat', 'none')}/t{d.get('reward_tile', 0)}"
        f"/n-{dt(d.get('noise_dtype', 'float32'))}"
        f"/w-{dt(d.get('tower_dtype', 'float32'))}"
        + "".join(f"/{m}" for m in kernel_marks(d))
    )

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
    """``{"bcfg", "clip_b", "clip_h", "latent_only"}`` for ``tiny``/
    ``small``/``mid``/``flagship`` (flagship = Sana-Sprint 1.6B defaults,
    32×32 latents → 1024px, CLIP-B/32 and CLIP-H/14 at their published
    widths) and ``flagship_gen`` (the flagship's generator with
    ``decode_images=False``: ``latent_only``, no decoder is used and no
    tower is built); ``clip_h`` is ``None`` where the rung has no PickScore
    tower. ``tower_dtype`` is the reward towers' compute dtype."""
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
    elif scale in ("flagship", "flagship_gen"):
        bcfg = SanaBackendConfig(width_latent=32, height_latent=32, decode_images=scale == "flagship")
        clip_b, clip_h = tower(clip.CLIP_B32), tower(clip.CLIP_H14)
    else:
        raise ValueError(f"unknown sana rung scale: {scale!r}")
    return {"bcfg": bcfg, "clip_b": clip_b, "clip_h": clip_h, "latent_only": not bcfg.decode_images}


def var_rung_model(scale: str, tower_dtype: str = "float32") -> Dict[str, Any]:
    """``{"bcfg", "clip_b", "clip_h"}`` of a VAR rung: ``tiny`` (the JAX
    package's ``train/cli.py --model_scale tiny`` geometry, f32, a tiny CLIP
    tower and no PickScore tower), ``ar_small`` (the JAX ``bench.py``'s
    ``ar`` rung: depth 6, d 512, 8 heads over a ch-32 VQ-VAE, bf16, a
    16-class pool, the small CLIP tower and no PickScore tower) or ``d16`` (VAR-d16 over the
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
    elif scale == "ar_small":
        vq = msvq.MSVQConfig(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1)
        model = var.VARConfig(vq=vq, depth=6, d_model=512, n_heads=8, num_classes=16)
        bcfg = VarBackendConfig(model=model, class_pool=tuple(range(16)))
        clip_b, clip_h = tower(small_clip_cfg(clip)), None
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
