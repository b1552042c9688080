"""Model geometries and serving plans per rung (the port's copy of the Sana
part of ``hyperscalees_t2i_tpu/rungs.py``).

Module-level code is stdlib-only; :func:`sana_rung_model` imports the model
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

# the frozen base's storage per rung (the JAX package's RUNG_OPT base_quant):
# the small rungs stay float, the big ones store kernels int8
RUNG_BASE_QUANT = {"tiny": "off", "small": "off", "mid": "int8", "flagship": "int8"}

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


def sana_rung_model(scale: str) -> Dict[str, Any]:
    """``{"bcfg": SanaBackendConfig}`` for ``tiny``/``small``/``mid``/``flagship``
    (flagship = Sana-Sprint 1.6B defaults, 32×32 latents → 1024px)."""
    from .backends.sana_backend import SanaBackendConfig
    from .models import dcae, sana

    if scale == "tiny":
        model = sana.SanaConfig(
            in_channels=4, out_channels=4, d_model=32, n_layers=2, n_heads=4,
            cross_n_heads=4, caption_dim=16, ff_ratio=2.0,
        )
        vae = dcae.DCAEConfig(latent_channels=4, channels=(16, 16, 8), blocks_per_stage=(1, 1, 1), attn_stages=())
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=8, height_latent=8)
    elif scale == "small":
        model = sana.SanaConfig(
            in_channels=8, out_channels=8, d_model=384, n_layers=4, n_heads=12,
            cross_n_heads=6, caption_dim=384, ff_ratio=2.5,
        )
        vae = dcae.DCAEConfig(latent_channels=8, channels=(128, 128, 64, 32), blocks_per_stage=(1, 1, 1, 1), attn_stages=(0,))
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=16, height_latent=16)
    elif scale == "mid":
        model = sana.SanaConfig(
            d_model=1152, n_layers=12, n_heads=36, cross_n_heads=16, caption_dim=2304, ff_ratio=2.5,
        )
        vae = dcae.DCAEConfig(channels=(512, 512, 256, 256, 128, 64))
        bcfg = SanaBackendConfig(model=model, vae=vae, width_latent=16, height_latent=16)
    elif scale == "flagship":
        bcfg = SanaBackendConfig(width_latent=32, height_latent=32)
    else:
        raise ValueError(f"unknown sana rung scale: {scale!r}")
    return {"bcfg": bcfg}
