"""The ES training CLI (port of ``hyperscalees_t2i_tpu/train/cli.py`` for
the Sana one-step and pipeline, VAR, Infinity and Z-Image backends)::

    python -m hyperscalees_t2i_tpu_torch.train.cli --backend sana_one_step \\
        --model_scale tiny --device cpu --num_epochs 2 --run_dir runs
    python -m hyperscalees_t2i_tpu_torch.train.cli --backend sana_pipeline \\
        --num_inference_steps 2 --model_scale tiny --device cpu --run_dir runs
    python -m hyperscalees_t2i_tpu_torch.train.cli --backend infinity \\
        --infinity_variant 2b --pn 1M --allow_random_rewards true \\
        --pop_size 4 --prompts_per_gen 4 --prompts_txt prompts.txt
    python -m hyperscalees_t2i_tpu_torch.train.cli --backend zimage \\
        --model_scale tiny --device cpu --train_vae_decoder_lora true \\
        --base_quant int8 --pop_fuse true --run_dir runs

Flag names and defaults are the JAX CLI's for every flag the port's loop
reads, plus ``--device`` (default: the CUDA card; without one the CLI
raises unless ``--device cpu`` is given). Without ``--weights`` the
generator's weights are random, from the seed the JAX CLI draws them from.
``--weights`` takes a released-layout checkpoint (a torch pickle, a
``.safetensors`` file or a shard directory) through the converters of
``weights/``, as the JAX CLI does: a diffusers ``SanaTransformer2DModel``
(geometry inferred; ``--vae_weights`` is refused, no DC-AE converter
exists), ``var_d*.pth`` with its ``vae_ch160v4096z32.pth`` as
``--vae_weights`` (geometry inferred, ``--patch_nums`` for a non-canonical
schedule), or an Infinity transformer (``module.`` stripped,
``--infinity_variant`` and ``--pn`` applied before the conversion) with
its BSQ tokenizer as ``--vae_weights`` (random without it), or a Z-Image
transformer (a ``.gguf`` file too; ``model.`` stripped, geometry inferred)
with a diffusers ``AutoencoderKL`` as ``--vae_weights`` (geometry inferred;
without it the KL-VAE decoder is random at ``blocks_per_stage=3``).
``--backend zimage`` trains the dual adapter with
``--train_vae_decoder_lora true`` (conv LoRA on the decoder beside the
transformer's LoRA) and ``--quantize_transformer true`` stores the
transformer int8 as the reference's GGUF path does.
``--infinity_variant`` is the JAX CLI's ``from_preset`` for every variant,
``2b`` included (no QK-l2, no 2D RoPE, 16 bits); the released Infinity-2B
configuration is built through the ``inf_2b`` rung
(``backends.infinity_backend.build_train_backend("2b")``). The Infinity
float leaves are stored in the compute dtype; ``--base_quant int8``
quantizes every backend's generator tree (Infinity's BSQ tokenizer
included) and the reward towers' image sides after their text table, as
the JAX CLI does, and ``--pop_fuse`` takes the factored member path on
every backend. The reward towers are converted from a local Hugging Face
``CLIPModel`` (``--clip_model``, ``--pickscore_model``: a directory or the
local cache, nothing is downloaded); where a tower is unavailable it is
random above ``--model_scale tiny`` only with ``--allow_random_rewards
true``, and a missing PickScore tower is dropped with the other weights
renormalized, as in the JAX CLI. Prompts are tokenized by
``rewards.suite.tokenize_with_hf``. Exit codes: 0 done or preempted (a
slot was saved; rerun to resume), 3 halted by the rollback policy.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

from ..backends import BACKEND_MODULES

def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def parse_resume(v: str) -> bool:
    """``auto`` (resume from the newest valid slot when one exists) is an
    alias of true."""
    if isinstance(v, str) and v.lower() == "auto":
        return True
    return str2bool(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EGGROLL-ES trainer (PyTorch port)")
    p.add_argument("--backend", required=True, choices=list(BACKEND_MODULES))
    p.add_argument("--model_scale", default="full", choices=["tiny", "small", "full"])
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.add_argument("--prompts_txt", default=None)
    p.add_argument("--encoded_prompts", default=None,
                   help="encoded-prompt cache, .pt or .npz (sana, infinity, zimage)")
    p.add_argument("--labels_path", default=None, help="ImageNet class names (var)")
    p.add_argument("--var_classes", default=None, help="comma class pool, or 'all' (var)")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--num_inference_steps", type=int, default=None,
                   help="DiT passes an image (sana_pipeline; zimage's Euler steps, default 8)")
    p.add_argument("--train_vae_decoder_lora", type=str2bool, default=False,
                   help="zimage: evolve a conv LoRA on the KL-VAE decoder beside the transformer's")
    p.add_argument("--quantize_transformer", type=str2bool, default=False,
                   help="zimage: store the transformer int8 (the reference's GGUF path)")
    p.add_argument("--latent_size", type=int, default=None, help="latent grid (per side)")
    p.add_argument("--cfg_list", default=None, help="per-scale guidance, comma list (infinity)")
    p.add_argument("--tau_list", default=None, help="per-scale temperature, comma list (infinity)")
    p.add_argument("--enable_positive_prompt", action="store_true",
                   help="infinity: append the face-quality suffix to person prompts")
    p.add_argument("--infinity_variant", default=None, help="model preset: 2b, 8b, layer12..layer48")
    p.add_argument("--pn", default=None, help="scale-schedule preset: 0.06M, 0.25M, 1M")
    p.add_argument("--patch_nums", default=None,
                   help="explicit comma scale schedule of a non-canonical VAR checkpoint (the VQ pyramid follows)")
    p.add_argument("--weights", default=None,
                   help="generator checkpoint: a diffusers Sana transformer (file, directory or safetensors), "
                        "var_d*.pth, an Infinity transformer or a Z-Image transformer (.gguf too); its geometry is "
                        "inferred")
    p.add_argument("--vae_weights", default=None,
                   help="VAE checkpoint: vae_ch160v4096z32.pth for var, the BSQ tokenizer for infinity, a diffusers "
                        "AutoencoderKL for zimage")
    p.add_argument("--pop_size", type=int, default=8)
    p.add_argument("--sigma", type=float, default=0.01)
    p.add_argument("--lr_scale", type=float, default=1.0)
    p.add_argument("--egg_rank", type=int, default=4)
    p.add_argument("--antithetic", type=str2bool, default=True)
    p.add_argument("--promptnorm", type=str2bool, default=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--prompts_per_gen", type=int, default=2)
    p.add_argument("--batches_per_gen", type=int, default=1)
    p.add_argument("--member_batch", type=int, default=1)
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="epochs replayed per dispatch with one read-back (the step's CUDA graph on the card)")
    p.add_argument("--reward_tile", type=int, default=0)
    p.add_argument("--noise_dtype", default="float32", choices=["float32", "bfloat16", "bf16"])
    p.add_argument("--tower_dtype", default="float32", choices=["float32", "bfloat16", "bf16"])
    p.add_argument("--pop_fuse", type=str2bool, default=False)
    p.add_argument("--base_quant", default="off", choices=["off", "int8"])
    p.add_argument("--theta_max_norm", type=float, default=40.0)
    p.add_argument("--max_step_norm", type=float, default=0.0)
    p.add_argument("--w_aesthetic", type=float, default=0.3)
    p.add_argument("--w_text", type=float, default=0.3)
    p.add_argument("--w_noart", type=float, default=0.2)
    p.add_argument("--w_pick", type=float, default=0.2)
    p.add_argument("--clip_model", default="openai/clip-vit-base-patch32",
                   help="a local Hugging Face CLIPModel (directory or cache) for the CLIP reward tower")
    p.add_argument("--pickscore_model", default="yuvalkirstain/PickScore_v1",
                   help="a local Hugging Face CLIPModel for the PickScore tower")
    p.add_argument("--use_pickscore", type=str2bool, default=True)
    p.add_argument("--allow_random_rewards", type=str2bool, default=False,
                   help="proceed with random-init reward towers when their Hugging Face weights are unavailable")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--log_images_every", type=int, default=0,
                   help="save best/median/worst member strips every N epochs")
    p.add_argument("--log_hist_every", type=int, default=10,
                   help="θ/Δθ/reward histograms in metrics.jsonl every N epochs")
    p.add_argument("--profile_epochs", type=int, default=0,
                   help="capture a torch.profiler trace of the first N epochs")
    p.add_argument("--trace", type=str2bool, nargs="?", const=True, default=False,
                   help="write a host-side span timeline to run_dir/trace.jsonl")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="live telemetry: serve /metrics (Prometheus) + /healthz (JSON) on this port from a "
                        "daemon thread (0 = off)")
    p.add_argument("--metrics_host", default="0.0.0.0",
                   help="exporter bind address (default all interfaces; use 127.0.0.1 for loopback-only on "
                        "shared machines: the endpoint is unauthenticated)")
    p.add_argument("--metrics_linger_s", type=float, default=0.0,
                   help="keep the exporter up this many seconds after the run ends so pull-based scrapers "
                        "catch the final state of a short run (0 = stop with the run)")
    p.add_argument("--slo", default=None,
                   help="declarative SLOs evaluated per epoch, e.g. 'latency_p95=2s,availability=99.9' — "
                        "burn-rate gauges under slo/* plus loud stderr alerts (obs/slo.py)")
    p.add_argument("--heartbeat_interval_s", type=float, default=0.0,
                   help="liveness lines on stderr every N seconds during compile (warm-up + capture), "
                        "dispatch and checkpoint phases (0 = off)")
    p.add_argument("--stall_cap_s", type=float, default=0.0,
                   help="warn when a heartbeat-wrapped phase exceeds this many seconds (0 = off; needs "
                        "--heartbeat_interval_s)")
    p.add_argument("--stall_action", default="warn", choices=["warn", "checkpoint_exit"],
                   help="stall-watchdog escalation: warn = stderr line only; checkpoint_exit = latch a "
                        "graceful preemption (checkpoint at the next epoch boundary + exit 0)")
    p.add_argument("--es_degenerate_warn_epochs", type=int, default=5,
                   help="warn after N consecutive zero-fitness generations (0 = off)")
    p.add_argument("--anomaly_detect", type=str2bool, default=True,
                   help="ES-health anomaly watchdog: robust changepoint detection over es/* streams "
                        "(update-cosine collapse, pair-asym spikes, cap saturation, reward-std collapse) → "
                        "anomalies.jsonl + anomaly/* gauges + stderr ALERT/CLEAR + /healthz (obs/anomaly.py)")
    p.add_argument("--anomaly_window", type=int, default=32,
                   help="anomaly watchdog rolling-baseline window, in logged dispatches")
    p.add_argument("--anomaly_min_epochs", type=int, default=8,
                   help="observations required per stream before the watchdog issues any verdict (keeps "
                        "short smoke runs structurally silent)")
    p.add_argument("--anomaly_z", type=float, default=8.0,
                   help="robust z-score magnitude that counts as anomalous")
    p.add_argument("--quality", type=str2bool, default=True)
    p.add_argument("--quality_hack_window", type=int, default=4)
    p.add_argument("--snapshot_every", type=int, default=0,
                   help="save a decoded-image grid of the best member's prompts every N epochs under "
                        "run_dir/snapshots/ (CRN-exact regeneration, host-side PNG; 0 = off)")
    p.add_argument("--run_dir", default="runs")
    p.add_argument("--run_name", default=None)
    p.add_argument("--resume", type=parse_resume, default=True)
    p.add_argument("--ckpt_keep", type=int, default=3)
    p.add_argument("--ckpt_legacy_mirror", type=str2bool, default=True)
    p.add_argument("--rollback_policy", default="sigma_shrink", choices=["sigma_shrink", "skip", "halt"])
    p.add_argument("--max_rollbacks", type=int, default=3)
    p.add_argument("--rollback_sigma_shrink", type=float, default=0.5)
    p.add_argument("--theta_explode_norm", type=float, default=0.0)
    return p


def _scaled(args, full: dict, small: dict, tiny: dict) -> dict:
    return {"full": full, "small": small, "tiny": tiny}[args.model_scale]


def _dtype(name: str) -> str:
    return "bfloat16" if name == "bf16" else name


def parse_float_list(s: Optional[str]) -> Optional[Tuple[float, ...]]:
    """``"3,2.5"`` → ``(3.0, 2.5)``; empty → ``None``."""
    if not s:
        return None
    return tuple(float(x) for x in s.split(",") if x.strip())


def _prompts(path: Optional[str]) -> List[str]:
    """The prompt file's non-empty, non-``#`` lines (``a photo of a cat``
    without one), as the JAX Sana backend reads it."""
    prompts = ["a photo of a cat"]
    if path and Path(path).exists():
        lines = [l.strip() for l in Path(path).read_text().splitlines()]
        prompts = [l for l in lines if l and not l.startswith("#")] or prompts
    return prompts


def _load_checkpoint(path: str):
    from ..weights.io import load_state_dict

    t0 = time.perf_counter()
    sd = load_state_dict(path)
    print(f"[cli] read {path}: {len(sd)} tensors in {time.perf_counter() - t0:.1f} s", flush=True)
    return sd


def build_backend(args, device: torch.device):
    """The backend at the JAX CLI's geometry for ``--model_scale`` with
    random weights, or at the geometry of the ``--weights`` checkpoint with
    its converted weights; ``--base_quant`` on the generator's trees."""
    from ..ops.quant import maybe_quantize_tree
    from ..utils import threefry
    from ..weights.from_jax import tree_from_numpy

    if args.backend == "zimage":
        return _zimage_backend(args, device)
    f32 = torch.float32
    if args.backend in ("sana_one_step", "sana_pipeline"):
        from ..backends.sana_backend import SanaBackend, SanaBackendConfig
        from ..models import dcae, sana

        params = None
        if args.weights:
            from ..weights.sana import convert_sana_transformer, infer_sana_config

            if args.vae_weights:
                sys.exit("ERROR: no DC-AE (AutoencoderDC) converter exists yet — --vae_weights is not supported for "
                         "the sana backends. Drop the flag (the DC-AE decoder will be random-init; pixel "
                         "outputs/rewards are then NOT meaningful).")
            sd = _load_checkpoint(args.weights)
            model_cfg = infer_sana_config(sd)
            t0 = time.perf_counter()
            params = convert_sana_transformer(sd, model_cfg)
            del sd
            params = tree_from_numpy(params, device)
            print(f"[cli] loaded sana weights: {model_cfg.n_layers}L d={model_cfg.d_model} "
                  f"caption={model_cfg.caption_dim} (converted in {time.perf_counter() - t0:.1f} s)", flush=True)
            print("[cli] WARNING: DC-AE decoder is random-init (no AutoencoderDC converter yet) — decoded pixels and "
                  "pixel-space rewards are not meaningful until a converted VAE is supplied", flush=True)
        else:
            model_cfg = sana.SanaConfig(**_scaled(
                args, {}, dict(d_model=1120, n_layers=6, n_heads=35, cross_n_heads=10),
                dict(d_model=64, n_layers=2, n_heads=4, cross_n_heads=4, caption_dim=32, in_channels=4,
                     out_channels=4, compute_dtype=f32)))
        vkw = _scaled(args, {}, dict(channels=(256, 256, 128, 128, 64, 32)),
                      dict(latent_channels=4, channels=(16, 16), blocks_per_stage=(1, 1), attn_stages=(),
                           compute_dtype=f32))
        lat = args.latent_size or (32 if args.model_scale == "full" else 8)
        cfg = SanaBackendConfig(
            backend_mode="one_step" if args.backend == "sana_one_step" else "pipeline",
            model=model_cfg, vae=dcae.DCAEConfig(**vkw), encoded_prompt_path=args.encoded_prompts,
            guidance_scale=args.guidance_scale if args.guidance_scale is not None else 1.0,
            num_inference_steps=args.num_inference_steps or 2,
            width_latent=lat, height_latent=lat, lora_r=args.lora_r, lora_alpha=args.lora_alpha)
        # the weights SanaBackend.setup would draw, with the base_quant knob
        kt, kv = threefry.split(threefry.prng_key(cfg.seed_params, device))
        if params is None:
            params = sana.init_sana(cfg.model, kt)
        params = maybe_quantize_tree(params, args.base_quant)
        vae = maybe_quantize_tree(dcae.init_decoder(cfg.vae, kv), args.base_quant)
        return SanaBackend(cfg, device, params=params, vae_params=vae, prompts=_prompts(args.prompts_txt))
    if args.backend == "infinity":
        return _infinity_backend(args, device)

    from ..backends.var_backend import VarBackend, VarBackendConfig
    from ..es.sampling import parse_int_list
    from ..models import msvq, var as var_mod

    gs = args.guidance_scale if args.guidance_scale is not None else 4.0
    params = None
    if args.weights:
        from ..weights.var import convert_var_transformer, convert_vqvae, infer_var_config

        if not args.vae_weights:
            sys.exit("ERROR: --backend var --weights also needs --vae_weights (vae_ch160v4096z32.pth)")
        sd = _load_checkpoint(args.weights)
        overrides = dict(patch_nums=tuple(parse_int_list(args.patch_nums))) if args.patch_nums else {}
        model = infer_var_config(sd, **overrides)
        t0 = time.perf_counter()
        params = convert_var_transformer(sd, model)
        del sd
        convert_s = time.perf_counter() - t0
        sd = _load_checkpoint(args.vae_weights)
        t0 = time.perf_counter()
        params["vq"] = convert_vqvae(sd, model.vq)
        del sd
        params = tree_from_numpy(params, device)
        print(f"[cli] loaded var weights: depth={model.depth} d={model.d_model} heads={model.n_heads} (converted in "
              f"{convert_s + time.perf_counter() - t0:.1f} s)", flush=True)
        sampling = {}
    else:
        vq_kw = _scaled(args, {}, dict(ch=80, ch_mult=(1, 2, 2, 4), num_res_blocks=1),
                        dict(vocab_size=64, c_vae=8, patch_nums=(1, 2, 4), phi_partial=2, ch=8, ch_mult=(1, 1),
                             num_res_blocks=1, compute_dtype=f32))
        mkw = _scaled(args, {}, dict(depth=12, d_model=768, n_heads=12),
                      dict(num_classes=10, depth=2, d_model=32, n_heads=4, ff_ratio=2.0, patch_nums=(1, 2, 4),
                           compute_dtype=f32))
        model = var_mod.VARConfig(vq=msvq.MSVQConfig(**vq_kw), **mkw)
        # the tiny geometry samples without top-k/top-p filtering, as the JAX CLI's
        sampling = _scaled(args, {}, {}, dict(top_k=0, top_p=0.0))
    parsed = parse_int_list(args.var_classes) if args.var_classes else None
    cfg = VarBackendConfig(model=model, class_pool=tuple(parsed) if isinstance(parsed, list) else None,
                           labels_path=args.labels_path, cfg_scale=gs, lora_r=args.lora_r,
                           lora_alpha=args.lora_alpha, **sampling)
    if params is None:
        params = var_mod.init_var(model, threefry.prng_key(cfg.seed_params, device))
    return VarBackend(cfg, device, params=maybe_quantize_tree(params, args.base_quant))


def infinity_model(args, sd=None):
    """The JAX CLI's Infinity model: inferred from the transformer state
    dict ``sd`` (``--infinity_variant``'s preset overriding), else
    ``--infinity_variant``'s preset (``2b`` included), else for
    ``--model_scale``; ``--pn`` sets the schedule of both the transformer
    and the tokenizer, and without it the tiny random scale takes the tiny
    4-bit tokenizer. The released Infinity-2B configuration is the
    ``inf_2b`` rung's (``rungs.infinity_rung_model``)."""
    from ..models import bsq
    from ..models import infinity as inf_mod

    if sd is not None:
        from ..weights.infinity import infer_infinity_config

        overrides = dict(inf_mod.INFINITY_PRESETS[args.infinity_variant]) if args.infinity_variant else {}
        model = infer_infinity_config(sd, **overrides)
    elif args.infinity_variant:
        model = inf_mod.from_preset(args.infinity_variant)
    else:
        model = inf_mod.InfinityConfig(**_scaled(args, {}, dict(depth=8, d_model=512, n_heads=8),
                                                 dict(depth=2, d_model=16, n_heads=2, ff_ratio=2.0, text_dim=12,
                                                      patch_nums=(1, 2, 4), compute_dtype=torch.float32)))
    if args.pn:
        pns = inf_mod.PN_PRESETS[args.pn]
        model = dataclasses.replace(model, patch_nums=pns, vq=dataclasses.replace(model.vq, patch_nums=pns))
    elif args.model_scale == "tiny" and sd is None:
        model = dataclasses.replace(model, vq=bsq.BSQConfig(bits=4, patch_nums=model.patch_nums, phi_partial=2,
                                                            dec_ch=(8, 8), dec_blocks=1, compute_dtype=torch.float32))
    return model


def _infinity_backend(args, device: torch.device):
    from ..backends.infinity_backend import InfinityBackend, InfinityBackendConfig
    from ..models import infinity as inf_mod
    from ..ops.quant import maybe_quantize_tree, resolve_base_quant_min_size
    from ..utils import threefry
    from ..utils.pytree import cast_floating

    params = None
    if args.weights:
        from ..weights.infinity import convert_infinity_transformer
        from ..weights.io import strip_prefix
        from ..weights.from_jax import tree_from_numpy

        sd = strip_prefix(_load_checkpoint(args.weights), "module")
        model = infinity_model(args, sd)  # --pn before the conversion: lvl_emb is cut to its scales
        t0 = time.perf_counter()
        params = tree_from_numpy(convert_infinity_transformer(sd, model), device)
        del sd
        print(f"[cli] loaded infinity weights: depth={model.depth} d={model.d_model} bits={model.vq.bits} "
              f"(converted in {time.perf_counter() - t0:.1f} s)", flush=True)
    else:
        model = infinity_model(args)
    cfg = InfinityBackendConfig(
        model=model, prompts_txt_path=args.prompts_txt, encoded_prompt_path=args.encoded_prompts,
        vae_weights=args.vae_weights, enable_positive_prompt=args.enable_positive_prompt,
        cfg_list=parse_float_list(args.cfg_list), tau_list=parse_float_list(args.tau_list), lora_r=args.lora_r,
        lora_alpha=args.lora_alpha)
    if params is None:  # the weights InfinityBackend.setup would draw, the BSQ tokenizer included
        params = inf_mod.init_infinity(model, threefry.prng_key(cfg.seed_params, device))
    # the whole tree (a --vae_weights tokenizer included) in the compute
    # dtype, then --base_quant at the floor resolved now, as the JAX CLI
    # quantizes after setup
    floor = resolve_base_quant_min_size()
    return InfinityBackend(cfg, device, params=params,
                           prepare=lambda tree: maybe_quantize_tree(cast_floating(tree, model.compute_dtype),
                                                                    args.base_quant, floor))


def _zimage_backend(args, device: torch.device):
    """The JAX CLI's Z-Image backend: from ``--weights`` (and the KL-VAE
    decoder from ``--vae_weights``, else random at ``blocks_per_stage=3``)
    with their inferred geometry, else at ``--model_scale``'s, built by
    :func:`zimage_backend`."""
    from ..models import vaekl, zimage
    from ..weights.from_jax import tree_from_numpy

    f32 = torch.float32
    params = vae_params = None
    if args.weights:
        from ..weights.io import strip_prefix
        from ..weights.zimage import (convert_kl_decoder, convert_zimage_transformer, infer_kl_decoder_config,
                                      infer_zimage_config)

        sd = strip_prefix(_load_checkpoint(args.weights), "model")
        model_cfg = infer_zimage_config(sd)
        t0 = time.perf_counter()
        params = tree_from_numpy(convert_zimage_transformer(sd, model_cfg), device)
        del sd
        print(f"[cli] loaded zimage weights: {model_cfg.n_layers}L d={model_cfg.d_model} "
              f"caption={model_cfg.caption_dim} (converted in {time.perf_counter() - t0:.1f} s)", flush=True)
        vae_cfg = vaekl.VAEDecoderConfig(blocks_per_stage=3)  # the diffusers AutoencoderKL layout
        if args.vae_weights:
            sd = _load_checkpoint(args.vae_weights)
            vae_cfg = infer_kl_decoder_config(sd)
            vae_params = tree_from_numpy(convert_kl_decoder(sd, vae_cfg), device)
            del sd
            print(f"[cli] loaded KL-VAE decoder weights (ch={vae_cfg.ch})", flush=True)
        else:
            print("[cli] WARNING: KL-VAE decoder is random-init — decoded pixels and pixel-space rewards are not "
                  "meaningful until --vae_weights supplies the AutoencoderKL checkpoint", flush=True)
    else:
        model_cfg = zimage.ZImageConfig(**_scaled(
            args, {}, dict(d_model=512, n_layers=6, n_heads=8),
            dict(in_channels=4, d_model=24, n_layers=2, n_heads=2, caption_dim=12, ff_ratio=2.0, compute_dtype=f32)))
        vae_cfg = vaekl.VAEDecoderConfig(**_scaled(
            args, {}, dict(ch=(256, 128, 64)),
            dict(latent_channels=4, ch=(8, 8), blocks_per_stage=1, compute_dtype=f32)))
    return zimage_backend(args, model_cfg, vae_cfg, device, params=params, vae_params=vae_params)


def zimage_backend(args, model_cfg, vae_cfg, device: torch.device, params=None, vae_params=None):
    """The train CLI's Z-Image backend at ``model_cfg``/``vae_cfg``'s
    geometry: the flags' latent size, steps, guidance, prompts and adapters;
    ``params``/``vae_params`` (``None``: drawn by ``setup``, node by node)
    go through ``--quantize_transformer`` and then ``--base_quant`` on both
    trees (the floor resolved now), as the JAX CLI quantizes after setup."""
    from ..backends.zimage_backend import ZImageBackend, ZImageBackendConfig
    from ..ops.quant import maybe_quantize_tree, resolve_base_quant_min_size

    lat = args.latent_size or (16 if args.model_scale != "tiny" else 4)
    cfg = ZImageBackendConfig(
        model=model_cfg, vae=vae_cfg, prompts_txt_path=args.prompts_txt, encoded_prompt_path=args.encoded_prompts,
        num_steps=args.num_inference_steps or 8,
        guidance_scale=args.guidance_scale if args.guidance_scale is not None else 0.0,
        width_latent=lat, height_latent=lat, quantize_transformer=args.quantize_transformer,
        lora_r=args.lora_r, lora_alpha=args.lora_alpha, train_vae_decoder_lora=args.train_vae_decoder_lora)
    floor = resolve_base_quant_min_size()
    return ZImageBackend(cfg, device, params=params, vae_params=vae_params,
                         prepare=lambda tree: maybe_quantize_tree(tree, args.base_quant, floor))


def load_clip_tower(name: str, cfg, device: torch.device):
    """A local Hugging Face ``CLIPModel`` (a directory, or a model in the
    local cache; nothing is downloaded) converted to the tree of ``cfg``'s
    geometry on ``device``; ``None`` when unavailable."""
    try:
        from transformers import CLIPModel
    except Exception:
        return None
    from ..models.clip import convert_hf_clip_state_dict
    from ..weights.from_jax import tree_from_numpy

    try:
        model = CLIPModel.from_pretrained(name, local_files_only=True)
    except Exception:
        return None
    return tree_from_numpy(convert_hf_clip_state_dict(model.state_dict(), cfg), device)


def build_reward_fn(args, backend, device: torch.device):
    """The reward towers as the JAX CLI builds them: tiny, the JAX CLI's
    random tiny tower; else CLIP-B/32 and CLIP-H/14 (PickScore) in
    ``--tower_dtype`` from ``--clip_model`` and ``--pickscore_model``
    (:func:`load_clip_tower`), a random CLIP tower behind
    ``--allow_random_rewards`` and a missing PickScore tower dropped with
    the other weights renormalized. The text tables come from
    :func:`tokenize_with_hf`, then ``--base_quant`` goes on the image
    sides."""
    from ..models import clip as clip_mod
    from ..ops.quant import maybe_quantize_tree
    from ..rewards.suite import (AESTHETIC_TEXT, NEGATIVE_TEXT, RewardWeights, clip_text_embed_table,
                                 make_clip_reward_fn, pickscore_text_embeds, tokenize_with_hf)
    from ..utils import threefry
    from ..utils.pytree import resolve_float_dtype

    weights = RewardWeights(args.w_aesthetic, args.w_text, args.w_noart, args.w_pick)
    pparams = pcfg = None
    if args.model_scale == "tiny":
        tower = clip_mod.CLIPTowerConfig(16, 2, 2, 32)
        ccfg = clip_mod.CLIPConfig(vision=tower, text=tower, image_size=32, patch_size=16, vocab_size=49408,
                                   max_positions=77, projection_dim=16, compute_dtype=torch.float32)
        cparams = clip_mod.init_clip(ccfg, threefry.prng_key(11, device))
    else:
        dt = resolve_float_dtype(args.tower_dtype)
        ccfg = dataclasses.replace(clip_mod.CLIP_B32, compute_dtype=dt)
        cparams = load_clip_tower(args.clip_model, ccfg, device)
        pcfg = dataclasses.replace(clip_mod.CLIP_H14, compute_dtype=dt)
        pparams = load_clip_tower(args.pickscore_model, pcfg, device) if args.use_pickscore else None
        if cparams is None:
            if not args.allow_random_rewards:
                sys.exit("ERROR: CLIP weights unavailable (no local Hugging Face model). Pass "
                         "--allow_random_rewards true for a smoke run with random towers.")
            print("[cli] WARNING: random-init CLIP reward tower (smoke mode)", flush=True)
            cparams = clip_mod.init_clip(ccfg, threefry.prng_key(11, device))
        if args.use_pickscore and pparams is None:
            rest = weights.aesthetic + weights.align + weights.no_artifacts
            if rest > 0 and weights.pickscore > 0:
                scale = (rest + weights.pickscore) / rest
                weights = RewardWeights(aesthetic=weights.aesthetic * scale, align=weights.align * scale,
                                        no_artifacts=weights.no_artifacts * scale, pickscore=0.0)
            print(f"[cli] WARNING: PickScore tower unavailable → pickscore dropped, remaining reward weights "
                  f"renormalized to {weights}", flush=True)
    ids, eot, mask = (t.to(device) for t in tokenize_with_hf(list(backend.texts) + [AESTHETIC_TEXT, NEGATIVE_TEXT],
                                                             args.clip_model))
    pick_model = pick_embeds = None
    with torch.inference_mode():
        table = clip_text_embed_table(clip_mod.CLIPModel(ccfg, cparams), ids, eot, mask)
        if pparams is not None:
            pids, peot, pmask = (t.to(device) for t in tokenize_with_hf(list(backend.texts), args.pickscore_model))
            pick_embeds = pickscore_text_embeds(clip_mod.CLIPModel(pcfg, pparams), pids, peot, pmask)
    if pparams is not None:
        pick_model = clip_mod.CLIPModel(pcfg, maybe_quantize_tree(pparams, args.base_quant))
    return make_clip_reward_fn(clip_mod.CLIPModel(ccfg, maybe_quantize_tree(cparams, args.base_quant)), table,
                               weights=weights, pick_model=pick_model, pick_text_embeds=pick_embeds)


def train_config(args):
    from .config import TrainConfig

    return TrainConfig(
        num_epochs=args.num_epochs, pop_size=args.pop_size, sigma=args.sigma, lr_scale=args.lr_scale,
        egg_rank=args.egg_rank, antithetic=args.antithetic, promptnorm=args.promptnorm,
        prompts_per_gen=args.prompts_per_gen, batches_per_gen=args.batches_per_gen,
        member_batch=args.member_batch, steps_per_dispatch=args.steps_per_dispatch,
        reward_tile=args.reward_tile, pop_fuse=args.pop_fuse,
        base_quant=args.base_quant, noise_dtype=_dtype(args.noise_dtype), tower_dtype=_dtype(args.tower_dtype),
        theta_max_norm=args.theta_max_norm, max_step_norm=args.max_step_norm,
        reward_weights=(args.w_aesthetic, args.w_text, args.w_noart, args.w_pick),
        seed=args.seed, save_every=args.save_every, log_images_every=args.log_images_every,
        log_hist_every=args.log_hist_every, profile_epochs=args.profile_epochs, snapshot_every=args.snapshot_every,
        trace=args.trace,
        metrics_port=args.metrics_port, metrics_host=args.metrics_host, metrics_linger_s=args.metrics_linger_s,
        slo=args.slo, heartbeat_interval_s=args.heartbeat_interval_s, stall_cap_s=args.stall_cap_s,
        stall_action=args.stall_action, anomaly_detect=args.anomaly_detect, anomaly_window=args.anomaly_window,
        anomaly_min_epochs=args.anomaly_min_epochs, anomaly_z=args.anomaly_z,
        es_degenerate_warn_epochs=args.es_degenerate_warn_epochs, quality=args.quality,
        quality_hack_window=args.quality_hack_window, run_dir=args.run_dir, run_name=args.run_name,
        resume=args.resume, ckpt_keep=args.ckpt_keep, ckpt_legacy_mirror=args.ckpt_legacy_mirror,
        rollback_policy=args.rollback_policy, max_rollbacks=args.max_rollbacks,
        rollback_sigma_shrink=args.rollback_sigma_shrink, theta_explode_norm=args.theta_explode_norm,
    )


def main(argv: Optional[List[str]] = None) -> None:
    from ..device import resolve_device
    from .trainer import run_training

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    backend = build_backend(args, device)
    backend.setup()
    reward_fn = build_reward_fn(args, backend, device)
    state = run_training(backend, reward_fn, train_config(args), device=device)
    if state.preempted:
        print(f"[cli] preempted at epoch {state.epoch} — checkpoint saved; restart with --resume auto to "
              "continue", flush=True)
        sys.exit(0)
    if state.halted:
        print(f"[cli] HALTED by rollback policy at epoch {state.epoch} after {state.rollbacks} rollback(s) — "
              "see halted.json in the run dir", flush=True)
        sys.exit(3)
    print(f"[cli] training done at epoch {state.epoch}", flush=True)


if __name__ == "__main__":
    main()
