#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero before printing a
result):

1. build every CUDA kernel of the serving path from ``csrc/`` with ``nvcc``
   (one process per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at every
   shape the flagship serving path gives it, in bf16 and f32, and time the
   kernel, the plain version, one PyTorch library call computing the same
   function (``library_ms``, a yardstick the port never calls) and the
   card's lower bound for the work;
3. check the port end to end on a small input: the tiny rung with an int8
   base in f32 on the card against the same request on the CPU (the CPU
   path is the one the tests hold against the JAX package);
4. the main path: the flagship serving backend (Sana-Sprint 1.6B at full
   width, DC-AE decoding to 1024×1024, bf16 compute, int8 base, random
   weights from a seed) behind ``ServeEngine`` with ``SERVE_PLAN
   ["flagship"]``; two tenants' adapters, four requests through
   ``submit``/``flush``. Kernel launch counters are set to 0 just before and
   read just after; every kernel must have launched the expected number of
   times. Images must be ``[1, 1024, 1024, 3]``, finite, in [0, 1], differ
   between tenants, and a request served in a batch must match it served
   alone.

Output: the per-shape kernel table and the serving numbers on stdout, a
JSON copy in ``build/chip_smoke.json``, then the card's name and power
limit, a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Without a CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12

# K1 call shapes on the flagship serving path, per image:
# (site, tokens T, din, dout, activation dtype on the main path, calls)
K1_SHAPES = [
    ("time/guidance linear_1", 1, 256, 2240, "float32", 2),
    ("time/guidance linear_2", 1, 2240, 2240, "float32", 2),
    ("time_embed/linear", 1, 2240, 13440, "float32", 1),
    ("caption_proj/linear_1", 32, 2304, 2240, "bfloat16", 1),
    ("caption_proj/linear_2 + attn2 k,v", 32, 2240, 2240, "bfloat16", 1 + 40),
    ("attn1 q,k,v,out + attn2 q,out", 1024, 2240, 2240, "bfloat16", 120),
    ("ff conv_inverted", 1024, 2240, 11200, "bfloat16", 20),
    ("ff conv_point", 1024, 5600, 2240, "bfloat16", 20),
    ("patch_embed", 1024, 32, 2240, "bfloat16", 1),
    ("proj_out", 1024, 2240, 32, "bfloat16", 1),
    ("dcae s0 qkv", 1024, 1024, 3072, "bfloat16", 2),
    ("dcae s0 proj", 1024, 1024, 1024, "bfloat16", 2),
    ("dcae s0 conv_inverted", 1024, 1024, 4096, "bfloat16", 2),
    ("dcae s0 conv_point", 1024, 2048, 1024, "bfloat16", 2),
    ("dcae s1 qkv", 4096, 1024, 3072, "bfloat16", 2),
    ("dcae s1 proj", 4096, 1024, 1024, "bfloat16", 2),
    ("dcae s1 conv_inverted", 4096, 1024, 4096, "bfloat16", 2),
    ("dcae s1 conv_point", 4096, 2048, 1024, "bfloat16", 2),
]
N_REQUESTS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fns, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls that
    rotate over ``fns`` (distinct input copies, so weights larger than a
    fraction of L2 are read from device memory as on the main path)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from hyperscalees_t2i_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(["int8_matmul"])
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        ptxas = [l.strip() for l in text.splitlines() if "registers" in l or "smem" in l]
        log(f"[build] {name}: built in {dt:.1f} s; {' | '.join(ptxas) or text.strip()}")
    return dt


def phase_kernel_check(torch):
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul, int8_matmul_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for site, T, din, dout, main_dt, calls in K1_SHAPES:
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            esize = torch.tensor([], dtype=dt).element_size()
            call_bytes = T * din * esize + din * dout + 4 * dout + T * dout * esize
            copies = max(1, min(8, math.ceil(100e6 / call_bytes)))
            sets = []
            for _ in range(copies):
                x = torch.randn(T, din, generator=g, device=dev).to(dt)
                q8 = torch.randint(-127, 128, (din, dout), generator=g, device=dev, dtype=torch.int8)
                scale = torch.rand(1, dout, generator=g, device=dev) * (2.0 / (127 * math.sqrt(din)))
                sets.append((x, q8, scale, (q8.to(torch.float32) * scale).to(dt)))
            x, q8, scale, _ = sets[0]
            out = int8_matmul(x, q8, scale)
            torch.cuda.synchronize()
            ref = int8_matmul_reference(x, q8, scale).float()
            err = float((out.float() - ref).abs().max())
            ref_max = float(ref.abs().max())
            tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * ref_max
            if not (err <= tol and bool(torch.isfinite(out).all())):
                raise AssertionError(f"int8_matmul disagrees at {site} {T}x{din}x{dout} {dt_name}: "
                                     f"max abs err {err} > {tol}")
            reps = 20 if T * din * dout < 5e9 else 10
            ms = time_ms(torch, [lambda s=s: int8_matmul(s[0], s[1], s[2]) for s in sets], reps)
            plain = time_ms(torch, [lambda s=s: int8_matmul_reference(s[0], s[1], s[2]) for s in sets], reps)
            lib = time_ms(torch, [lambda s=s: torch.matmul(s[0], s[3]) for s in sets], reps)
            flop = 2.0 * T * din * dout
            t_ops = flop / PEAK_FLOPS[dt_name] * 1e3
            t_bytes = call_bytes / PEAK_BYTES_S * 1e3
            rows.append(dict(
                site=site, T=T, din=din, dout=dout, dtype=dt_name, main_path=dt_name == main_dt,
                calls_per_image=calls if dt_name == main_dt else 0,
                max_abs_err=err, tol=tol, ref_max=ref_max, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                tflops=flop / ms / 1e9,
            ))
            r = rows[-1]
            log(f"[k1] {site:34s} T={T:5d} {din:5d}x{dout:5d} {dt_name:8s} "
                f"{'main' if r['main_path'] else '    '} err={err:.3g} rel={err / ref_max:.3g} (tol {tol:.3g}) "
                f"ms={ms:.4f} plain={plain:.4f} library={lib:.4f} bound={r['bound_ms']:.4f} "
                f"({r['bound_by']}) {r['tflops']:.1f} TFLOP/s")
            del sets, x, q8, scale, out, ref
    torch.cuda.empty_cache()
    return rows


def phase_small_reference(torch):
    """Tiny rung, f32, int8 base (every kernel quantized): the card's serving
    path (CUDA kernel, cuDNN convs with TF32 off) against the CPU's (plain
    versions) on the same weights, adapter and request."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
    from hyperscalees_t2i_tpu_torch.models import dcae, sana
    from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
    from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    bcfg = sana_rung_model("tiny")["bcfg"]
    bcfg = dataclasses.replace(
        bcfg, model=dataclasses.replace(bcfg.model, compute_dtype=torch.float32),
        vae=dataclasses.replace(bcfg.vae, compute_dtype=torch.float32))
    cpu = torch.device("cpu")
    params = quantize_tree(sana.init_sana(bcfg.model, torch.Generator().manual_seed(5)), min_size=0)
    vae = quantize_tree(dcae.init_decoder(bcfg.vae, torch.Generator().manual_seed(6)), min_size=0)
    prompts = ["a red cube", "a blue sphere"]
    outs = {}
    for dev in (cpu, torch.device("cuda")):
        b = SanaBackend(bcfg, dev, params=tree_map(lambda t: t.to(dev), params),
                        vae_params=tree_map(lambda t: t.to(dev), vae), prompts=prompts)
        b.setup()
        theta = b.init_theta(torch.Generator().manual_seed(7))
        gen = torch.Generator().manual_seed(8)
        theta = {k: {f: v + 0.05 * torch.randn(v.shape, generator=gen) for f, v in d.items()}
                 for k, d in theta.items()}
        with torch.inference_mode():
            outs[dev.type] = b.generate(theta, [0, 1], seed=11).float().cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    log(f"[small] tiny rung f32 int8, card vs CPU: max abs diff {err:.3g} (tol 1e-4) "
        f"shape {tuple(outs['cuda'].shape)}")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU disagree on the tiny rung: {err}")
    return err


def stage_breakdown(torch, backend, theta, reps: int = 3):
    """Device time of one image's two stages, DiT + one-step sampler and
    DC-AE decode, by CUDA events around each (mean of ``reps`` warm runs)."""
    from hyperscalees_t2i_tpu_torch.models import dcae, sana

    cfg = backend.cfg
    lora = {k: {f: t.to(backend.device)[None] for f, t in d.items()} for k, d in theta.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    gen_ms = dec_ms = 0.0
    with torch.inference_mode():
        for i in range(reps + 1):
            ev[0].record()
            lat = sana.one_step_generate(
                backend.model, backend.prompt_embeds[:1], backend.prompt_mask[:1], seed=0,
                guidance_scale=cfg.guidance_scale, latent_hw=(cfg.height_latent, cfg.width_latent),
                lora=lora, lora_scale=backend.lora_scale,
            )
            ev[1].record()
            dcae.decode(backend.vae, lat / cfg.vae.scaling_factor)
            ev[2].record()
            torch.cuda.synchronize()
            if i:  # the first run warms up
                gen_ms += ev[0].elapsed_time(ev[1]) / reps
                dec_ms += ev[1].elapsed_time(ev[2]) / reps
    log(f"[serve] one image, device time: DiT + sampler {gen_ms:.2f} ms, DC-AE decode {dec_ms:.2f} ms")
    return {"dit_and_sampler": gen_ms, "dcae_decode": dec_ms}


def phase_serve(torch):
    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_BASE_QUANT, SERVE_PLAN, sana_rung_model
    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    backend = build_serve_backend(sana_rung_model("flagship")["bcfg"], RUNG_BASE_QUANT["flagship"],
                                  device="cuda", prompts=BENCH_PROMPT_SET, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    routed = [m for m in list(backend.model.modules()) + list(backend.vae.modules()) if hasattr(m, "q8")]
    plan = SERVE_PLAN["flagship"]
    eng = ServeEngine(backend, ServeConfig(device="cuda", **plan))
    gen = torch.Generator().manual_seed(42)
    for i in range(2):
        theta = backend.init_theta(gen)
        theta = {k: {"a": d["a"], "b": 0.05 * torch.randn(d["b"].shape, generator=gen)} for k, d in theta.items()}
        eng.put_adapter(f"tenant{i}", theta)
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    log(f"[serve] flagship backend built in {build_s:.1f} s, warmup {warm_s:.1f} s; "
        f"{len(routed)} int8 sites route to the kernel; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.synchronize()
    int8_matmul.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(f"tenant{i % 2}", [i // 2], seed=i // 2) for i in range(N_REQUESTS)]
    results = eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"int8_matmul": int8_matmul.launches}

    images_per_req = plan["images_per_request"]
    expected = len(routed) * N_REQUESTS * images_per_req
    if launches["int8_matmul"] != expected:
        raise AssertionError(f"int8_matmul launched {launches['int8_matmul']} times, expected {expected}")
    if [r.request.request_id for r in results] != [r.request_id for r in reqs] or not all(r.ok for r in results):
        raise AssertionError("not every request was served")
    for r in results:
        im = r.images
        if im.shape != (images_per_req, 1024, 1024, 3):
            raise AssertionError(f"image shape {im.shape}")
        if not (math.isfinite(float(im.sum())) and im.min() >= 0.0 and im.max() <= 1.0):
            raise AssertionError("image not finite or outside [0, 1]")
    tenant_diff = float(abs(results[0].images - results[1].images).max())  # same seed, other adapter
    if not tenant_diff > 0:
        raise AssertionError("two tenants' adapters gave the same image")
    solo = eng.generate(results[0].request.adapter_id, results[0].request.prompt_ids, results[0].request.seed)
    solo_diff = float(abs(solo - results[0].images).max())
    if not solo_diff <= 1e-2:
        raise AssertionError(f"batched and solo results differ by {solo_diff}")
    breakdown = stage_breakdown(torch, backend, eng.store.get("tenant0"))
    stats = dict(
        breakdown_ms=breakdown,
        requests=N_REQUESTS, images=N_REQUESTS * images_per_req, wall_s=wall,
        images_per_s=N_REQUESTS * images_per_req / wall,
        batch_latency_s=eng.dispatch_seconds[:-1], solo_latency_s=eng.dispatch_seconds[-1],
        build_s=build_s, warmup_s=warm_s, launches=launches, expected_launches=expected,
        k1_calls_per_image=len(routed), batched_vs_solo_max_abs=solo_diff,
        tenant_max_abs_diff=tenant_diff, plan=plan,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"[serve] {N_REQUESTS} requests in {wall:.3f} s = {stats['images_per_s']:.3f} images/s; "
        f"per-batch latency {', '.join(f'{s:.3f}' for s in stats['batch_latency_s'])} s; "
        f"solo {stats['solo_latency_s']:.3f} s; int8_matmul launches {launches['int8_matmul']} "
        f"(expected {expected}); batched vs solo max abs {solo_diff:.3g}; tenants differ by {tenant_diff:.3g}")
    return stats


def kernel_summary(rows, launches):
    """One entry per kernel: its calls for one flagship image, summed."""
    main = [r for r in rows if r["main_path"]]
    total = lambda key: sum(r[key] * r["calls_per_image"] for r in main)  # noqa: E731
    ops_ms = sum(r["bound_ms"] * r["calls_per_image"] for r in main if r["bound_by"] == "operations")
    bytes_ms = sum(r["bound_ms"] * r["calls_per_image"] for r in main if r["bound_by"] == "bytes")
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "hyperscalees_t2i_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "hyperscalees_t2i_tpu/ops/quant_mm.py:86",
        "launches": launches["int8_matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": total("library_ms"),
        "scope": f"one flagship image's {sum(r['calls_per_image'] for r in main)} calls",
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not (ROOT / "hyperscalees_t2i_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    build_s = phase_build()
    rows = phase_kernel_check(torch)
    small_err = phase_small_reference(torch)
    serve = phase_serve(torch)
    kern = kernel_summary(rows, serve["launches"])
    if kern["launches"] != serve["k1_calls_per_image"] * serve["images"]:
        raise AssertionError("kernel table and launch count disagree")

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, device=torch.cuda.get_device_name(0), torch=torch.__version__, build_s=build_s,
        k1_shapes=rows, small_reference_max_abs=small_err, serve=serve, kernels=[kern],
    ), indent=1))
    log(f"[done] per-image K1 (main-path shapes): {kern['ms']:.3f} ms kernel, {kern['plain_ms']:.3f} ms plain, "
        f"{kern['library_ms']:.3f} ms library, {kern['bound_ms']:.3f} ms bound ({kern['bound_by']})")
    print(smi)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
