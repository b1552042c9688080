#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero before printing a
result):

Every ES step and served batch of the card's paths is one program: a CUDA
graph per ES plan and per serving geometry (``utils.graphs``), captured at
its first call. The flagship, VAR-d16 and serving phases run it against the
eager program (``graph=False``) in turns in one process.

Launches are counted two ways. A kernel wrapper adds one to its counter
where it launches its kernel; a graph's replays run the kernels without the
wrappers, so the counters see eager runs only (a program's first call is
one). A replay's K1-K4 launches are counted on the device instead, by
kernel name, from ``torch.profiler`` over one replayed epoch or flush
(:func:`profiled_launches`), and held to the same derived counts.

1. build every CUDA kernel from ``csrc/`` with ``nvcc`` (one process per
   source and per part of a source built in parts, all at once): K1
   ``int8_matmul``, K2 ``lora_chain``, K3 ``fused_qlora`` (seven parts: the
   bf16 kernels of each tile and thin width apart), K4 ``decode_attention``; log each source's
   (and part's) compile seconds, each route's registers, spills and shared
   memory, and count the tensor-core instructions (``HMMA``) in each
   kernel's SASS (none in a bf16 route fails);
2. hold each kernel against its plain PyTorch version on the card at every
   shape its main path gives it, in the main-path dtype and in f32, and time
   the kernel, the plain version, one PyTorch library call computing the
   same function (``library_ms``, a yardstick the port never calls) and the
   card's lower bound for the work: K1 at the flagship DiT, DC-AE, CLIP-B/32
   and CLIP-H/14 shapes; K2 and K3 at the flagship's LoRA-adapted sites (K3
   also with q8 = 0 against the plain chain alone), each also by its device
   time under ``torch.profiler`` (``device_ms``, beside the plain version's)
   and its wrapper's host time a call (``host_us``);
   K4 at the ten VAR-d16 scale shapes (also by ``device_ms`` and
   ``host_us``), plus a masked dh-128 cross-attention shape, a multi-tile
   kv case, NaN garbage past ``kv_len`` and an all-masked row; K4 at
   Infinity-2B's 14 scales on its 8 rows (dh-128 self-attention against up
   to 9451 cache positions, masked cross-attention into 17 text positions
   under the main path's mask; the plain version row by row); K1, K2 and
   K3 at Infinity-2B's shapes in the main path's dtypes
   (:func:`phase_inf_kernel_check`: K3 and K2 at every adapted block site
   of each scale, 8 · pn² rows up to 32,768, K up to 8,192; K1 at the
   int8 base's other sites, its f32 route at ``word_embed``,
   ``text_proj``, ``pool_proj`` and the f32 towers); K4's
   invariance, bitwise: a row range, query ranges and a
   single query of VAR-d16's last scale alone against the full call; K1's
   batch invariance, bitwise: rows
   of an M = 1024 call against the same rows alone; K3's batch and lane
   invariance, bitwise: rows and lanes of a 4-lane call against the same
   rows and lanes alone, at T = 1024 and 32; K2's the same. K1's first
   check is preceded by a probe repeated ``K1_PROBE_REPS`` times (its
   output filled with NaN before the launch, the plain version's inputs
   fenced by canaries): no element unwritten, nothing disturbed;
3. check the port end to end on small inputs against the same work on the
   CPU (the CPU path is the one the tests hold against the JAX package): the
   tiny rung served in f32 with an int8 base; one tiny-rung ES step in f32
   with an int8 base (K3 at the adapted sites) and one with a float base
   (K2 there), both with ``pop_fuse``: θ′ and
   reward rows, and the card's launches exactly as derived; one tiny fleet
   tick (``FLEET_W`` jobs with their own σ, lr_scale and seed through one
   ``make_fleet_step`` graph, int8 base) against the CPU, each job bitwise
   the port's solo step on the card (:func:`phase_fleet_reference`);
4. K2's path: the flagship ES epoch step (as in 7) over a bf16 base, its
   DiT at ``FLAGSHIP_CUT_LAYERS`` of its 20 blocks (the rung runner's
   flagship epoch, 15, keeps the full depth), whose 8 · blocks + 4 adapted
   DiT sites per image run K2, as a CUDA graph and eagerly in turns
   (:func:`timed_epochs`), K2 counted as in 7;
5. the serving path: the flagship serving backend (Sana-Sprint 1.6B at full
   width, DC-AE to 1024×1024, bf16, int8 base, random weights from a seed)
   behind two ``ServeEngine``s, a CUDA graph per geometry and eager, four
   requests each in turns; K1's counted launches must be the expected
   number for each eager flush and none for a replayed one, and on the
   device, in a profiled flush of each engine, the expected number;
   images must be finite in [0, 1], differ between tenants, equal between
   graph and eager bitwise, and batched must equal solo (padded) bitwise; a
   new tenant must leave ``serve_compiles`` flat; one flush of a third
   engine under its own profile window (``ServeConfig(profile_dir,
   profile_batches=1)``) must hold K1's expected number in its exported
   trace (:func:`serve_profile_window`);
6. the VAR path (K4): the tiny VAR geometry in f32 on the card against the
   CPU (one ``generate`` with injected Gumbel noise: token ids equal, images
   within 1e-4; one ES step: θ′ and reward rows within 1e-4, K4 launches as
   derived), then ES epochs of ``RUNG_PLAN["ar_d16"]`` (VAR-d16 at its
   published widths, its transformer at ``VAR_ES_LAYERS`` of 16 blocks
   (the rung runner's ``ar_d16``, 15, runs all 16), bf16, float base, pop
   16, 4 classes, member_batch 4; CLIP-B/32 and CLIP-H/14 rewards) as a
   CUDA graph and eagerly in turns: K4 counted exactly 4 × 10 ×
   ``VAR_ES_LAYERS`` times in each eager epoch and on the device
   in a profiled epoch of each, every scale's token
   ids equal between them, reward rows ``[16, 4]`` finite, θ′ finite,
   ‖Δθ‖ > 0;
   the Infinity path (K4 at dh 128 and under a key mask): the tiny
   Infinity geometry in f32 on the card against the CPU with the released
   attention flags off and on (``generate``: bits equal, images within
   1e-4; one ES step: θ′ and rows within 1e-4; K4 launches exact), and
   with ``pop_fuse`` on an int8 and a float base (:func:`phase_inf_q8_reference`:
   θ′ and rows within 1e-4, bits equal under the measured margin, K3, K1,
   K4 and K2, K4 exact), then Infinity-2B (``inf_2b``: 14 scales to
   1024×1024, 32-bit tokenizer, bf16, random weights) built by the rung's
   ``build_train_backend("2b", depth=INF_FLOAT_DEPTH)`` (a float base at
   every width and 4 of its 32 blocks) with CLIP-B/32 and CLIP-H/14
   rewards (build time and peak memory; θ₀'s norm against
   ``theta_max_norm``), ``run_training`` as a CUDA graph (the warm-up and
   capture): K4 exactly 28 launches a block per generate call and no
   K1-K3, counted at the warm-up and on the device in a profiled replayed
   epoch, which must equal the same epoch run eagerly, bitwise, epoch s,
   images/s, idle share, memory (weights, KV workspace, pool), one eager
   generate call with ``pop_fuse`` (K2 85 a block); then Infinity-2B on
   the int8 base with ``pop_fuse`` at ``INF_Q8_DEPTH`` of its 32 blocks
   (:func:`phase_inf_q8_es`: ``run_training`` as a graph, K3 85 a block, K4
   28 a block and K1 as derived per generate call on the device, one epoch
   against eager in turns, bitwise or within 1e-4); then the same program at
   the full depth from released-layout files (:func:`phase_weights_infinity`,
   item 12 below);
7. the Sana main path: one EGGROLL-ES epoch step of the flagship rung
   (``RUNG_PLAN``/``RUNG_OPT["flagship"]``: pop 4, 4 prompts, member_batch
   1, reward_tile 1, bf16 noise store, int8 DiT + DC-AE + CLIP-B/32 +
   CLIP-H/14 at their published widths, bf16 towers), as a CUDA graph
   (the main path) and eagerly, in turns (:func:`timed_epochs`: each
   variant's first call warms up, the graph's captures; two timed epochs
   each from the same θ and key; one profiled epoch each). Launch counters
   are set to 0 just before each variant's epoch and read just after; K3
   and K1 must have launched exactly the counts derived from the module
   trees in each eager epoch, none in a replay, and exactly those counts on
   the device in the profiled epoch of each. The graph's θ′, Δθ, metrics
   and reward rows must equal the
   eager step's bitwise (or within 1e-4, recorded). Reward rows must be
   ``[4, 4]`` and finite, θ′ finite, ‖Δθ‖ > 0;
8. the trainer around the step: a tiny ``run_training`` (f32, int8 base)
   on the card against the same run on the CPU (θ₀ and the draws made on
   the CPU; θ and ``per_prompt_mean`` within 1e-4 after 2 epochs,
   ``regenerate_member_images`` within 1e-4, the plan's counted FLOPs and
   bytes in ``programs.jsonl`` equal on the card and the CPU), then,
   on the backend of 7, the flagship ``run_training`` with ``quality`` on
   and a slot every 2 epochs: 4 epochs, a resume that must run exactly
   epoch 4 from the epoch-4 slot's θ bitwise (the slot's sha256s
   recomputed from its file), and one epoch with ``quality`` off. Each
   run's counted K1-K4 launches must be the derived counts × its eager
   epochs (each program's warm-up; the other epochs replay its graph);
   ``metrics.jsonl`` must hold 5 rows with per-prompt quality. Prints
   each epoch's ``step_time_s`` beside 7's epochs and each save's time.
   Then one run with the live telemetry on (:func:`telemetry_run`: the
   exporter scraped from a thread during the run, SLOs, heartbeats, the
   stall and anomaly watchdogs), its epochs beside the bare step's.
   Then chained dispatch at ``FLAGSHIP_CUT_LAYERS`` of the 20 blocks:
   ``CHAINED_EPOCHS`` epochs with ``steps_per_dispatch`` 1 and
   ``CHAINED_EPOCHS - 1`` (epochs_chained [1, 2]), θ bitwise equal, both
   runs' ``step_time_s``;
   then the trainer's artifacts and profile window at the flagship
   (:func:`phase_train_artifacts`: ``ART_EPOCHS`` epochs with θ/Δθ
   histograms every epoch, member strips and snapshot grids every 2, a
   ``torch.profiler`` window of ``ART_PROFILE_EPOCHS`` epochs; the rows'
   ``hist/*``, ``mfu`` and ``roofline/*``, the strips' pixels against a
   regeneration, ``programs.jsonl``, ``CALIB_train.json`` with K1 and K3
   in the trace at the derived counts, ``QUALITY_train.json`` and the PEFT
   export read back);
   then fleet training at the flagship (:func:`phase_fleet_flagship`: a
   ``FleetScheduler`` of width 2 over three jobs, a join, a swap to another
   σ and the leaves on one captured program, K3 and K1 on the device in a
   replayed tick exactly 2 × 16 × (164, 329), the swapped job bitwise its
   solo steps, K3 at two of the fleet's launches against its plain
   version); then the run tools over those run dirs
   (:func:`phase_run_tools`: ``trace_report`` with coverage ≥ 0.90 and the
   Chrome export, ``run_report`` with the roofline, predicted-vs-measured
   and Fleet panels, ``sentry`` exiting 0 on a same-plan run and 2 on a
   copy with ``step_time_s`` ×3, the verdict on a resumed run's
   ``/healthz``, and ``tools.preflight`` in child processes: the flagship
   a no-fit at ``RUN_TOOLS_HBM_GB``, its measured peak within 15% of 7's
   memory, its warm-up K1 329 and K3 164 an image, ``--serve`` and
   ``--fleet`` exiting 0). ``tools/dispatch_tax.py`` runs alone
   (:func:`phase_dispatch_tax`), outside the default run;
9. the JAX noise stream (``utils.threefry``, plain torch) at each path's
   full-width draws (the flagship ES noise and latents, VAR-d16's Gumbel
   slab, Infinity-2B's Gumbel noise and one whole stacked leaf): every
   primitive draw re-drawn on the CPU over its ends, bits and uniforms
   bitwise equal, normals and Gumbels within 1e-5; each draw's time, device
   time, kernel count and share of its path's epoch (or call, or build);
10. the Sana pipeline mode (``PIPELINE_STEPS`` DiT passes an image): the
    tiny rung in f32 with an int8 base on the card against the CPU
    (:func:`phase_pipeline_reference`: one ``generate`` and one ES step
    within 1e-4, launches as derived, the pipeline's draws bitwise); the
    flagship ES rung in pipeline mode at ``FLAGSHIP_CUT_LAYERS`` of its 20
    blocks under ``run_training`` as a graph (:func:`phase_pipeline_es`: 3
    epochs, K3 2 × (8 a block + 4) an image counted and on the device, epoch
    s beside 7's one-step epoch);
11. the serving tier (:func:`phase_serve_tier`, on 5's backend): an engine
    of ``TIER_LANES`` lanes with the overload layer, SLOs and the
    ``/metrics`` exporter; the admission estimate beside the measured
    bytes, and a refusal that runs nothing; a ``tools.loadgen`` sweep at
    ``TIER_RATES`` × 5's images/s and its knee; ``/metrics`` scraped over
    HTTP; ``run_degrade`` OFF against ON at 1.5 × (``not_resident`` 0 ON);
    batched equal to solo bitwise; a pipeline-mode engine's flush, K1 on the
    device as derived.

12. released checkpoints (:func:`phase_weights_var`, after 6's VAR-d16
    epoch; :func:`phase_weights_sana`, after Infinity): a ``var_d16.pth``
    + ``vae_ch160v4096z32.pth`` pair (f32) and a diffusers-layout
    safetensors file at Sana-Sprint 1.6B's widths and ``WEIGHTS_SANA_LAYERS``
    of its 20 blocks (bf16, the port's own writer), with
    the released key names and shapes (:func:`released_var_keys`,
    :func:`released_vqvae_keys`, :func:`released_sana_keys`) and seeded
    numpy values, written into a temporary directory deleted afterwards,
    then the train CLI's ``main --weights [--vae_weights]`` at the
    ``ar_d16`` and ``flagship`` plans (the Sana run on the int8 base with
    ``pop_fuse``): the inferred config the rung's, a warm-up and a replayed
    epoch, K4 160 a VAR call and K3 8 a block + 4 a Sana image with K1 as derived,
    counted and on the device, the graph against an eager epoch bitwise,
    each stage's seconds (write, read, convert, to the card, build,
    capture, epoch), the host's peak resident set and the device's peak;
    then ``weights.validate --family sana`` on the same file. Infinity-2B
    at its full width and depth (:func:`phase_weights_infinity`, after
    ``phase_inf_q8_es``): a bf16 transformer ``.pth`` (≈ 2.0 B values) and
    a BSQ tokenizer ``.pth`` (:func:`released_infinity_keys`,
    :func:`released_bsq_keys`, :func:`write_released_pth`) through ``main
    --backend infinity --infinity_variant 2b --pn 1M --weights --vae_weights
    --base_quant int8 --pop_fuse true``: the inferred ``InfinityConfig``
    the ``inf_2b`` rung's, K3 2,720, K4 896 and K1 as derived a call at the
    warm-up and on the device in a replayed epoch, each stage's seconds,
    the host's peak beside ``MemTotal``, the device's build peak and the
    memory split.

13. the evaluation harness and the user tools (:func:`phase_evaluate`, on
    7's backend and reward suite, after the run tools): ``run_benchmark``'s
    ``generate_folder`` over ``data/parti_prompts_sample.tsv`` at the
    flagship, base and LoRA (a slot saved and read back), one CUDA graph
    for both folders, a replayed batch bitwise the eager one, K1 counted
    and on the device as derived; ``score_folder`` over both folders with
    the suite's towers, the PNG files scoring bitwise the in-memory uint8
    arrays; the blind A/B demo (``EVAL_TRIALS`` pairs, one dispatch each,
    the pair's base image bitwise the solo one) and its vote report; at
    tiny, the card against the CPU (generation, scores, ``encode_hf``
    within ``EVAL_TOL``), a two-config sweep, and the benchmark's command
    line in a child process.

14. multi-process training (:func:`phase_multiproc_es`, last): the train
    CLI at ``--model_scale full`` on the int8 base with the flagship rung's
    knobs and plan, the population host-sharded, first as one process (in
    this process), then as two processes on the one card through
    ``tools.launch_local`` (each its own CUDA context, ``--pop_shard_update
    on``: each evaluates 2 of the 4 members, the reward rows cross through
    the launch's TCPStore, the update's partial sums through one gloo
    all-reduce), then one process from the launch's θ′ after its first
    epoch (the witness), one run at a time on the card: each child's K3
    and K1 counted exactly as its slice derives, both ranks' θ′ bitwise
    equal after every epoch, the first epoch's gathered reward rows bitwise
    the one-process run's and its update's θ′ within ``MULTIPROC_TOL`` of
    it, the later epochs' rows bitwise the witness's and their replayed
    split update's θ′ within ``MULTIPROC_TOL`` of its replicated one, each
    run's replayed epoch printed with the card's name and power limit.

15. the rung runner as a user runs it (:func:`phase_bench`, after the
    others; its scaling run and its one-item window start with the script,
    :func:`start_bench_early`, and run on the card while the kernels build,
    since the tiny rung launches none): ``python -m
    hyperscalees_t2i_tpu_torch.tools.bench`` at ``BENCH_RUNGS`` =
    ``BENCH_LADDER`` (parent and child, ``BENCH_STEPS`` = 2), ``--serve --rung
    flagship --batches 2`` (its command line in this process),
    ``--scaling --rungs tiny --devices 1,2``, the records rendered by
    ``tools.bench_report`` and a ``tools.window`` of one item
    (``--items bench_ladder --rungs tiny``). Each rung's record carries the
    card's name and power limit, an MFU at most 1 and a step above its
    physical floor, and the K1-K4 launches of its warm-up epoch as its plan
    derives them (the flagship's those of ``phase_es_flagship``'s epoch,
    ``flaggen``'s its K3 and the DiT's K1 at the flagship's tiling,
    ``ar_d16``'s K4 those of ``phase_var_es``'s); ``ar_d16``'s K4 parity
    within 2⁻⁷ of a call's largest output (:func:`check_close`'s bf16
    bound); the served
    images bitwise across the three serving paths; the scaling digests
    equal at 1 and 2 processes. The runner's flagship and ``ar_d16`` epochs
    are printed beside this script's own. Then ``--fleet --rung flagship
    --widths 1,2`` (:func:`bench_fleet`: rows bitwise solo at each width,
    each width's tick) and ``--profile`` on ``flagship`` in a ladder child of
    its own (:func:`bench_profile`: the ``bench/flagship`` ranges joined to
    the rung's ledger record by ``obs/calib.py``, their device time by
    kernel family).

The span tree (the port has the JAX package's process-global tracer): the
traced flagship ``run_training`` of 7 writes the JAX parents
(``TRAIN_SPANS``: ``trace/pop_eval`` in ``compile``, twice, and
``obs/pop_eval_traces`` 2, the warm-up and the capture), and 5's serving
writes ``SERVE_SPANS`` (``serve/compile`` ⊃ ``trace/serve_batch``,
``serve/batch`` ⊃ ``serve/dispatch``) with ``obs/serve_traces`` flat over
hot swaps between replays.

Every random number of the port is the JAX package's (the same keys, the
same key tree); the phases draw from ``utils.threefry`` keys.

Output: the per-shape kernel tables and the path numbers on stdout, a JSON
copy in ``build/chip_smoke.json``, then the card's name and power limit, a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
try:  # the trace readers and the PNG reader live in the package; outside a checkout main() says so and exits
    from hyperscalees_t2i_tpu_torch.obs.profile_trace import device_kernels, live_events, profiled_launches
    from hyperscalees_t2i_tpu_torch.utils.images import read_png
except ImportError:
    device_kernels = live_events = profiled_launches = read_png = None

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12

# K1 call shapes per image: (site, tokens T, din, dout, activation dtype on
# the main path, calls per served image, calls per ES image). On the ES path
# the 164 LoRA-adapted DiT sites run K3 instead, and the reward towers'
# image sides run K1.
K1_SHAPES = [
    ("time/guidance linear_1", 1, 256, 2240, "float32", 2, 2),
    ("time/guidance linear_2", 1, 2240, 2240, "float32", 2, 2),
    ("time_embed/linear", 1, 2240, 13440, "float32", 1, 0),
    ("caption_proj/linear_1", 32, 2304, 2240, "bfloat16", 1, 0),
    ("caption_proj/linear_2 + attn2 k,v", 32, 2240, 2240, "bfloat16", 1 + 40, 0),
    ("attn1 q,k,v,out + attn2 q,out", 1024, 2240, 2240, "bfloat16", 120, 0),
    ("ff conv_inverted", 1024, 2240, 11200, "bfloat16", 20, 20),
    ("ff conv_point", 1024, 5600, 2240, "bfloat16", 20, 20),
    ("patch_embed", 1024, 32, 2240, "bfloat16", 1, 1),
    ("proj_out", 1024, 2240, 32, "bfloat16", 1, 0),
    ("dcae s0 qkv", 1024, 1024, 3072, "bfloat16", 2, 2),
    ("dcae s0 proj", 1024, 1024, 1024, "bfloat16", 2, 2),
    ("dcae s0 conv_inverted", 1024, 1024, 4096, "bfloat16", 2, 2),
    ("dcae s0 conv_point", 1024, 2048, 1024, "bfloat16", 2, 2),
    ("dcae s1 qkv", 4096, 1024, 3072, "bfloat16", 2, 2),
    ("dcae s1 proj", 4096, 1024, 1024, "bfloat16", 2, 2),
    ("dcae s1 conv_inverted", 4096, 1024, 4096, "bfloat16", 2, 2),
    ("dcae s1 conv_point", 4096, 2048, 1024, "bfloat16", 2, 2),
    ("clip-b patch_embed", 49, 3072, 768, "bfloat16", 0, 1),
    ("clip-b q,k,v,out", 50, 768, 768, "bfloat16", 0, 48),
    ("clip-b fc1", 50, 768, 3072, "bfloat16", 0, 12),
    ("clip-b fc2", 50, 3072, 768, "bfloat16", 0, 12),
    ("clip-b visual_projection", 1, 768, 512, "bfloat16", 0, 1),
    ("clip-h patch_embed", 256, 588, 1280, "bfloat16", 0, 1),
    ("clip-h q,k,v,out", 257, 1280, 1280, "bfloat16", 0, 128),
    ("clip-h fc1", 257, 1280, 5120, "bfloat16", 0, 32),
    ("clip-h fc2", 257, 5120, 1280, "bfloat16", 0, 32),
    ("clip-h visual_projection", 1, 1280, 1024, "bfloat16", 0, 1),
]
# The flagship's LoRA-adapted DiT sites (r_l 8, r_e 4), per ES image: K3
# over the int8 base (the main path), K2 over a bf16 base (K2's path).
CHAIN_SHAPES = [
    ("time_embed/linear", 1, 2240, 13440, "float32", 1),
    ("caption_proj/linear_1", 32, 2304, 2240, "bfloat16", 1),
    ("caption_proj/linear_2 + attn2 k,v", 32, 2240, 2240, "bfloat16", 1 + 40),
    ("attn1 q,k,v,out + attn2 q,out", 1024, 2240, 2240, "bfloat16", 120),
    ("proj_out", 1024, 2240, 32, "bfloat16", 1),
]
R_L, R_E, LORA_SCALE = 8, 4, 2.0
# K3's ms per call at each main-path shape before its tensor-core redesign:
# the f32-FMA kernel of commit 447f2c6, as its PERF.md records it (NVIDIA
# H100 80GB HBM3, 700 W). A record, printed beside this run's times.
K3_BEFORE_MS = {
    "time_embed/linear": 0.4348,
    "caption_proj/linear_1": 0.4708,
    "caption_proj/linear_2 + attn2 k,v": 0.4666,
    "attn1 q,k,v,out + attn2 q,out": 1.1441,
    "proj_out": 0.3777,
}
# K2's ms per call at each main-path shape before its redesign for Hopper:
# PR 2's kernel as PR 6's run 15 measured it (NVIDIA H100 80GB HBM3, 700 W;
# noise bf16). A record, printed beside this run's times.
K2_BEFORE_MS = {
    "time_embed/linear": 0.6813,
    "caption_proj/linear_1": 0.3598,
    "caption_proj/linear_2 + attn2 k,v": 0.3438,
    "attn1 q,k,v,out + attn2 q,out": 0.4378,
    "proj_out": 0.2381,
}
# K4 on the VAR-d16 path: per scale, (queries pn², kv_len) against a 680-position
# cache of 32 rows (4 lanes × 4 images × cond/uncond), 16 heads of 64; each
# shape runs once per layer (16) per generate call
VAR_PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
VAR_ROWS, VAR_HEADS, VAR_DH, VAR_DEPTH = 32, 16, 64, 16
# the blocks, of VAR-d16's 16, of phase_var_es (K4's count is scales × blocks a
# call); the rung runner's ar_d16 (phase_bench) keeps the full depth
VAR_ES_LAYERS = 4
# K4's bf16 ms per call at each VAR-d16 scale before its redesign for Hopper:
# the f32-FMA kernel of commit 44078f4, as this script's phase_k4_check
# measured it on an NVIDIA H100 80GB HBM3 at 700 W. A record, printed beside
# this run's times.
K4_BEFORE_MS = (0.0408, 0.0289, 0.0529, 0.0418, 0.0580, 0.0903, 0.1387, 0.3196, 0.7547, 1.5761)
# K4 on the Infinity-2B path (the inf_2b rung, pn 1M): per scale, the
# self-attention of pn² queries against the cache prefix of a 9451-position
# cache and the masked cross-attention into 17 text positions (the null
# token and 16), 16 heads of 128, each once per layer (32) per generate call
# of 8 rows (1 lane × 4 images × cond/uncond)
INF_PATCH_NUMS = (1, 2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 36, 48, 64)
INF_ROWS, INF_HEADS, INF_DH, INF_DEPTH, INF_TEXT = 8, 16, 128, 32, 17
# run_training epochs of phase_inf_q8_es and phase_inf_es (a float base), the
# warm-up and capture alone, so that the whole script keeps its margin to its
# time limit with the Z-Image phases in it; their replayed epoch is
# _graph_run's profiled one
INF_EPOCHS = 1
INF_FLOAT_EPOCHS = 1
# phase_inf_es's blocks: the float-base run at every width and an eighth of
# the depth (K2 6 × 14 × 4 + 4 = 340 and K4 112 a call; the main path's full
# depth runs from the released-layout files in phase_weights_infinity; K4 at
# every Infinity shape is phase_k4_infinity's)
INF_FLOAT_DEPTH = 4
# phase_inf_q8_es's blocks: the int8 run against eager at a quarter of the
# depth (K3 6 × 14 × 8 + 8 = 680 and K4 224 a call); the 32-block int8
# epoch, K3 and K4 in situ and the threefry share are phase_weights_infinity's
INF_Q8_DEPTH = 8
# phase_weights_sana's transformer blocks in the released-layout file (d 2240
# and every key name kept; the reader and converter are the same at any depth)
WEIGHTS_SANA_LAYERS = 4
# Infinity-2B's adapted block sites (K3 over the int8 base, K2 over a bf16
# one, with pop_fuse): (site, K, N, sites a layer), each run once a layer
# (32) a scale on 8 · pn² rows (1 lane × 4 images × cond/uncond); cross_kv
# once a layer a call, on the 8 × 17 text rows (16 hash-fallback positions
# and the null token). Factors r_l 8, r_e 4, the noise f32 (inf_2b's knobs).
INF_CHAIN_SITES = [("qkv", 2048, 6144, 1), ("attn_proj + cross_q + cross_proj", 2048, 2048, 3),
                   ("fc1", 2048, 8192, 1), ("fc2", 8192, 2048, 1)]
INF_CROSS_KV = ("cross_kv", 2048, 4096)
INF_IMAGES = INF_ROWS // 2  # images a generate call (CFG doubles the rows)


def inf_k1_shapes():
    """K1's calls of one Infinity-2B generate → decode → reward call on the
    int8 base: ``(site, rows, K, N, dtype on the main path, calls)``. The
    text and pool projections and ``word_embed`` take f32 activations, as
    in the JAX package; ``head`` bf16 once a scale; ``word_embed`` once a
    scale but the last, on the next scale's 4 · pn² tokens; the BSQ
    decoder's one int8 1×1 conv (stage 1's skip, 512 → 256 at 128 × 128;
    its 3×3 convs dequantize for cuDNN, stage 3's skip is below the floor);
    the towers' image sides in the rung's f32 over the call's 4 images
    (their per-image shapes in ``K1_SHAPES``)."""
    pns, imgs = INF_PATCH_NUMS, INF_IMAGES
    out = [("text_proj", imgs * 16, 2048, 2048, "float32", 1), ("pool_proj", INF_ROWS, 2048, 2048, "float32", 1)]
    out += [(f"head scale {si}", INF_ROWS * pn * pn, 2048, 64, "bfloat16", 1) for si, pn in enumerate(pns)]
    out += [(f"word_embed scale {si + 1}", imgs * pn * pn, 32, 2048, "float32", 1) for si, pn in enumerate(pns[1:])]
    out += [("bsq decoder stage 1 skip", imgs * 128 * 128, 512, 256, "bfloat16", 1)]
    out += [(site, imgs * T, din, dout, "float32", es) for site, T, din, dout, _, _, es in K1_SHAPES
            if site.startswith("clip")]
    return out
N_REQUESTS = 4
TIMED_EPOCHS = 2
# phase_train_artifacts: run_training epochs, the profile window's first epochs among them
ART_EPOCHS = 4
CHAINED_EPOCHS = 3  # phase_train_chained: 1, then CHAINED_EPOCHS - 1, epochs a dispatch
# the DiT blocks, of Sana-Sprint 1.6B's 20, of phase_pipeline_es and
# phase_train_chained (cut_flagship_backend): their K3/K1 count rules depend
# on depth only through the block count, and the chain's bitwise check not at all
FLAGSHIP_CUT_LAYERS = 4
ART_PROFILE_EPOCHS = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def child_prelude() -> str:
    """The first statements of every Python child the script starts
    (``python -c``): the checkout on the path, the port's
    ``tools.launch_local.die_with_parent`` with this process as the parent
    (the child dies with the script), then ``import chip_smoke``."""
    return (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from hyperscalees_t2i_tpu_torch.tools.launch_local import die_with_parent; "
            f"die_with_parent({os.getpid()}); import chip_smoke; ")


def _untimed(torch, fns) -> float:
    """``reps`` = 0 in a timer: each of ``fns`` called once, nothing timed
    (NaN), for runs that only check (:func:`kernel_checks_once`)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    return math.nan


def time_ms(torch, fns, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls that
    rotate over ``fns`` (distinct input copies, so weights larger than a
    fraction of L2 are read from device memory as on the main path)."""
    if reps == 0:
        return _untimed(torch, fns)
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


def device_ms(torch, fns, reps: int, marker=None) -> float:
    """Mean device time of one call under ``torch.profiler``, over ``reps``
    calls rotating over ``fns``: with ``marker``, the mean duration of the
    kernels whose name holds it (one a call; the profiler may drop an event,
    so at least half must be seen); without, every kernel's duration summed
    and divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    if reps == 0:
        return _untimed(torch, fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(3):  # the trace may open late and miss a whole window of short calls: try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)
            for i in range(reps):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        total, n = 0.0, 0
        for name, ms in live_events(torch, prof):
            if marker is None or marker in name:
                total += ms
                n += 1
        if marker is None and n:
            return total / reps
        if marker is not None and reps // 2 <= n <= reps:
            return total / n
    raise AssertionError(f"the profiler saw {n} kernels named *{marker or ''}* for {reps} calls")


def host_us(torch, fns, reps: int) -> float:
    """Host time of one call, µs: the host clock around ``reps`` calls
    (rotating over ``fns``) that are only enqueued, after a synchronize."""
    if reps == 0:
        return _untimed(torch, fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound(dt_name: str, flop: float, nbytes: float):
    t_ops = flop / PEAK_FLOPS[dt_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(name, out, ref, dt_name, torch, again=None):
    """bf16 within 2⁻⁷ of the largest output, f32 within 1e-5 of it.

    On a failure the message names the worst element, its kernel and plain
    values and, where ``again`` (a callable giving a second ``(out, ref)``
    from the same inputs) is given, both values computed once more, so a
    fault in the kernel and one in the plain version tell themselves apart.
    The check fails all the same."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    ref_max = float(ref.abs().max())
    tol = (2 ** -7 if dt_name == "bfloat16" else 1e-5) * ref_max
    if not (err <= tol and bool(torch.isfinite(out).all())):
        i = int(torch.nan_to_num(diff, nan=float("inf")).flatten().argmax())
        where = f"element {i}: kernel {float(out.flatten()[i])}, plain {float(ref.flatten()[i])}"
        if again is not None:
            out2, ref2 = again()
            torch.cuda.synchronize()
            where += (f"; computed again: kernel {float(out2.flatten()[i])}, plain {float(ref2.flatten()[i])}"
                      f" (kernel again max abs diff {float((out2.float() - out.float()).abs().max())},"
                      f" plain again {float((ref2.float() - ref).abs().max())})")
        raise AssertionError(f"{name}: max abs err {err} > {tol} (or not finite); largest |plain| {ref_max}; {where}")
    return err, tol, ref_max


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            return out.stdout.splitlines()
    except OSError:
        pass
    return list(names)


def kernel_routes(text: str):
    """Per kernel (template instance), ``-Xptxas -v``'s registers,
    barriers, stack and spill line from the compiler output."""
    routes, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            routes[name] = []
        elif name and ("registers" in line or "spill" in line):
            routes[name].append(line.split(":", 1)[-1].strip() if "registers" in line else line.strip())
    return dict(zip(_demangle(list(routes)), (" | ".join(v) for v in routes.values())))


def start_sass_dumps(sources):
    """Start one ``cuobjdump -sass`` a library of each ``csrc/<source>.cu``,
    by the toolkit that built it, all together, each into its own file;
    :func:`sass_hmma` waits for them."""
    import tempfile

    from hyperscalees_t2i_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    tmp = Path(tempfile.mkdtemp(dir=_build.library_path(sources[0]).parent))
    # each dump to a file, so that no process waits on a full pipe
    files = {source: open(tmp / source, "w+") for source in sources}
    procs = {source: subprocess.Popen([str(tool), "-sass", str(_build.library_path(source))], stdout=files[source],
                                      stderr=subprocess.STDOUT, text=True) for source in sources}
    return {"tmp": tmp, "files": files, "procs": procs, "t0": time.perf_counter()}


def stop_sass_dumps(dumps):
    """End :func:`start_sass_dumps`' processes now and remove their files."""
    import shutil

    for source, proc in dumps["procs"].items():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        dumps["files"][source].close()
    shutil.rmtree(dumps["tmp"], ignore_errors=True)


def sass_hmma(dumps):
    """Tensor-core instructions (``HMMA``) per kernel in the SASS of
    :func:`start_sass_dumps`' dumps, once they end: ``{source: {kernel:
    count}}``."""
    procs, files, t0 = dumps["procs"], dumps["files"], dumps["t0"]
    texts, t_wait = {}, time.perf_counter()
    try:
        while any(proc.poll() is None for proc in procs.values()):
            if time.perf_counter() - t0 > 300:
                raise subprocess.TimeoutExpired("cuobjdump", 300)
            time.sleep(0.05)
        waited = time.perf_counter() - t_wait
        for source, proc in procs.items():
            files[source].seek(0)
            texts[source] = files[source].read()
            if proc.returncode:
                raise subprocess.CalledProcessError(proc.returncode, proc.args, texts[source])
    finally:
        stop_sass_dumps(dumps)
    t1, out = time.perf_counter(), {}
    for source, sass in texts.items():
        counts, name = {}, None
        for m in re.finditer(r"Function : (\S+)|HMMA", sass):
            if m.group(1):
                name = m.group(1)
                counts[name] = 0
            elif name:
                counts[name] += 1
        out[source] = dict(zip(_demangle(list(counts)), counts.values()))
    log(f"[build] SASS dumps {', '.join(f'{k} {len(v) / 2**20:.0f} MiB' for k, v in texts.items())}: waited "
        f"{waited:.1f} s for them, {t_wait - t0:.1f} s after they started; counted in {time.perf_counter() - t1:.1f} s")
    return out


# each source's bf16 tensor-core kernel, whose SASS must hold HMMA
ROUTED_KERNELS = {"int8_matmul": "int8_mma_kernel", "lora_chain": "lora_chain_mma_kernel",
                  "fused_qlora": "qlora_mma_kernel", "decode_attention": "decode_attention_mma_kernel"}
KERNEL_TAGS = {"int8_matmul": "k1", "lora_chain": "k2", "fused_qlora": "k3", "decode_attention": "k4"}


def phase_build(defer_sass: bool = False):
    """Build the four kernels' libraries (one ``nvcc`` a source, all
    started together), log each kernel's registers and spills and each
    route's dynamic shared memory, and check that every bf16 route's SASS
    holds tensor-core instructions (:func:`phase_build_sass`). With
    ``defer_sass`` the SASS dumps only start here, and the caller runs
    :func:`phase_build_sass` on the result later (``main`` does so after
    the kernel checks, which the dumps run beside)."""
    from hyperscalees_t2i_tpu_torch.ops import _build
    from hyperscalees_t2i_tpu_torch.ops import fused_lora as fl
    from hyperscalees_t2i_tpu_torch.ops import quant_mm as qm

    t0 = time.perf_counter()
    nvcc_s = {}
    logs = _build.build_all(list(ROUTED_KERNELS), seconds=nvcc_s)
    dt = time.perf_counter() - t0
    for name, sec in sorted(nvcc_s.items(), key=lambda kv: -kv[1]):
        log(f"[build] {name}: nvcc {sec:.1f} s")
    tiles = (("128x128", qm.MMA_128x128), ("64x64", qm.MMA_64x64), ("16x64", qm.MMA_16x64))
    out = dict(build_s=dt, nvcc_s=nvcc_s)
    dumps = start_sass_dumps(list(ROUTED_KERNELS))
    try:
        for name in ROUTED_KERNELS:
            tag = KERNEL_TAGS[name]
            if logs[name] == "(cached)":
                log(f"[build] {name}: (cached)")
            routes = kernel_routes(logs[name])
            for fn, line in routes.items():
                log(f"[build] {name} {fn}: {line}")
            if name == "int8_matmul":
                tile_smem = _build.entry(name, "hses_int8_matmul_smem", [ctypes.c_int])
                smem = {t: tile_smem(tid) for t, tid in tiles}
            elif name == "lora_chain":
                route_smem = _build.entry(name, "hses_lora_chain_smem", [ctypes.c_int, ctypes.c_int])
                smem = {"bf16 32 rows": route_smem(fl.MMA_ROWS32, 0),
                        "bf16 32 rows wide": route_smem(fl.MMA_ROWS32, 1),
                        "f32 8 rows (most)": route_smem(fl.F32_ROWS8, 0)}
            elif name == "decode_attention":
                route_smem = _build.entry(name, "hses_decode_attention_smem", [ctypes.c_int] * 4)
                smem = {f"bf16 {rows} rows dh {dh} {st} stages": route_smem(1, rows, dh, st)
                        for dh, st in ((64, 2), (64, 3), (128, 2), (128, 3)) for rows in (16, 32, 64, 128)}
                smem.update({f"f32 dh {dh}": route_smem(0, 64, dh, 1) for dh in (64, 128)})
            else:
                tile_smem = _build.entry(name, "hses_fused_qlora_smem", [ctypes.c_int, ctypes.c_int])
                smem = {f"{t}{' wide' if wide else ''}": tile_smem(tid, wide) for t, tid in tiles for wide in (0, 1)}
            log(f"[build] {name} dynamic shared memory per block: {smem} bytes")
            out.update({f"{tag}_ptxas": routes, f"{tag}_smem_bytes": smem})
    except BaseException:
        stop_sass_dumps(dumps)
        raise
    log(f"[build] four kernels built in {dt:.1f} s (one nvcc per source, in parallel)")
    out["sass_dumps"] = dumps
    return out if defer_sass else phase_build_sass(out)


def phase_build_sass(build):
    """Wait for :func:`phase_build`'s SASS dumps, log each kernel's HMMA
    count, and fail unless every bf16 route's kernels hold HMMA. Returns
    ``build`` with the counts (``k1_hmma`` …)."""
    sass = sass_hmma(build.pop("sass_dumps"))
    for name, mma_kernel in ROUTED_KERNELS.items():
        hmma = sass[name]
        for fn, n in hmma.items():
            log(f"[build] {name} SASS {fn}: {n} HMMA")
        mma = {fn: n for fn, n in hmma.items() if mma_kernel in fn}
        if not mma or min(mma.values()) == 0:
            raise AssertionError(f"{name}'s bf16 route has no tensor-core (HMMA) instruction in its SASS: {hmma}")
        log(f"[build] {name} SASS: {sum(mma.values())} HMMA over {len(mma)} bf16 kernels")
        build[f"{KERNEL_TAGS[name]}_hmma"] = hmma
    return build


def phase_k1_invariance(torch):
    """Bitwise batch invariance: the first M rows of one call at M = 1024
    equal a call on those M rows alone (M = 1, 2, 50, 257), and the last
    row alone, at a DiT shape, a CLIP-H shape and CLIP-H's K = 588 patch
    shape, in bf16 and f32. Raises on any difference."""
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul

    g = torch.Generator(device="cuda").manual_seed(99)
    checked = 0
    for din, dout in ((2240, 2240), (1280, 1280), (588, 1280)):
        q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.rand(1, dout, generator=g, device="cuda") * (2.0 / (127 * math.sqrt(din)))
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(1024, din, generator=g, device="cuda").to(dt)
            full = int8_matmul(x, q8, scale)
            for lo, hi in ((0, 1), (0, 2), (0, 50), (0, 257), (1023, 1024)):
                part = int8_matmul(x[lo:hi], q8, scale)
                if not torch.equal(part, full[lo:hi]):
                    diff = float((part.float() - full[lo:hi].float()).abs().max())
                    raise AssertionError(f"int8_matmul {din}x{dout} {dt}: rows {lo}:{hi} alone differ from "
                                         f"the same rows at M=1024 (max abs {diff})")
                checked += 1
    torch.cuda.synchronize()
    log(f"[k1] batch invariance: {checked} row ranges bitwise equal to the M=1024 call (bf16 and f32)")
    return checked


K1_PROBE_REPS = 20  # repeats of the probe of K1's first check


def k1_first_check_probe(torch, x, q8, scale, reps: int = K1_PROBE_REPS):
    """The probe of K1's unexplained first-check failure (ROADMAP queue C),
    ``reps`` times in this process on the script's first K1 inputs: the
    kernel launched (by the wrapper's plan, uncounted) into an output filled
    with NaN, so an element it leaves unwritten shows; the plain version on
    copies of its inputs laid inside canary-filled buffers, so a write
    beside or into them shows. Raises on an unwritten element, a disturbed
    canary or input, or a disagreement; returns the counts."""
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import _launch, _plan, int8_matmul_reference

    T, din = x.shape
    dout = q8.shape[1]
    pad = 4096

    def fenced(t, canary):
        buf = torch.full((t.numel() + 2 * pad,), canary, dtype=t.dtype, device=t.device)
        buf[pad:pad + t.numel()] = t.reshape(-1)
        return buf, buf[pad:pad + t.numel()].view(t.shape)

    unwritten = disturbed = mismatched = 0
    worst = 0.0
    plan = _plan(T, din, dout, x.dtype, x.data_ptr(), q8.data_ptr())
    for _ in range(reps):
        out = torch.full((T, dout), math.nan, dtype=x.dtype, device=x.device)
        _launch(x, q8, scale, out, T, plan)
        fences = [fenced(x, -7.0), fenced(q8, 77), fenced(scale, -3.0)]
        ref = int8_matmul_reference(*(view for _, view in fences))
        torch.cuda.synchronize()
        unwritten += int(torch.isnan(out).sum())
        for (buf, view), src, canary in zip(fences, (x, q8, scale), (-7.0, 77, -3.0)):
            edges = torch.cat([buf[:pad], buf[pad + src.numel():]])
            if not (bool((edges == canary).all()) and torch.equal(view, src)):
                disturbed += 1
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        if not err <= 2 ** -7 * float(ref.float().abs().max()):
            mismatched += 1
    log(f"[k1] first-check probe, {reps} repeats at {T}x{din}x{dout} {x.dtype}: unwritten elements {unwritten}, "
        f"disturbed plain inputs or canaries {disturbed}, disagreements {mismatched} (max abs {worst:.3g})")
    if unwritten or disturbed or mismatched:
        raise AssertionError(f"K1's first-check probe: {unwritten} unwritten, {disturbed} disturbed, "
                             f"{mismatched} disagreeing of {reps}")
    return {"reps": reps, "unwritten": unwritten, "disturbed": disturbed, "mismatched": mismatched,
            "max_abs_err": worst, "shape": [T, din, dout], "dtype": str(x.dtype)}


def phase_k1_check(torch, timed: bool = True):
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul, int8_matmul_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for site, T, din, dout, main_dt, serve_calls, es_calls in K1_SHAPES:
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
            if not rows:  # the script's first K1 check
                probe = k1_first_check_probe(torch, x, q8, scale)
            out = int8_matmul(x, q8, scale)
            torch.cuda.synchronize()
            err, tol, ref_max = check_close(
                f"int8_matmul at {site} {T}x{din}x{dout} {dt_name}", out, int8_matmul_reference(x, q8, scale),
                dt_name, torch, again=lambda: (int8_matmul(x, q8, scale), int8_matmul_reference(x, q8, scale)))
            reps = (20 if T * din * dout < 5e9 else 10) if timed else 0
            ms = time_ms(torch, [lambda s=s: int8_matmul(s[0], s[1], s[2]) for s in sets], reps)
            plain = time_ms(torch, [lambda s=s: int8_matmul_reference(s[0], s[1], s[2]) for s in sets], reps)
            lib = time_ms(torch, [lambda s=s: torch.matmul(s[0], s[3]) for s in sets], reps)
            flop = 2.0 * T * din * dout
            b_ms, b_by = bound(dt_name, flop, call_bytes)
            main = dt_name == main_dt
            rows.append(dict(
                site=site, T=T, din=din, dout=dout, dtype=dt_name, main_path=main,
                calls_per_image=serve_calls if main else 0, calls_per_es_image=es_calls if main else 0,
                max_abs_err=err, tol=tol, ref_max=ref_max, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, tflops=flop / ms / 1e9, **({"probe": probe} if not rows else {}),
            ))
            log(f"[k1] {site:34s} T={T:5d} {din:5d}x{dout:5d} {dt_name:8s} {'main' if main else '    '} "
                f"err={err:.3g} rel={err / ref_max:.3g} ms={ms:.4f} plain={plain:.4f} library={lib:.4f} "
                f"bound={b_ms:.4f} ({b_by}) {flop / ms / 1e9:.1f} TFLOP/s")
            del sets, x, q8, scale, out
    torch.cuda.empty_cache()
    return rows


def k1_tile_sweep(torch):
    """Every bf16 tile of K1 at each main-path bf16 shape: the numbers behind
    ``ops.quant_mm._plan``'s tile rule (PERF.md). Each tile is launched by
    the wrapper's own ``_launch`` with the plan's tile overridden (so these
    launches are not counted), and must give bitwise the planned tile's
    output. Not part of ``main``; run it after ``phase_build``."""
    from hyperscalees_t2i_tpu_torch.ops import quant_mm as qm

    g = torch.Generator(device="cuda").manual_seed(77)
    tiles = {"128x128": qm.MMA_128x128, "64x64": qm.MMA_64x64, "16x64": qm.MMA_16x64}
    rows = []
    for site, T, din, dout, main_dt, _, _ in K1_SHAPES:
        if main_dt != "bfloat16":
            continue
        call_bytes = 2 * T * din + din * dout + 4 * dout + 2 * T * dout
        sets = []
        for _ in range(max(1, min(8, math.ceil(100e6 / call_bytes)))):
            sets.append((torch.randn(T, din, generator=g, device="cuda").to(torch.bfloat16),
                         torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8),
                         torch.rand(1, dout, generator=g, device="cuda") * 0.01))
        ref = qm.int8_matmul(*sets[0])
        res = dict(site=site, T=T, din=din, dout=dout, plan=qm._plan(T, din, dout, torch.bfloat16).tile)
        for name, tile in tiles.items():
            outs = [torch.empty(T, dout, dtype=torch.bfloat16, device="cuda") for _ in sets]

            def call(i, tile=tile):
                x, q8, sc = sets[i]
                plan = qm._plan(T, din, dout, torch.bfloat16, x.data_ptr(), q8.data_ptr())._replace(tile=tile)
                qm._launch(x, q8, sc, outs[i], T, plan)
            call(0)
            torch.cuda.synchronize()
            if not torch.equal(outs[0], ref):
                raise AssertionError(f"K1 tile {name} differs bitwise from the planned tile at {site}")
            res[name] = time_ms(torch, [lambda i=i: call(i) for i in range(len(sets))], 20)
        rows.append(res)
        log(f"[k1-tiles] {site:34s} T={T:5d} {din:5d}x{dout:5d} plan={res['plan']} " +
            " ".join(f"{n}={res[n]:.4f}" for n in tiles))
        del sets
    return rows


def k3_tile_sweep(torch):
    """Every bf16 tile of K3 at each main-path bf16 K3 shape: the numbers
    behind ``ops.fused_qlora._plan``'s tile rule (PERF.md). Launched by the
    wrapper's own ``_launch`` with the plan's tile overridden (not counted);
    each tile must give bitwise the planned tile's output. Not part of
    ``main``; run it after ``phase_build``."""
    from hyperscalees_t2i_tpu_torch.ops import fused_qlora as fq
    from hyperscalees_t2i_tpu_torch.ops import quant_mm as qm
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import chain_launch_args

    g = torch.Generator(device="cuda").manual_seed(78)
    tiles = {"128x128": qm.MMA_128x128, "64x64": qm.MMA_64x64, "16x64": qm.MMA_16x64}
    bf = torch.bfloat16
    rows = []
    for site, T, din, dout, main_dt, _ in CHAIN_SHAPES:
        if main_dt != "bfloat16":
            continue
        call_bytes = 4 * T * din + din * dout + 4 * dout + 4 * T * dout
        sets = []
        for _ in range(max(1, min(8, math.ceil(100e6 / call_bytes)))):
            x = torch.randn(T, din, generator=g, device="cuda").to(bf)
            a, b = _factor(torch, g, din, R_L, bf), _factor(torch, g, R_L, dout, bf)
            q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
            sc = torch.rand(1, dout, generator=g, device="cuda") * 0.01
            args, ndt, keep = chain_launch_args(x, a, b, T)
            sets.append((x, q8, sc, args, ndt, keep, fq.fused_qlora_matmul(x, q8, sc, a, b, LORA_SCALE)))
        res = dict(site=site, T=T, din=din, dout=dout, plan=fq._plan(T, 1, din, dout, bf).tile)
        for name, tile in tiles.items():
            outs = [torch.empty(T, dout, dtype=bf, device="cuda") for _ in sets]

            def call(i, tile=tile):
                x, q8, sc, args, ndt, _, _ = sets[i]
                plan = fq._plan(T, 1, din, dout, bf, x.data_ptr(), q8.data_ptr())._replace(tile=tile)
                fq._launch(x, q8, sc, outs[i], args, ndt, LORA_SCALE, plan)
            call(0)
            torch.cuda.synchronize()
            if not torch.equal(outs[0], sets[0][-1]):
                raise AssertionError(f"K3 tile {name} differs bitwise from the planned tile at {site}")
            res[name] = time_ms(torch, [lambda i=i: call(i) for i in range(len(sets))], 20)
        rows.append(res)
        log(f"[k3-tiles] {site:34s} T={T:5d} {din:5d}x{dout:5d} plan={res['plan']} " +
            " ".join(f"{n}={res[n]:.4f}" for n in tiles))
        del sets
    return rows


def _factor(torch, g, m, n, ndt, lanes=0):
    from hyperscalees_t2i_tpu_torch.lora import FactoredDelta

    sh = (lanes,) if lanes else ()
    c = torch.full((), 0.01 / math.sqrt(R_E), device="cuda")
    if lanes:
        c = c * (1 + torch.rand(lanes, generator=g, device="cuda"))
    return FactoredDelta(torch.randn(m, n, generator=g, device="cuda") / math.sqrt(m),
                         torch.randn(*sh, m, R_E, generator=g, device="cuda").to(ndt),
                         torch.randn(*sh, n, R_E, generator=g, device="cuda").to(ndt), c)


def _lane(f, i):
    """Lane ``i`` of a laned factor, as a factor without lanes."""
    from hyperscalees_t2i_tpu_torch.lora import FactoredDelta

    return FactoredDelta(f.w, f.u[i], f.v[i], f.c[i])


def _lane_invariance(torch, tag: str, name: str, g, call, plan_of):
    """Bitwise batch and lane invariance of ``call(x, a, b)`` at
    1024×2240×2240 and 32×2240×2240, bf16 and f32 (noise in x's dtype): each
    lane of a 4-lane call against that lane alone, and row ranges of a lane
    against the same rows alone. ``plan_of(T, lanes, dtype)`` names the plan
    each call takes (logged: the pairs compared take different plans).
    Raises on any difference."""
    din = dout = 2240
    lanes, checked, plans = 4, 0, set()
    for T, ranges in ((1024, ((0, 1), (0, 2), (0, 50), (0, 257), (1023, 1024))),
                      (32, ((0, 1), (0, 2), (0, 9), (31, 32)))):
        for dt in (torch.bfloat16, torch.float32):
            a, b = _factor(torch, g, din, R_L, dt, lanes), _factor(torch, g, R_L, dout, dt, lanes)
            x = torch.randn(lanes * T, din, generator=g, device="cuda").to(dt)
            full = call(x, a, b)
            plans.add((T, str(dt), plan_of(T, lanes, dt), plan_of(T, 1, dt)))
            for i in range(lanes):
                al, bl = _lane(a, i), _lane(b, i)
                xi = x[i * T:(i + 1) * T]
                solo = call(xi, al, bl)
                pairs = [(f"lane {i} of {lanes}", solo, full[i * T:(i + 1) * T])]
                if i == 0:
                    pairs += [(f"rows {lo}:{hi}", call(xi[lo:hi], al, bl), solo[lo:hi]) for lo, hi in ranges]
                for what, got, want in pairs:
                    if not torch.equal(got, want):
                        diff = float((got.float() - want.float()).abs().max())
                        raise AssertionError(f"{name} {T}x{din}x{dout} {dt}: {what} alone differs from the "
                                             f"same rows in the larger call (max abs {diff})")
                    checked += 1
    torch.cuda.synchronize()
    log(f"[{tag}] batch and lane invariance: {checked} row ranges and lanes bitwise equal (bf16 and f32); "
        f"(T, dtype, plan with {lanes} lanes, plan alone): {sorted(plans)}")
    return checked


def phase_k3_invariance(torch):
    """K3's bitwise batch and lane invariance (``_lane_invariance``): at
    T = 32 a 4-lane call and one lane alone take different tiles; at f32,
    ≤ 8 rows take the other layout."""
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import _plan, fused_qlora_matmul

    g = torch.Generator(device="cuda").manual_seed(98)
    din = dout = 2240
    q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(1, dout, generator=g, device="cuda") * (2.0 / (127 * math.sqrt(din)))
    return _lane_invariance(torch, "k3", "fused_qlora", g,
                            lambda x, a, b: fused_qlora_matmul(x, q8, scale, a, b, LORA_SCALE),
                            lambda T, n, dt: _plan(T, n, din, dout, dt).tile)


def phase_k2_invariance(torch):
    """K2's bitwise batch and lane invariance (``_lane_invariance``): a
    4-lane call and one lane alone take different column groups (1024 and
    560 columns at T = 1024, 72 and 64 at T = 32)."""
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import _plan, member_lora_delta

    g = torch.Generator(device="cuda").manual_seed(97)
    return _lane_invariance(torch, "k2", "lora_chain", g, lambda x, a, b: member_lora_delta(x, a, b, LORA_SCALE),
                            lambda T, n, dt: _plan(T, n, 2240, 2240, dt).cols)


def phase_chain_check(torch, timed: bool = True):
    """K2 and K3 at the flagship's adapted-site shapes: error against the
    plain version, kernel / plain / library ms, and the bound; K3 also with
    q8 = 0 against the plain chain (its error alone), and beside the
    main-path rows the recorded ms of the design each replaced. ``ms`` is
    CUDA events around 20 back-to-back calls, which below ≈ 30 µs reads the
    host's pace; ``device_ms`` is the kernel's own duration under
    ``torch.profiler`` (``plain_device_ms`` the plain version's kernels,
    summed), and ``host_us`` the wrapper's host time a call."""
    from hyperscalees_t2i_tpu_torch.lora import effective_factor
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta, member_lora_delta_reference
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul, fused_qlora_reference

    g = torch.Generator(device="cuda").manual_seed(4321)
    rows = {"lora_chain": [], "fused_qlora": []}
    for site, T, din, dout, main_dt, calls in CHAIN_SHAPES:
        for dt_name in ("bfloat16", "float32"):
            main = dt_name == main_dt
            dt = getattr(torch, dt_name)
            ndt = torch.bfloat16 if main else torch.float32  # the main path stores noise bf16
            esize, nsize = dt.itemsize, ndt.itemsize
            fac_bytes = 4 * (din * R_L + R_L * dout) + nsize * (din + 2 * R_L + dout) * R_E + 8
            chain_flop = 2.0 * T * ((din + dout) * (R_L + R_E) + 2 * R_L * R_E)
            call_bytes = (T * din + T * dout) * esize + din * dout + fac_bytes
            sets = []
            for _ in range(max(1, min(8, math.ceil(100e6 / call_bytes)))):  # as for K1: beyond L2
                x = torch.randn(T, din, generator=g, device="cuda").to(dt)
                a, b = _factor(torch, g, din, R_L, ndt), _factor(torch, g, R_L, dout, ndt)
                q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
                scale = torch.rand(1, dout, generator=g, device="cuda") * (2.0 / (127 * math.sqrt(din)))
                sets.append(dict(x=x, a=a, b=b, q8=q8, scale=scale, w=(q8.float() * scale).to(dt),
                                 ak=effective_factor(a, dt), bk=effective_factor(b, dt)))
            for name, marker, kernel, plain, lib, flop, nbytes in (
                ("lora_chain", "::lora_chain_",
                 lambda s: member_lora_delta(s["x"], s["a"], s["b"], LORA_SCALE),
                 lambda s: member_lora_delta_reference(s["x"], s["a"], s["b"], LORA_SCALE),
                 lambda s: torch.matmul(torch.matmul(s["x"], s["ak"]), s["bk"]) * LORA_SCALE,
                 chain_flop, (T * din + T * dout) * esize + fac_bytes),
                ("fused_qlora", "::qlora_",
                 lambda s: fused_qlora_matmul(s["x"], s["q8"], s["scale"], s["a"], s["b"], LORA_SCALE),
                 lambda s: fused_qlora_reference(s["x"], s["q8"], s["scale"], s["a"], s["b"], LORA_SCALE),
                 lambda s: torch.addmm(torch.matmul(s["x"], s["w"]), torch.matmul(s["x"], s["ak"]), s["bk"],
                                       alpha=LORA_SCALE),
                 chain_flop + 2.0 * T * din * dout,
                 (T * din + T * dout) * esize + din * dout + 4 * dout + fac_bytes),
            ):
                s0 = sets[0]
                out = kernel(s0)
                torch.cuda.synchronize()
                err, tol, ref_max = check_close(f"{name} at {site} {T}x{din}x{dout} {dt_name}",
                                                out, plain(s0), dt_name, torch,
                                                again=lambda: (kernel(s0), plain(s0)))
                extra = {}
                if name == "fused_qlora":
                    # the chain alone (q8 = 0), so that its error cannot hide under the base term's size
                    out0 = fused_qlora_matmul(s0["x"], torch.zeros_like(s0["q8"]), s0["scale"], s0["a"], s0["b"],
                                              LORA_SCALE)
                    torch.cuda.synchronize()
                    c_err, c_tol, _ = check_close(f"fused_qlora chain only (q8 = 0) at {site} {T}x{din}x{dout} "
                                                  f"{dt_name}", out0,
                                                  member_lora_delta_reference(s0["x"], s0["a"], s0["b"], LORA_SCALE),
                                                  dt_name, torch)
                    extra = dict(chain_only_max_abs_err=c_err, chain_only_tol=c_tol)
                if main:
                    extra["before_ms"] = (K2_BEFORE_MS if name == "lora_chain" else K3_BEFORE_MS)[site]
                reps = (20 if T * din * dout < 5e9 else 10) if timed else 0
                kernel_fns = [lambda s=s: kernel(s) for s in sets]
                plain_fns = [lambda s=s: plain(s) for s in sets]
                ms = time_ms(torch, kernel_fns, reps)
                plain_ms = time_ms(torch, plain_fns, reps)
                lib_ms = time_ms(torch, [lambda s=s: lib(s) for s in sets], reps)
                dev_ms = device_ms(torch, kernel_fns, reps, marker)
                plain_dev_ms = device_ms(torch, plain_fns, reps)
                h_us = host_us(torch, kernel_fns, reps)
                b_ms, b_by = bound(dt_name, flop, nbytes)
                rows[name].append(dict(
                    site=site, T=T, din=din, dout=dout, dtype=dt_name, noise_dtype=str(ndt).split(".")[-1],
                    main_path=main, calls_per_image=calls if main else 0, max_abs_err=err, tol=tol,
                    ref_max=ref_max, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    device_ms=dev_ms, plain_device_ms=plain_dev_ms, host_us=h_us, tflops=flop / ms / 1e9, **extra,
                ))
                log(f"[{'k2' if name == 'lora_chain' else 'k3'}] {site:34s} T={T:5d} {din:5d}x{dout:5d} "
                    f"{dt_name:8s} {'main' if main else '    '} err={err:.3g} rel={err / ref_max:.3g} "
                    f"ms={ms:.4f} plain={plain_ms:.4f} library={lib_ms:.4f} bound={b_ms:.4f} ({b_by}) "
                    f"device_ms={dev_ms:.4f} plain_device_ms={plain_dev_ms:.4f} host_us={h_us:.1f} "
                    f"{flop / ms / 1e9:.1f} TFLOP/s" +
                    (f"; chain only err={extra['chain_only_max_abs_err']:.3g} (tol {extra['chain_only_tol']:.3g})"
                     if "chain_only_tol" in extra else "") +
                    (f"; before {extra['before_ms']:.4f}" if "before_ms" in extra else ""))
            del sets
    torch.cuda.empty_cache()
    return rows


def _inf_reps(flop: float, timed: bool) -> int:
    return (3 if flop < 1e10 else 2 if flop < 1e11 else 1) if timed else 0


def phase_inf_kernel_check(torch, timed: bool = True):
    """K1, K2 and K3 at Infinity-2B's main-path shapes, in the main path's
    dtypes, each against its plain version (bf16 within 2⁻⁷, f32 within
    1e-5 of the largest output): K3 and K2 at every adapted block site at
    each of the 14 scales (:data:`INF_CHAIN_SITES`, one lane, 8 · pn² rows
    up to 32,768; ``cross_kv`` on the 136 text rows), K1 at every int8
    matmul site of a call on the int8 base (:func:`inf_k1_shapes`: its f32
    route at ``word_embed``, ``text_proj``, ``pool_proj`` and the f32
    towers). Per shape: ``ms`` (CUDA events over ``_inf_reps`` calls
    rotating over ≥ 100 MB of input copies), the plain version's ``ms``,
    the kernel's ``device_ms`` under ``torch.profiler``, the library call's
    ``ms`` (K1: ``torch.matmul`` on the pre-dequantized weight; K3: that
    plus ``addmm`` with prebuilt ``a_k``, ``b_k``; K2: two ``torch.matmul``
    with prebuilt ``a_k``, ``b_k``) and the bound. Returns ``{"int8_matmul",
    "lora_chain", "fused_qlora": rows}`` with ``calls_per_call`` (calls of
    one generate call)."""
    from hyperscalees_t2i_tpu_torch.lora import effective_factor
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta, member_lora_delta_reference
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul, fused_qlora_reference
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul, int8_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(2048)
    rows = {"int8_matmul": [], "lora_chain": [], "fused_qlora": []}

    def sets_of(make, call_bytes):
        return [make() for _ in range(max(1, min(8, math.ceil(100e6 / call_bytes))))]

    def weight(din, dout):
        q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
        return q8, torch.rand(1, dout, generator=g, device="cuda") * (2.0 / (127 * math.sqrt(din)))

    def record(name, tag, site, T, din, dout, dt_name, calls, fns, flop, nbytes, marker, reps, **extra):
        kernel, plain, lib, again = fns
        out = kernel[0]()
        torch.cuda.synchronize()
        err, tol, ref_max = check_close(f"{name} at Infinity-2B {site} {T}x{din}x{dout} {dt_name}", out, plain[0](),
                                        dt_name, torch, again=again)
        ms = time_ms(torch, kernel, reps)
        plain_ms = time_ms(torch, plain, reps)
        lib_ms = time_ms(torch, lib, reps)
        dev_ms = device_ms(torch, kernel, reps, marker)
        b_ms, b_by = bound(dt_name, flop, nbytes)
        rows[name].append(dict(site=site, T=T, din=din, dout=dout, dtype=dt_name, main_path=True,
                               calls_per_call=calls, max_abs_err=err, tol=tol, ref_max=ref_max, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by,
                               tflops=flop / ms / 1e9 if reps else math.nan, **extra))
        log(f"[{tag}-inf] {site:34s} T={T:5d} {din:5d}x{dout:5d} {dt_name:8s} calls {calls:4d} err={err:.3g} "
            f"rel={err / ref_max:.3g} ms={ms:.4f} plain={plain_ms:.4f} library={lib_ms:.4f} device_ms={dev_ms:.4f} "
            f"bound={b_ms:.4f} ({b_by})")

    # K3 and K2 at the adapted block sites
    ndt = torch.float32
    chain = [(site, INF_ROWS * pn * pn, K, N, per * INF_DEPTH, si)
             for site, K, N, per in INF_CHAIN_SITES for si, pn in enumerate(INF_PATCH_NUMS)]
    chain.append((INF_CROSS_KV[0], INF_ROWS * INF_TEXT, INF_CROSS_KV[1], INF_CROSS_KV[2], INF_DEPTH, None))
    for site, T, din, dout, calls, si in chain:
        label = site if si is None else f"{site} scale {si}"
        fac_bytes = 4 * (din * R_L + R_L * dout) + 4 * (din + 2 * R_L + dout) * R_E + 8
        chain_flop = 2.0 * T * ((din + dout) * (R_L + R_E) + 2 * R_L * R_E)

        def make(T=T, din=din, dout=dout):
            x = torch.randn(T, din, generator=g, device="cuda").to(torch.bfloat16)
            a, b = _factor(torch, g, din, R_L, ndt), _factor(torch, g, R_L, dout, ndt)
            q8, scale = weight(din, dout)
            return dict(x=x, a=a, b=b, q8=q8, scale=scale, w=(q8.float() * scale).to(torch.bfloat16),
                        ak=effective_factor(a, torch.bfloat16), bk=effective_factor(b, torch.bfloat16))

        k3_bytes = 2 * (T * din + T * dout) + din * dout + 4 * dout + fac_bytes
        sets = sets_of(make, k3_bytes)
        s0 = sets[0]
        reps = _inf_reps(chain_flop + 2.0 * T * din * dout, timed)
        k3 = lambda s: fused_qlora_matmul(s["x"], s["q8"], s["scale"], s["a"], s["b"], LORA_SCALE)  # noqa: E731
        k3p = lambda s: fused_qlora_reference(s["x"], s["q8"], s["scale"], s["a"], s["b"], LORA_SCALE)  # noqa: E731
        record("fused_qlora", "k3", label, T, din, dout, "bfloat16", calls,
               ([lambda s=s: k3(s) for s in sets], [lambda s=s: k3p(s) for s in sets],
                [lambda s=s: torch.addmm(torch.matmul(s["x"], s["w"]), torch.matmul(s["x"], s["ak"]), s["bk"],
                                         alpha=LORA_SCALE) for s in sets], lambda: (k3(s0), k3p(s0))),
               chain_flop + 2.0 * T * din * dout, k3_bytes, "::qlora_", reps, noise_dtype="float32")
        k2 = lambda s: member_lora_delta(s["x"], s["a"], s["b"], LORA_SCALE)  # noqa: E731
        k2p = lambda s: member_lora_delta_reference(s["x"], s["a"], s["b"], LORA_SCALE)  # noqa: E731
        record("lora_chain", "k2", label, T, din, dout, "bfloat16", calls,
               ([lambda s=s: k2(s) for s in sets], [lambda s=s: k2p(s) for s in sets],
                [lambda s=s: torch.matmul(torch.matmul(s["x"], s["ak"]), s["bk"]) * LORA_SCALE for s in sets],
                lambda: (k2(s0), k2p(s0))),
               chain_flop, 2 * (T * din + T * dout) + fac_bytes, "::lora_chain_", _inf_reps(chain_flop, timed),
               noise_dtype="float32")
        del sets, s0
        torch.cuda.empty_cache()

    # K1 at the other int8 sites of a call on the int8 base
    for site, T, din, dout, dt_name, calls in inf_k1_shapes():
        dt = getattr(torch, dt_name)
        esize = dt.itemsize
        call_bytes = T * din * esize + din * dout + 4 * dout + T * dout * esize

        def make(T=T, din=din, dout=dout, dt=dt):
            x = torch.randn(T, din, generator=g, device="cuda").to(dt)
            q8, scale = weight(din, dout)
            return dict(x=x, q8=q8, scale=scale, w=(q8.float() * scale).to(dt))

        sets = sets_of(make, call_bytes)
        s0 = sets[0]
        k1 = lambda s: int8_matmul(s["x"], s["q8"], s["scale"])  # noqa: E731
        k1p = lambda s: int8_matmul_reference(s["x"], s["q8"], s["scale"])  # noqa: E731
        flop = 2.0 * T * din * dout
        record("int8_matmul", "k1", site, T, din, dout, dt_name, calls,
               ([lambda s=s: k1(s) for s in sets], [lambda s=s: k1p(s) for s in sets],
                [lambda s=s: torch.matmul(s["x"], s["w"]) for s in sets], lambda: (k1(s0), k1p(s0))),
               flop, call_bytes, "::int8_mma_kernel" if dt_name == "bfloat16" else "::f32_", _inf_reps(flop, timed))
        del sets, s0
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
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    bcfg = sana_rung_model("tiny")["bcfg"]
    bcfg = dataclasses.replace(
        bcfg, model=dataclasses.replace(bcfg.model, compute_dtype=torch.float32),
        vae=dataclasses.replace(bcfg.vae, compute_dtype=torch.float32))
    cpu = torch.device("cpu")
    params = quantize_tree(sana.init_sana(bcfg.model, threefry.prng_key(5, "cpu")), min_size=0)
    vae = quantize_tree(dcae.init_decoder(bcfg.vae, threefry.prng_key(6, "cpu")), min_size=0)
    prompts = ["a red cube", "a blue sphere"]
    outs = {}
    for dev in (cpu, torch.device("cuda")):
        b = SanaBackend(bcfg, dev, params=tree_map(lambda t: t.to(dev), params),
                        vae_params=tree_map(lambda t: t.to(dev), vae), prompts=prompts)
        b.setup()
        theta = b.init_theta(threefry.prng_key(7, "cpu"))
        gen = torch.Generator().manual_seed(8)
        theta = {k: {f: v + 0.05 * torch.randn(v.shape, generator=gen) for f, v in d.items()}
                 for k, d in theta.items()}
        with torch.inference_mode():  # each device draws the request's latents from its own key
            outs[dev.type] = b.generate(theta, [0, 1], threefry.prng_key(11, dev)).float().cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    log(f"[small] tiny rung served, f32 int8, card vs CPU: max abs diff {err:.3g} (tol 1e-4) "
        f"shape {tuple(outs['cuda'].shape)}")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU disagree on the tiny rung: {err}")
    return err


def _es_parts(torch, scale, dev, trees):
    """The ``scale`` rung's ES backend and reward suite in f32 on ``dev``
    from shared weight trees."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
    from hyperscalees_t2i_tpu_torch.models import clip
    from hyperscalees_t2i_tpu_torch.rewards.suite import make_clip_reward_fn
    from hyperscalees_t2i_tpu_torch.rungs import sana_rung_model
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    spec = sana_rung_model(scale, tower_dtype="float32")
    bcfg = dataclasses.replace(
        spec["bcfg"], model=dataclasses.replace(spec["bcfg"].model, compute_dtype=torch.float32),
        vae=dataclasses.replace(spec["bcfg"].vae, compute_dtype=torch.float32))
    on = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
    backend = SanaBackend(bcfg, dev, params=on(trees["params"]), vae_params=on(trees["vae"]),
                          prompts=trees["prompts"])
    backend.setup()
    reward = make_clip_reward_fn(clip.CLIPModel(spec["clip_b"], on(trees["clip"])), trees["table"].to(dev),
                                 pick_model=clip.CLIPModel(spec["clip_h"], on(trees["pick"])),
                                 pick_text_embeds=trees["ptable"].to(dev))
    return backend, reward


def _es_trees(torch, scale: str, int8: bool, key):
    """The ``scale`` rung's weight trees on the CPU, f32, drawn from the CPU
    ``key`` (every kernel quantized, min_size 0, with ``int8``), its CLIP
    text tables and six prompts: what :func:`_es_parts` builds on a device."""
    from hyperscalees_t2i_tpu_torch.models import clip, dcae, sana
    from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
    from hyperscalees_t2i_tpu_torch.rewards.suite import clip_text_embed_table, pickscore_text_embeds
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, PROMPT_TOKEN_LEN, sana_rung_model
    from hyperscalees_t2i_tpu_torch.utils import threefry

    spec = sana_rung_model(scale, tower_dtype="float32")
    prompts = BENCH_PROMPT_SET[:6]
    kc, kp, ki, kpi, ks, kv = threefry.split(key, 6)
    cparams, pparams = clip.init_clip(spec["clip_b"], kc), clip.init_clip(spec["clip_h"], kp)
    ids = threefry.randint(ki, (len(prompts) + 2, PROMPT_TOKEN_LEN), 0, spec["clip_b"].vocab_size)
    pids = threefry.randint(kpi, (len(prompts), PROMPT_TOKEN_LEN), 0, spec["clip_h"].vocab_size)
    with torch.inference_mode():
        table = clip_text_embed_table(clip.CLIPModel(spec["clip_b"], cparams), ids)
        ptable = pickscore_text_embeds(clip.CLIPModel(spec["clip_h"], pparams), pids)
    q = (lambda t: quantize_tree(t, min_size=0)) if int8 else (lambda t: t)  # noqa: E731
    return dict(params=q(sana.init_sana(spec["bcfg"].model, ks)), vae=q(dcae.init_decoder(spec["bcfg"].vae, kv)),
                clip=q(cparams), pick=q(pparams), table=table, ptable=ptable, prompts=prompts)


def phase_es_reference(torch, scale: str, int8: bool):
    """One ES step of the ``scale`` rung in f32 (TF32 off, ``pop_fuse``) on
    the card against the same step on the CPU: the same weights, θ, ES noise
    and generation noise; θ′ and the step's own reward rows within 1e-4.
    ``int8`` quantizes every kernel (min_size 0), so the adapted sites run
    K3; a float base runs K2 there. The card's launches must be exactly the
    counts derived from the module trees."""
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    _, pop, m, mb = RUNG_PLAN[scale]
    g = torch.Generator().manual_seed(21)
    trees = _es_trees(torch, scale, int8, threefry.prng_key(21, "cpu"))
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb, pop_fuse=True)
    outs = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        backend, suite = _es_parts(torch, scale, dev, trees)
        reward = RecordingReward(suite, -(-pop // mb))
        if dev.type == "cpu":
            theta = backend.init_theta(threefry.prng_key(22, "cpu"))
            theta = {k: {f: v + 0.05 * torch.randn(v.shape, generator=g) for f, v in d.items()}
                     for k, d in theta.items()}
            noise = sample_noise(threefry.prng_key(23, "cpu"), theta, pop, tc.es_config())
            flat = backend.step_info(0, m, 1).flat_ids
            gen_noise = backend.sample_gen_noise(threefry.prng_key(24, "cpu"), range(len(flat)))
        else:
            expected, per = expected_es_launches(backend, suite, tc, len(flat))
            torch.cuda.synchronize()
            _reset_counters()
        step = make_es_step(backend, reward, tc, m, 1, device=dev)
        theta_new, metrics, _ = step(theta, flat, threefry.prng_key(0, dev), noise=noise, gen_noise=gen_noise)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = _counters()
        calls_per_chunk = len(reward.rows) // -(-pop // mb)
        rows = reward_rows(torch, reward.rows, calls_per_chunk, len(flat) // calls_per_chunk)
        outs[dev.type] = (tree_map(lambda a: a.float().cpu(), theta_new), rows.float().cpu())
        del backend, suite, reward, step
    th_err = max(float((outs["cuda"][0][k][f] - outs["cpu"][0][k][f]).abs().max())
                 for k in outs["cpu"][0] for f in outs["cpu"][0][k])
    row_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    base = "int8" if int8 else "float"
    log(f"[es-{scale}] {scale} ES step f32 {base} base pop_fuse, card vs CPU: θ′ max abs diff {th_err:.3g}, "
        f"reward rows {tuple(outs['cuda'][1].shape)} max abs diff {row_err:.3g} (tol 1e-4); "
        f"launches {launches} expected {expected}")
    if tuple(outs["cuda"][1].shape) != (pop, len(flat)):
        raise AssertionError(f"{scale} reward rows {tuple(outs['cuda'][1].shape)} are not [{pop}, {len(flat)}]")
    if not (th_err <= 1e-4 and row_err <= 1e-4):
        raise AssertionError(f"card and CPU disagree on the {scale} ES step: θ′ {th_err}, rows {row_err}")
    kernel = "fused_qlora" if int8 else "lora_chain"
    if launches != expected or launches[kernel] == 0:
        raise AssertionError(f"{scale} ES step launched {launches}, expected {expected}")
    torch.cuda.empty_cache()
    return {"base": base, "theta_max_abs": th_err, "rows_max_abs": row_err, "launches": launches,
            "expected": expected, "per_call": per}


def _reset_counters():
    from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul

    int8_matmul.launches = member_lora_delta.launches = fused_qlora_matmul.launches = 0
    decode_attention.launches = 0


def _counters():
    from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul

    return {"int8_matmul": int8_matmul.launches, "lora_chain": member_lora_delta.launches,
            "fused_qlora": fused_qlora_matmul.launches, "decode_attention": decode_attention.launches}


def expected_es_launches(backend, reward, tc, batch: int):
    """Kernel launches of one ES step, derived from the module trees: every
    generate → decode → reward call (one per member chunk and image tile)
    launches, per LoRA-read DiT site, K3 (int8 node) or K2 (float node),
    and K1 at every other int8 matmul site of the DiT, the decoder and the
    reward towers' image sides (their text sides ran once, at build). A
    pipeline-mode backend runs the DiT ``num_inference_steps`` times a call
    (:func:`dit_passes`), its decoder and towers once."""
    adapted = backend.model.lora_sites()
    modules = dict(backend.model.named_modules())
    passes = dit_passes(backend)
    k3 = sum(1 for n in adapted if hasattr(modules[n], "q8")) * passes
    k2 = len(adapted) * passes - k3
    k1 = sum(1 for n, m in modules.items() if hasattr(m, "q8") and n not in adapted) * passes
    k1 += sum(1 for m in backend.vae.modules() if hasattr(m, "q8"))
    for tower in (reward.clip_model, reward.pick_model):
        if tower is not None:
            image_side = [tower.patch_embed, tower.vision, tower.visual_projection]
            k1 += sum(1 for part in image_side for m in part.modules() if hasattr(m, "q8"))
    calls = reward_calls(tc, batch)
    return ({"int8_matmul": k1 * calls, "lora_chain": k2 * calls, "fused_qlora": k3 * calls, "decode_attention": 0},
            {"k1_per_call": k1, "k2_per_call": k2, "k3_per_call": k3, "calls": calls, "dit_passes": passes})


def dit_passes(backend) -> int:
    """DiT passes of one Sana generate call: ``num_inference_steps`` in
    pipeline mode, else 1."""
    cfg = backend.cfg
    return int(cfg.num_inference_steps) if getattr(cfg, "backend_mode", "one_step") == "pipeline" else 1


def stage_breakdown(torch, backend, theta, reps: int = 3):
    """Device time of one served image's two stages, DiT + one-step sampler
    and DC-AE decode, by CUDA events around each (mean of ``reps`` warm runs)."""
    from hyperscalees_t2i_tpu_torch.models import dcae, sana
    from hyperscalees_t2i_tpu_torch.utils import threefry

    cfg = backend.cfg
    lora = {k: {f: t.to(backend.device)[None] for f, t in d.items()} for k, d in theta.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    gen_ms = dec_ms = 0.0
    with torch.inference_mode():
        for i in range(reps + 1):
            ev[0].record()
            lat = sana.one_step_generate(
                backend.model, backend.prompt_embeds[:1], backend.prompt_mask[:1], threefry.prng_key(0, "cuda"),
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


def phase_serve(torch, keep: bool = False):
    """Flagship serving (``SERVE_PLAN["flagship"]``, two tenants) through
    two engines on one backend, a CUDA graph per geometry and eager
    (``graph=False``), each warmed up (its admission estimate printed beside
    the built program's bytes), then ``N_REQUESTS`` requests served
    by each in turns (eager, graph, graph, eager), the launch counters set
    to 0 just before each flush and read just after: K1 exactly its sites ×
    the lane chunks dispatched for the eager engine, none for the graph's (a
    replay runs no wrapper); then one profiled flush of each, whose K1
    launches on the device (:func:`profiled_launches`) must be that count
    for both; the graph's images bitwise equal to the eager engine's; every
    image finite in [0, 1], the tenants' different; a request alone (padded
    to the geometry's lanes) equal to it batched, bitwise, under the graph;
    a brand-new tenant served with ``serve_compiles`` flat; one flush under
    an engine's own profile window (:func:`serve_profile_window`). The
    warm-ups and the four flushes run under the process's tracer: the
    trace holds the JAX package's serving spans under their JAX parents
    (``SERVE_SPANS``), the graph engine's warm-up counted ``serve_traces``
    twice a build (its warm-up and its capture), and the hot swaps after it
    (the graph flushes, the solo request, the new tenant) leave
    ``obs/serve_traces`` flat. ``keep`` also returns the backend, for
    :func:`phase_serve_tier`."""
    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_serve_backend
    from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry, set_registry
    from hyperscalees_t2i_tpu_torch.obs.trace import load_events, process_tracer
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_BASE_QUANT, SERVE_PLAN, sana_rung_model
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine
    from hyperscalees_t2i_tpu_torch.utils import threefry

    t0 = time.perf_counter()
    backend = build_serve_backend(sana_rung_model("flagship")["bcfg"], RUNG_BASE_QUANT["flagship"],
                                  device="cuda", prompts=BENCH_PROMPT_SET, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    routed = [m for m in list(backend.model.modules()) + list(backend.vae.modules()) if hasattr(m, "q8")]
    plan = SERVE_PLAN["flagship"]
    A, mb = plan["adapter_batch"], plan["member_batch"] or plan["adapter_batch"]
    engines = {v: ServeEngine(backend, ServeConfig(device="cuda", **plan), graph=v == "graph")
               for v in ("graph", "eager")}
    gen = torch.Generator().manual_seed(42)
    tenants = []
    for i in range(3):  # tenant2 arrives after the warm-up
        theta = backend.init_theta(threefry.fold_in(threefry.prng_key(8, "cpu"), i))
        tenants.append({k: {"a": d["a"], "b": 0.05 * torch.randn(d["b"].shape, generator=gen)}
                        for k, d in theta.items()})
    warm_s, admitted, serve_traces = {}, {}, {}
    trace_path = ROOT / "build" / "serve_trace.jsonl"
    trace_path.unlink(missing_ok=True)
    registry = set_registry(MetricsRegistry())
    try:
        with process_tracer(trace_path):
            for v, eng in engines.items():
                for i in range(2):
                    eng.put_adapter(f"tenant{i}", tenants[i])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                traces0 = registry.value("serve_traces", 0)
                (label,) = eng.warmup()
                torch.cuda.synchronize()
                warm_s[v] = time.perf_counter() - t0
                serve_traces[v] = registry.value("serve_traces", 0) - traces0
                admitted[v] = dict(eng.admission[label])
                if not admitted[v]["armed"] or admitted[v].get("measured_bytes") is None:
                    raise AssertionError(f"serving: the {v} engine's admission did not arm or measure: {admitted[v]}")
            # the graph engine's builds (its probes and its program) ran the body at the warm-up and the capture
            builds = len(admitted["graph"].get("probe_bytes", {})) + 1
            if serve_traces["graph"] != 2 * builds:
                raise AssertionError(f"serving: the graph engine's warm-up counted serve_traces "
                                     f"{serve_traces['graph']}, expected 2 a build over {builds} builds")
            traces_warm = registry.value("serve_traces", 0)
            entry = next(iter(engines["graph"].programs.stats().values()))
            if not entry["pool_bytes"] > 0:
                raise AssertionError(f"serving: the graph's pool holds {entry['pool_bytes']} bytes")
            log(f"[serve] flagship backend built in {build_s:.1f} s, warmup graph {warm_s['graph']:.1f} s (capture "
                f"{entry['capture_s']:.3f} s, instantiate {entry['instantiate_s']:.3f} s, pool "
                f"{entry['pool_bytes'] / 2**30:.2f} GiB), eager {warm_s['eager']:.1f} s; {len(routed)} int8 sites "
                f"route to the kernel; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            log("[serve] admission at adapter_batch " + str(A) + ": " + "; ".join(
                f"{v} estimate {r['estimate_bytes'] / 2**30:.3f} GiB (probes "
                f"{ {k: round(b / 2**30, 3) for k, b in r['probe_bytes'].items()} } GiB) against the built "
                f"{r['measured_bytes'] / 2**30:.3f} GiB (base {r['base_bytes'] / 2**30:.3f}): estimate/measured "
                f"{r['estimate_bytes'] / r['measured_bytes']:.4f}" for v, r in admitted.items()))

            images_per_req = plan["images_per_request"]
            per_flush = len(routed) * -(-N_REQUESTS // A) * -(-A // mb)
            expected = {"int8_matmul": per_flush, "lora_chain": 0, "fused_qlora": 0, "decode_attention": 0}
            walls = {"graph": [], "eager": []}
            counted = {v: [] for v in engines}
            results = {}

            def flush(eng):
                reqs = [eng.submit(f"tenant{i % 2}", [i // 2], seed=i // 2) for i in range(N_REQUESTS)]
                res = eng.flush()
                if [r.request.request_id for r in res] != [r.request_id for r in reqs] or not all(r.ok for r in res):
                    raise AssertionError("not every request was served")
                return res

            for v in ("eager", "graph", "graph", "eager"):
                torch.cuda.synchronize()
                _reset_counters()
                t0 = time.perf_counter()
                results[v] = flush(engines[v])
                torch.cuda.synchronize()
                walls[v].append(time.perf_counter() - t0)
                counted[v].append(_counters())
        span_counts = span_tree_check(load_events(trace_path), SERVE_SPANS, "the serving trace")
        nothing = {k: 0 for k in expected}
        if any(c != expected for c in counted["eager"]) or any(c != nothing for c in counted["graph"]):
            raise AssertionError(f"serving: the counters read {counted['eager']} over the eager flushes (expected "
                                 f"{expected} each), {counted['graph']} over the replays (expected none)")
        profiled = {}
        for v, eng in engines.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                flush(eng)
                torch.cuda.synchronize()
            kernels, busy, n_kernels, _ = device_kernels(torch, prof)
            profiled[v] = dict(launches=profiled_launches(kernels), busy_ms=busy, kernels=n_kernels)
            if profiled[v]["launches"] != expected:
                raise AssertionError(f"serving: the profiled {v} flush launched {profiled[v]['launches']} on the "
                                     f"device, expected {expected}")
        flushed = registry.value("serve_traces", 0)
        window = serve_profile_window(torch, backend, plan, tenants, flush, expected)  # another engine: its build
        traces_window = registry.value("serve_traces", 0)
        graph_vs_eager = max(float(abs(g.images - e.images).max()) for g, e in zip(results["graph"], results["eager"]))
        if graph_vs_eager != 0.0:
            raise AssertionError(f"served images: graph and eager differ by {graph_vs_eager}")
        for r in results["graph"]:
            im = r.images
            if im.shape != (images_per_req, 1024, 1024, 3):
                raise AssertionError(f"image shape {im.shape}")
            if not (math.isfinite(float(im.sum())) and im.min() >= 0.0 and im.max() <= 1.0):
                raise AssertionError("image not finite or outside [0, 1]")
        res = results["graph"]
        tenant_diff = float(abs(res[0].images - res[1].images).max())  # same seed, other adapter
        if not tenant_diff > 0:
            raise AssertionError("two tenants' adapters gave the same image")
        geng = engines["graph"]
        compiles = geng.registry.snapshot()["serve_compiles"]
        t0 = time.perf_counter()
        solo = geng.generate(res[0].request.adapter_id, res[0].request.prompt_ids, res[0].request.seed)
        solo_s = time.perf_counter() - t0
        solo_diff = float(abs(solo - res[0].images).max())
        if solo_diff != 0.0:
            raise AssertionError(f"batched and solo results differ by {solo_diff} under the graph")
        geng.put_adapter("tenant2", tenants[2])
        new_tenant = geng.generate("tenant2", [0], seed=0)
        snap = geng.registry.snapshot()
        if snap["serve_compiles"] != compiles or compiles != 1 or not np_isfinite(new_tenant):
            raise AssertionError(f"a new tenant changed serve_compiles {compiles} → {snap['serve_compiles']}")
        # the hot swaps between replays (tenants 0 and 1 in each flush, the solo request, tenant 2) traced nothing
        traces_end = registry.value("serve_traces", 0)
    finally:
        set_registry(None)
    if flushed != traces_warm or traces_end != traces_window:
        raise AssertionError(f"hot swaps between replays moved obs/serve_traces {traces_warm} → {flushed} (the "
                             f"flushes), {traces_window} → {traces_end} (the solo request, a new tenant)")
    breakdown = stage_breakdown(torch, backend, geng.store.get("tenant0"))
    images = N_REQUESTS * images_per_req
    stats = dict(
        breakdown_ms=breakdown, requests=N_REQUESTS, images=images, wall_s=walls["graph"],
        images_per_s=[images / w for w in walls["graph"]],
        eager=dict(wall_s=walls["eager"], images_per_s=[images / w for w in walls["eager"]],
                   warmup_s=warm_s["eager"], launches={k: 2 * n for k, n in expected.items()},
                   profiled_flush=profiled["eager"]),
        batch_latency_s=geng.dispatch_seconds, solo_s=solo_s,
        build_s=build_s, warmup_s=warm_s["graph"], graph=entry, launches_counted=counted["graph"],
        profiled_flush=profiled["graph"], launches_profiled=profiled["graph"]["launches"],
        profile_window=window, expected_launches_per_flush=expected,
        k1_calls_per_image=len(routed), batched_vs_solo_max_abs=solo_diff, graph_vs_eager_max_abs=graph_vs_eager,
        tenant_max_abs_diff=tenant_diff, plan=plan, serve_compiles=snap["serve_compiles"],
        serve_padded_slots=snap.get("serve_padded_slots", 0), admission=admitted,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, spans=span_counts,
        serve_traces_warmup=serve_traces,
        serve_traces_after_hot_swaps=flushed - traces_warm + traces_end - traces_window,
    )
    log(f"[serve] spans under their JAX parents: {span_counts}; serve_traces over the warm-ups {serve_traces} "
        f"({builds} graph builds: probes and program), +{flushed - traces_warm + traces_end - traces_window} over "
        f"the hot swaps after them (the profile window's engine built apart: +{traces_window - flushed})")
    log(f"[serve] {N_REQUESTS} requests a flush, in turns: graph {', '.join(f'{x:.3f}' for x in stats['images_per_s'])} "
        f"images/s, eager {', '.join(f'{x:.3f}' for x in stats['eager']['images_per_s'])} images/s; graph vs eager "
        f"max abs {graph_vs_eager:.3g}; solo (padded to {A} lanes) {solo_s:.3f} s, batched vs solo max abs "
        f"{solo_diff:.3g}; serve_compiles {snap['serve_compiles']} after a new tenant, padded slots "
        f"{stats['serve_padded_slots']}; K1-K4 launches: counted {counted['eager']} a flush eager, graph none; on "
        f"the device, a profiled flush: graph {profiled['graph']['launches']} (busy "
        f"{profiled['graph']['busy_ms']:.1f} ms), eager {profiled['eager']['launches']} (busy "
        f"{profiled['eager']['busy_ms']:.1f} ms); tenants differ by {tenant_diff:.3g}")
    del engines, geng
    torch.cuda.empty_cache()
    if keep:
        return stats, backend
    del backend
    torch.cuda.empty_cache()
    return stats


def serve_profile_window(torch, backend, plan, tenants, flush, expected):
    """One flush through a graph engine with its own profile window
    (``ServeConfig(profile_dir=…, profile_batches=…)``, the flush's
    dispatches: ``N_REQUESTS`` over ``adapter_batch`` lanes), opened after
    its warm-up: the exported trace's K1-K4 launches (``obs.profile_trace.
    kernel_evidence``) must be the flush's derived counts."""
    import shutil

    from hyperscalees_t2i_tpu_torch.obs.profile_trace import kernel_evidence, load_trace
    from hyperscalees_t2i_tpu_torch.serve import ServeConfig, ServeEngine

    prof_dir = ROOT / "build" / "serve_profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    batches = -(-N_REQUESTS // plan["adapter_batch"])
    eng = ServeEngine(backend, ServeConfig(device="cuda", profile_dir=str(prof_dir), profile_batches=batches, **plan))
    try:
        for i in range(2):
            eng.put_adapter(f"tenant{i}", tenants[i])
        eng.warmup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flush(eng)
        flush_s = time.perf_counter() - t0
        if eng.profile_trace is None:
            raise AssertionError("serving: the profile window did not close after its one batch")
        evidence = {k: v["events"] for k, v in kernel_evidence(load_trace(eng.profile_trace)).items()}
    finally:
        eng.close()
    mib = eng.profile_trace.stat().st_size / 2**20
    log(f"[serve] profile window (one flush of {batches} batches, {flush_s:.3f} s with the window's export): K1-K4 "
        f"in the trace "
        f"{evidence} (expected {expected}); trace {mib:.1f} MiB")
    if evidence != expected:
        raise AssertionError(f"serving: the profile window's trace holds {evidence}, expected {expected}")
    del eng
    torch.cuda.empty_cache()
    return {"launches": evidence, "flush_s": flush_s, "trace_mib": mib, "profile_batches": batches}


def np_isfinite(a) -> bool:
    return bool(math.isfinite(float(a.sum())))


def reward_rows(torch, calls, calls_per_chunk: int, tile: int):
    """``[pop, B]`` rows from the reward calls of one step, in call order:
    each member chunk makes ``calls_per_chunk`` calls, one per image tile,
    each of ``[lanes · tile]`` rewards, lane-major."""
    chunks = []
    for i in range(0, len(calls), calls_per_chunk):
        tiles = calls[i:i + calls_per_chunk]
        chunks.append(torch.cat([t.reshape(t.numel() // tile, tile) for t in tiles], dim=1))
    return torch.cat(chunks)


class RecordingReward:
    """The reward suite, copying each call's ``combined`` row into a slot of
    its own: ``calls`` slots, one per generate → reward call of a step, made
    at the first step's calls. A CUDA graph captures the copies, so each
    replay refreshes the slots as an eager step does; ``rows`` holds the
    last step's rows in call order (the step's ``[pop, B]`` rows)."""

    def __init__(self, suite, calls: int):
        self.suite, self.calls, self.rows, self.n = suite, calls, [], 0

    def __call__(self, images, prompt_ids):
        out = self.suite(images, prompt_ids)
        i = self.n % self.calls
        self.n += 1
        if len(self.rows) <= i:
            self.rows.append(out["combined"].clone())
        else:
            self.rows[i].copy_(out["combined"])
        return out


def reward_calls(tc, batch: int) -> int:
    """Generate → reward calls of one ES step: member chunks × image tiles."""
    from hyperscalees_t2i_tpu_torch.parallel.pop_eval import effective_reward_tile

    return -(-tc.pop_size // tc.member_batch) * (batch // (effective_reward_tile(batch, tc.reward_tile) or batch))


def es_stage_breakdown(torch, backend, reward, theta, noise, tc, tag: str, reps: int = 2):
    """One member's work on one image. Stage times by CUDA events (the
    stream's time from the first to the last launch of a stage, gaps
    included; mean of ``reps`` warm runs): generation (DiT + sampler with
    the member's factored adapter), DC-AE decode, and the reward (resize +
    both towers). Then one run under ``torch.profiler``: device time per
    kernel name, and the busy time of the device; the idle share is one
    minus that busy time over the unprofiled stages' total."""
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.es.noiser import factored_member_theta
    from hyperscalees_t2i_tpu_torch.models import dcae, sana
    from hyperscalees_t2i_tpu_torch.utils import threefry

    cfg = backend.cfg
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    acc = [0.0, 0.0, 0.0]
    lat_noise = backend.sample_gen_noise(threefry.prng_key(0, "cuda"), [0])

    def one():
        ev[0].record()
        lat = sana.one_step_generate(backend.model, backend.prompt_embeds[:1], backend.prompt_mask[:1],
                                     guidance_scale=cfg.guidance_scale,
                                     latent_hw=(cfg.height_latent, cfg.width_latent), lora=theta_k,
                                     lora_scale=backend.lora_scale, noise=lat_noise)
        ev[1].record()
        images = dcae.decode(backend.vae, lat / cfg.vae.scaling_factor)
        ev[2].record()
        reward(images, torch.zeros(1, dtype=torch.long, device="cuda"))
        ev[3].record()
        torch.cuda.synchronize()

    with torch.inference_mode():
        theta_k = factored_member_theta(theta, noise, 0, tc.pop_size, tc.es_config())
        for i in range(reps + 1):
            one()
            if i:  # the first run warms up
                for j in range(3):
                    acc[j] += ev[j].elapsed_time(ev[j + 1]) / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one()
    kernels, busy, n_kernels, top = device_kernels(torch, prof)
    in_situ = {}  # the port's kernels: (ms, launches) summed over their routes
    for kname, markers in (("int8_matmul", ("::int8_mma_kernel", "::f32_tile_kernel", "::f32_rows_kernel")),
                           ("lora_chain", ("::lora_chain_",)), ("fused_qlora", ("::qlora_",))):
        hits = [v for name, v in kernels.items() if any(m in name for m in markers)]
        in_situ[kname] = {"ms": sum(m for m, _ in hits), "launches": sum(n for _, n in hits)}
    out = {"generation": acc[0], "decode": acc[1], "reward": acc[2], "device_busy_profiled": busy,
           "idle_share": 1.0 - busy / sum(acc), "device_kernels": n_kernels, "in_situ": in_situ,
           "top_kernels": [dict(name=t, ms=m, launches=n) for m, n, t in top]}
    log(f"[{tag}] one member, one image, device time: generation {acc[0]:.2f} ms, decode {acc[1]:.2f} ms, "
        f"reward {acc[2]:.2f} ms; {n_kernels} kernels busy {busy:.2f} ms (profiled) = idle share "
        f"{out['idle_share']:.3f}; in situ " +
        ", ".join(f"{k} {v['ms']:.2f} ms over {v['launches']}" for k, v in in_situ.items()))
    for m, n, t in top:
        log(f"[{tag}]   {m:9.3f} ms {n:5d} launches  {t}")
    return out


def _clone_tree(tree):
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


class SlotRecorder:
    """Patches ``module.name`` so each call's output is copied into a slot
    of its own (``calls`` slots a step, made at the first step's calls): a
    CUDA graph captures the copies, so ``slots`` holds the last step's
    outputs whether it was replayed or ran eagerly."""

    def __init__(self, module, name: str, calls: int):
        self.mod, self.name, self.orig, self.calls, self.slots, self.n = module, name, getattr(module, name), calls, [], 0

    def __enter__(self):
        def rec(*a, **kw):
            out = self.orig(*a, **kw)
            i = self.n % self.calls
            self.n += 1
            if len(self.slots) <= i:
                self.slots.append(out.clone())
            else:
                self.slots[i].copy_(out)
            return out

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def profiled_epoch(torch, step, theta, ids, key):
    """One epoch under ``torch.profiler`` (device activity only): the
    device's busy ms (kernels' durations summed), the kernels it saw, K1-K4's
    launches among them (:func:`profiled_launches`), and the CUDA-event ms
    from the step's first launch to its last."""
    from torch.profiler import ProfilerActivity, profile

    delta = {k: {f: torch.zeros_like(t) for f, t in d.items()} for k, d in theta.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        step(theta, delta, ids, key)
        ev[1].record()
        torch.cuda.synchronize()
    kernels, busy, n, _ = device_kernels(torch, prof)
    return {"busy_ms": busy, "kernels": n, "event_ms": ev[0].elapsed_time(ev[1]),
            "launches": profiled_launches(kernels)}


def timed_epochs(torch, make_step, theta, flat_ids, expected1, pop: int, calls_per_chunk: int, tag: str,
                 what: str, record=None):
    """The stateful step as a CUDA graph and eagerly, in turns in one
    process: ``make_step(graph) → (step, RecordingReward)``, the step's
    cache a ``GraphCache(graph=graph)``. Each variant's first call warms up
    (the graph's also captures and instantiates it), then ``TIMED_EPOCHS``
    epochs, each run by both variants from the same θ, Δθ and key (eager
    first in even epochs, the graph first in odd ones; host clock around
    work that ends in a synchronize), the launch counters set to 0 just
    before each variant's epoch and read just after: the eager step's must
    be ``expected1``, the graph's 0 (a replay runs no wrapper); then one
    profiled epoch of each, whose K1-K4 launches on the device
    (:func:`profiled_launches`) must be ``expected1`` for both (a miss is
    profiled again to count, up to ``PROFILE_ATTEMPTS`` in all). The graph's
    θ′, Δθ, metrics, scores and reward rows (and ``record``'s slots: a
    :class:`SlotRecorder` active around the whole) must equal the eager
    step's bitwise, or within 1e-4 with the difference recorded; the last
    rows ``[pop, B]`` finite, θ′ finite, ‖Δθ‖ > 0. Device memory: the eager
    step's peak allocated; the graph's peak allocated under replay plus its
    whole pool (which holds the replay's intermediates). Epoch ``e``'s key
    is ``epoch_key(0, e)`` on the card. Returns ``(θ′, stats)``: the
    graph's numbers at the top level, the eager step's under ``eager``."""
    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key

    B = len(flat_ids)
    ids = torch.tensor(list(flat_ids), dtype=torch.long, device="cuda")
    zeros = lambda th: {k: {f: torch.zeros_like(t) for f, t in d.items()} for k, d in th.items()}  # noqa: E731
    runs = {v: make_step(v == "graph") for v in ("graph", "eager")}
    warm_s = {}
    for v, (step, _) in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(_clone_tree(theta), zeros(theta), ids, epoch_key(0, 100, "cuda"))
        torch.cuda.synchronize()
        warm_s[v] = time.perf_counter() - t0
    graph_entry = next(iter(runs["graph"][0].graphs.stats().values()))
    if not graph_entry["pool_bytes"] > 0:
        raise AssertionError(f"{what}: the graph's pool holds {graph_entry['pool_bytes']} bytes")

    delta = zeros(theta)
    epoch_s = {"graph": [], "eager": []}
    counted = {v: [] for v in runs}
    peak = {v: 0 for v in runs}
    worst, record_worst = 0.0, 0.0
    for e in range(TIMED_EPOCHS):
        outs = {}
        for v in (("eager", "graph") if e % 2 == 0 else ("graph", "eager")):
            step, reward = runs[v]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            t0 = time.perf_counter()
            th, dl, metrics, opt_scores = step(theta, delta, ids, epoch_key(0, 101 + e, "cuda"))
            torch.cuda.synchronize()
            epoch_s[v].append(time.perf_counter() - t0)
            counted[v].append(_counters())
            peak[v] = max(peak[v], torch.cuda.max_memory_allocated())
            outs[v] = dict(theta=_clone_tree(th), delta=_clone_tree(dl),
                           metrics={k: t.clone() for k, t in metrics.items()}, opt_scores=opt_scores.clone(),
                           rows=reward_rows(torch, reward.rows, calls_per_chunk, B // calls_per_chunk).clone(),
                           record=[t.clone() for t in record.slots] if record is not None else [])
        g, x = outs["graph"], outs["eager"]
        pairs = [(g[n][k][f], x[n][k][f]) for n in ("theta", "delta") for k in g[n] for f in g[n][k]]
        pairs += [(g["metrics"][k], x["metrics"][k]) for k in g["metrics"]]
        pairs += [(g["opt_scores"], x["opt_scores"]), (g["rows"], x["rows"])]
        worst = max([worst] + [_max_abs(a, b) for a, b in pairs])
        record_worst = max([record_worst] + [_max_abs(a, b) for a, b in zip(g["record"], x["record"])])
        if len(g["record"]) != len(x["record"]):
            raise AssertionError(f"{what}: the graph recorded {len(g['record'])} calls, eager {len(x['record'])}")
        theta, delta = g["theta"], g["delta"]
        rows, metrics, opt_scores = g["rows"], g["metrics"], g["opt_scores"]
    nothing = {k: 0 for k in expected1}
    if any(c != expected1 for c in counted["eager"]) or any(c != nothing for c in counted["graph"]):
        raise AssertionError(f"{what}: the counters read {counted['eager']} over the eager epochs (expected "
                             f"{expected1} each), {counted['graph']} over the replays (expected none)")
    if not (worst <= 1e-4 and record_worst == 0.0):
        raise AssertionError(f"{what}: graph and eager differ by {worst} (outputs), {record_worst} (recorded)")
    if tuple(rows.shape) != (pop, B) or not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"reward rows {tuple(rows.shape)} not [{pop}, {B}] and finite")
    if not all(bool(torch.isfinite(t).all()) for d in theta.values() for t in d.values()):
        raise AssertionError("θ′ not finite")
    delta_norm = float(metrics["delta_norm"])
    if not delta_norm > 0:
        raise AssertionError(f"the update is zero (delta_norm {delta_norm})")
    prof = {}
    for v in runs:  # a miss profiles the same epoch again to count (PROFILE_ATTEMPTS); the first keeps its times
        attempts = []
        while not attempts or (attempts[-1] != expected1 and len(attempts) < PROFILE_ATTEMPTS):
            if attempts:
                log(f"[{tag}] the profiler saw {attempts[-1]} in profiled {v} epoch {len(attempts)} of "
                    f"{PROFILE_ATTEMPTS}, expected {expected1}: profiling it again to count")
            p = profiled_epoch(torch, runs[v][0], theta, ids, epoch_key(0, 200, "cuda"))
            prof.setdefault(v, p)
            attempts.append(p["launches"])
        prof[v]["attempts"], prof[v]["launches"] = attempts, attempts[-1]
    for v, p in prof.items():
        if p["launches"] != expected1:
            raise AssertionError(f"{what}: the profiled {v} epochs launched {p['attempts']} on the device, "
                                 f"expected {expected1}")
        p["idle_share"] = 1.0 - p["busy_ms"] / (1e3 * statistics.mean(epoch_s[v]))
    del runs
    torch.cuda.synchronize()
    images = pop * B
    memory = {"graph": (peak["graph"] + graph_entry["pool_bytes"]) / 2**30, "eager": peak["eager"] / 2**30}
    eager_launches = {k: sum(c[k] for c in counted["eager"]) for k in expected1}
    stats = dict(
        warmup_epoch_s=warm_s["graph"], epoch_s=epoch_s["graph"], images_per_epoch=images,
        images_per_s=[images / s for s in epoch_s["graph"]], peak_mem_gib=memory["graph"],
        peak_allocated_gib=peak["graph"] / 2**30, launches_counted=counted["graph"],
        launches_profiled=prof["graph"]["launches"], expected_launches_per_epoch=expected1,
        reward_rows=rows.float().cpu().tolist(),
        opt_scores=[float(s) for s in opt_scores], delta_norm=delta_norm, theta_norm=float(metrics["theta_norm"]),
        metrics={k: (float(v) if v.numel() == 1 else v.float().cpu().tolist()) for k, v in metrics.items()},
        graph_vs_eager_max_abs=worst, graph_vs_eager_bitwise=worst == 0.0,
        recorded_bitwise=record_worst == 0.0, profile=prof["graph"],
        graph=graph_entry,
        eager=dict(epoch_s=epoch_s["eager"], images_per_s=[images / s for s in epoch_s["eager"]],
                   warmup_epoch_s=warm_s["eager"], peak_mem_gib=memory["eager"],
                   launches=eager_launches, launches_profiled=prof["eager"]["launches"], profile=prof["eager"]),
    )
    log(f"[{tag}] {what}, graph and eager in turns: epochs graph {', '.join(f'{t:.3f}' for t in epoch_s['graph'])} s, "
        f"eager {', '.join(f'{t:.3f}' for t in epoch_s['eager'])} s (first calls: graph {warm_s['graph']:.3f} s "
        f"incl. capture {graph_entry['capture_s']:.3f} s + instantiate {graph_entry['instantiate_s']:.3f} s, pool "
        f"{graph_entry['pool_bytes'] / 2**30:.2f} GiB; eager {warm_s['eager']:.3f} s); profiled epoch: graph busy "
        f"{prof['graph']['busy_ms']:.1f} ms over {prof['graph']['kernels']} kernels, events "
        f"{prof['graph']['event_ms']:.1f} ms; eager busy {prof['eager']['busy_ms']:.1f} ms over "
        f"{prof['eager']['kernels']} kernels, events {prof['eager']['event_ms']:.1f} ms; idle share graph "
        f"{prof['graph']['idle_share']}, eager {prof['eager']['idle_share']}; device memory graph "
        f"{memory['graph']:.2f} GiB (peak allocated {peak['graph'] / 2**30:.2f} + pool), eager {memory['eager']:.2f} "
        f"GiB (peak allocated); K1-K4 launches: counted eager {eager_launches} over {TIMED_EPOCHS} epochs, graph "
        f"none; on the device, a profiled epoch: graph {prof['graph']['launches']}, eager "
        f"{prof['eager']['launches']} (expected {expected1}); graph vs eager max abs {worst:.3g}"
        f"{' (bitwise)' if worst == 0 else ''}; reward rows {tuple(rows.shape)}; delta_norm {delta_norm:.4g}, "
        f"theta_norm {stats['theta_norm']:.4g}")
    return theta, stats


def phase_es_flagship(torch, base_quant=None, keep: bool = False, layers: int = 0):
    """The flagship ES epoch step: with the rung's int8 base (the main
    path: K3 at the adapted sites, K1 elsewhere) or, ``base_quant="off"``,
    a bf16 base (K2's path: K2 at the adapted sites, no int8 site).
    ``keep`` also returns the backend and the reward suite, for
    :func:`phase_train_flagship`. ``layers`` cuts the DiT to that many of
    its 20 blocks (:func:`cut_flagship_backend`; the reward suite from the
    same key as the full build's)."""
    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.rewards.suite import build_random_reward_suite
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_PLAN, rung_opt, sana_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    if base_quant is not None:
        opt["base_quant"] = base_quant
    tag = "es" if opt["base_quant"] == "int8" else f"es-{opt['base_quant']}"
    torch.cuda.reset_peak_memory_stats()
    left_before = torch.cuda.memory_allocated()  # what earlier phases of the process still hold
    t0 = time.perf_counter()
    if layers:
        backend = cut_flagship_backend(torch, layers, opt["base_quant"])
        spec = sana_rung_model("flagship", tower_dtype=opt["tower_dtype"])
        suite = build_random_reward_suite(spec["clip_b"], spec["clip_h"], len(BENCH_PROMPT_SET),
                                          threefry.prng_key(1, "cuda"), torch.bfloat16, opt["base_quant"])
    else:
        backend, suite = build_train_backend("flagship", device="cuda", base_quant=opt["base_quant"], seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb, promptnorm=True,
                     reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"], pop_fuse=opt["pop_fuse"])
    info = backend.step_info(0, m, 1)
    B = len(info.flat_ids)
    expected1, per = expected_es_launches(backend, suite, tc, B)

    def make_step(graph: bool):
        reward = RecordingReward(suite, per["calls"])
        return make_es_step(backend, reward, tc, len(info.unique_ids), 1, device="cuda", stateful_delta=True,
                            graphs=GraphCache("cuda", graph=graph)), reward

    log(f"[{tag}] flagship ES backend ({opt['base_quant']} base{f', {layers} of 20 blocks' if layers else ''}) built "
        f"in {build_s:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; per generate→reward call: "
        f"K3 {per['k3_per_call']}, K1 {per['k1_per_call']}, K2 {per['k2_per_call']}; {per['calls']} calls per epoch")
    # a fresh run's θ (b = 0) from bench.py's PRNGKey(1)
    theta = backend.init_theta(threefry.prng_key(1, "cuda"))
    theta, run = timed_epochs(torch, make_step, theta, info.flat_ids, expected1, pop,
                              per["calls"] // -(-pop // mb), tag, f"flagship ES epoch ({opt['base_quant']} base)")
    noise = sample_noise(threefry.prng_key(5, "cuda"), theta, pop, tc.es_config())
    breakdown = es_stage_breakdown(torch, backend, suite, theta, noise, tc, tag)
    stats = dict(plan=dict(pop=pop, prompts=m, member_batch=mb, **opt), build_s=build_s, per_call=per,
                 member_breakdown_ms=breakdown, allocated_before_gib=left_before / 2**30, layers=layers or 20, **run)
    torch.cuda.empty_cache()
    if keep:
        return stats, (backend, suite)
    del backend, suite
    torch.cuda.empty_cache()
    return stats


def _train(torch, backend, reward, tc, expected1, what: str, spy=None):
    """``run_training`` on the card with the launch counters set to 0 just
    before and read just after. The counters see the epochs that ran
    eagerly: each program's first call (its warm-up, before the capture) or
    every epoch of a backend without graphs; they must be ``expected1`` per
    such epoch. The other epochs are replays of a captured graph, which the
    program cache counts (:func:`timed_epochs` counts a replay's launches on
    the device). ``spy(epoch, θ)`` sees the θ each epoch's step is called
    with (the step's inputs, before its program runs). Returns ``(state,
    per-epoch scalars, launches, wall s, eager epochs)``."""
    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.train import trainer

    history, caches = [], []
    real = trainer.make_es_step

    def spying_make(*a, **kw):
        step = real(*a, **kw)
        if all(c is not step.graphs for c in caches):
            caches.append(step.graphs)
        if spy is None:
            return step

        def spied(theta, prev_delta, flat_ids, key, *rest, **kwr):
            spy(next(e for e in range(64) if torch.equal(epoch_key(tc.seed, e, key.device), key)), theta)
            return step(theta, prev_delta, flat_ids, key, *rest, **kwr)

        spied.graphs = step.graphs
        return spied

    trainer.make_es_step = spying_make
    try:
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        state = trainer.run_training(backend, reward, tc, on_epoch_end=lambda e, s: history.append(s), device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _counters()
    finally:
        trainer.make_es_step = real
    epochs = sum(h["epochs_chained"] for h in history)
    replays = sum(st["replays"] for c in caches for st in c.stats().values())
    graphed = sum(len(c.stats()) for c in caches)
    eager_epochs = epochs - replays
    if graphed and eager_epochs != graphed:
        raise AssertionError(f"{what}: {epochs} epochs, {replays} replays of {graphed} graphs")
    expected = {k: v * eager_epochs for k, v in expected1.items()}
    if launches != expected:
        raise AssertionError(f"{what} launched {launches} over its {eager_epochs} eager epochs, expected {expected}")
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves

    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.theta)):
        raise AssertionError(f"{what}: θ not finite")
    return state, history, launches, wall_s, eager_epochs


def _cpu_tree(torch, tree):
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    return tree_map(lambda t: t.detach().float().cpu().clone(), tree)


def phase_train_reference(torch):
    """The trainer (``run_training``) on the tiny rung in f32 with an int8
    base (K3, K1) on the card against the same run on the CPU: the same
    weights and θ₀ (the seam ``_init_theta``, drawn on the CPU and moved);
    each device draws the epochs' noise from the same keys (within 1e-5,
    ``phase_threefry``), the card inside its step's graph. Two epochs: θ
    and each epoch's ``per_prompt_mean`` within 1e-4, the card's launches
    exactly as derived; ``regenerate_member_images`` of θ₀ (epoch 1, member
    1) within 1e-4; the plan's ``programs.jsonl`` record, FLOPs and bytes
    counted over its warm-up epoch, equal on the card and the CPU."""
    import shutil

    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils import threefry

    _, pop, m, mb = RUNG_PLAN["tiny"]
    trees = _es_trees(torch, "tiny", True, threefry.prng_key(31, "cpu"))
    root = ROOT / "build" / "train_tiny"
    shutil.rmtree(root, ignore_errors=True)
    cpu = torch.device("cpu")
    real_init = trainer._init_theta
    trainer._init_theta = lambda b, tc, dev: {k: {f: t.to(dev) for f, t in d.items()}  # noqa: E731
                                              for k, d in real_init(b, tc, cpu).items()}
    outs = {}
    try:
        for dev in (cpu, torch.device("cuda")):
            backend, suite = _es_parts(torch, "tiny", dev, trees)
            tc = TrainConfig(num_epochs=2, pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, member_batch=mb,
                             pop_fuse=True, save_every=1, run_dir=str(root / dev.type), run_name="tiny", seed=7)
            if dev.type == "cpu":
                history = []
                state = trainer.run_training(backend, suite, tc, on_epoch_end=lambda e, s: history.append(s),
                                             device=cpu)
            else:
                expected1, _ = expected_es_launches(backend, suite, tc, m)
                state, history, launches, _, _ = _train(torch, backend, suite, tc, expected1, "tiny run_training")
            theta0 = {k: {f: t.to(dev) for f, t in d.items()} for k, d in real_init(backend, tc, cpu).items()}
            regen = trainer.regenerate_member_images(backend, theta0, tc, 1, 1, backend.step_info(1, m, 1))
            (rec,) = [json.loads(x) for x in (root / dev.type / "tiny" / "programs.jsonl").read_text().splitlines()]
            outs[dev.type] = (_cpu_tree(torch, state.theta), [h["per_prompt_mean"] for h in history], regen, rec)
            del backend, suite
    finally:
        trainer._init_theta = real_init
    th_err = max(float((outs["cuda"][0][k][f] - outs["cpu"][0][k][f]).abs().max())
                 for k in outs["cpu"][0] for f in outs["cpu"][0][k])
    pm_err = max(abs(a - b) for ec, eg in zip(outs["cpu"][1], outs["cuda"][1]) for a, b in zip(ec, eg))
    regen_err = float(abs(outs["cuda"][2] - outs["cpu"][2]).max())
    counts = {d: {k: outs[d][3][k] for k in ("flops", "bytes_accessed", "counted_ops", "kernels")} for d in outs}
    log(f"[train-tiny] tiny run_training f32 int8 base, 2 epochs, card vs CPU: θ max abs diff {th_err:.3g}, "
        f"per_prompt_mean max abs diff {pm_err:.3g}, regenerate_member_images max abs diff {regen_err:.3g} (tol "
        f"1e-4); launches {launches}; counted warm-up: card {counts['cuda']['flops']} FLOP "
        f"{counts['cuda']['bytes_accessed']} B over {counts['cuda']['counted_ops']} ops, CPU {counts['cpu']['flops']} "
        f"FLOP {counts['cpu']['bytes_accessed']} B over {counts['cpu']['counted_ops']} ops")
    if len(outs["cuda"][1]) != 2 or not (th_err <= 1e-4 and pm_err <= 1e-4 and regen_err <= 1e-4):
        raise AssertionError(f"card and CPU disagree on the tiny run_training: θ {th_err}, per_prompt_mean {pm_err}, "
                             f"regeneration {regen_err}")
    if counts["cuda"] != counts["cpu"]:
        raise AssertionError(f"the tiny plan's counted warm-up differs: card {counts['cuda']}, CPU {counts['cpu']}")
    torch.cuda.empty_cache()
    return {"theta_max_abs": th_err, "per_prompt_mean_max_abs": pm_err, "regenerate_max_abs": regen_err,
            "counted": counts["cuda"], "launches": launches}


# the JAX parents of the spans a traced run_training writes (tests/test_obs.py's tree)
TRAIN_SPANS = {"setup": None, "epoch": None, "plan": "epoch", "compile": "epoch", "trace/pop_eval": "compile",
               "dispatch": "epoch", "log": "epoch", "checkpoint": "epoch"}
# ... and of a serving engine's spans (tests/test_serve.py's chain and the JAX warm-up)
SERVE_SPANS = {"serve/compile": None, "trace/serve_batch": "serve/compile", "serve/warmup": None,
               "serve/submit": None, "serve/coalesce": None, "serve/batch": None, "serve/dispatch": "serve/batch",
               "serve/request": "serve/batch"}


def span_tree_check(events, want, what):
    """Every span name of ``want`` is in ``events``, and each of its events
    has the parent ``want`` gives (the JAX package's); returns each name's
    count."""
    counts = {name: 0 for name in want}
    wrong = []
    for e in events:
        if e["name"] in want:
            counts[e["name"]] += 1
            if e["parent"] != want[e["name"]]:
                wrong.append((e["name"], e["parent"]))
    missing = [n for n, c in counts.items() if not c]
    if missing or wrong:
        raise AssertionError(f"{what}: spans missing {missing}, under other parents than the JAX package's "
                             f"{sorted(set(wrong))}")
    return counts


def flagship_train_base(root):
    """The ``TrainConfig`` fields of :func:`phase_train_flagship`'s runs
    (``RUNG_PLAN``/``RUNG_OPT["flagship"]``, quality on, a slot every 2
    epochs, traced) under ``root``."""
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    return dict(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, batches_per_gen=1, member_batch=mb,
                reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"],
                pop_fuse=opt["pop_fuse"], base_quant=opt["base_quant"], quality=True, save_every=2,
                run_dir=str(root), run_name="flagship", trace=True)


def phase_train_flagship(torch, backend, suite, es):
    """The trainer around the flagship step, on the backend
    :func:`phase_es_flagship` built (``RUNG_PLAN``/``RUNG_OPT["flagship"]``,
    ``quality=True``, ``save_every=2``, traced): ``run_training`` for 4
    epochs, then again with ``num_epochs=5`` and ``resume``, which must run
    exactly epoch 4 from the epoch-4 slot's θ bitwise; then 1 epoch with
    ``quality=False``. Each run's counted K1-K4 launches must be the
    derived counts × its eager epochs (its program's warm-up; the rest are
    graph replays; K3 164 and K1 329 per image, no K2 or K4);
    ``metrics.jsonl`` must hold 5 rows with ``quality/combined/prompt_mean``;
    the epoch-4 slot's sha256s are recomputed from its file and its digest
    from a read-back. Prints each epoch's ``step_time_s`` beside the bare
    step's epochs of ``es`` and each checkpoint save's time (its trace
    span)."""
    import hashlib
    import shutil

    import numpy as np

    from hyperscalees_t2i_tpu_torch.obs.trace import load_events
    from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore, slot_theta_digest
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows

    _, pop, m, mb = RUNG_PLAN["flagship"]
    root = ROOT / "build" / "train_flagship"
    shutil.rmtree(root, ignore_errors=True)
    base = flagship_train_base(root)
    expected1, per = expected_es_launches(backend, suite, TrainConfig(**base), m)
    if (per["k3_per_call"], per["k1_per_call"], per["k2_per_call"], per["calls"]) != (164, 329, 0, pop * m):
        raise AssertionError(f"the flagship plan is not K3 164, K1 329 per image over {pop * m} images: {per}")
    state, h1, l1, wall1, e1 = _train(torch, backend, suite, TrainConfig(num_epochs=4, **base), expected1,
                                      "4 flagship run_training epochs")
    run_dir = root / "flagship"
    slot = run_dir / "ckpt" / "step_00000004"
    if [h["epoch"] for h in h1] != [0, 1, 2, 3] or state.epoch != 4 or not slot.is_dir():
        raise AssertionError(f"the 4-epoch run logged {[h['epoch'] for h in h1]}, ended at {state.epoch}")
    # the first run's trace: the JAX span tree, the pop evaluator's body run at its build only (the warm-up
    # and the capture)
    events = [e for e in load_events(run_dir) if e["session"] == 0]
    spans = span_tree_check(events, TRAIN_SPANS, "the traced flagship run_training")
    pops = {(e["attrs"]["pop"], e["attrs"]["member_batch"]) for e in events if e["name"] == "trace/pop_eval"}
    compiles = [e["attrs"] for e in events if e["name"] == "compile"]
    pop_eval_traces = read_jsonl_rows(run_dir / "metrics.jsonl")[3].get("obs/pop_eval_traces")
    if pops != {(pop, mb)} or compiles != [{"m": m, "r": 1}] or spans["trace/pop_eval"] != 2 or \
            pop_eval_traces != 2 or spans["epoch"] != 4 or spans["dispatch"] != 4:
        raise AssertionError(f"the flagship trace: trace/pop_eval {pops} x{spans['trace/pop_eval']}, compile "
                             f"{compiles}, obs/pop_eval_traces {pop_eval_traces}, spans {spans}")
    manifest = json.loads((slot / "manifest.json").read_text())
    with np.load(slot / "theta.npz") as z:
        slot_theta = {k: z[k] for k in z.files}
    bad = [k for k, a in slot_theta.items()
           if hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() != manifest["arrays"][k]["sha256"]]
    final = _cpu_tree(torch, state.theta)
    if bad or any(not np.array_equal(final[k.rsplit("/", 1)[0]][k.rsplit("/", 1)[1]].numpy(), a)
                  for k, a in slot_theta.items()):
        raise AssertionError(f"slot step_00000004 disagrees with its manifest ({bad[:3]}) or with the run's θ")
    digest = CheckpointStore(run_dir).verify_slot(4, state.theta)
    if digest != slot_theta_digest(manifest):
        raise AssertionError("the slot's read-back digest differs from its manifest's")

    seen = {}
    state2, h2, l2, wall2, e2 = _train(torch, backend, suite, TrainConfig(num_epochs=5, resume=True, **base), expected1,
                                   "the resumed flagship run",
                                   spy=lambda e, th: seen.setdefault(e, _cpu_tree(torch, th)))
    if list(seen) != [4] or [h["epoch"] for h in h2] != [4] or state2.epoch != 5:
        raise AssertionError(f"the resumed run ran epochs {list(seen)}, logged {[h['epoch'] for h in h2]}")
    if any(not np.array_equal(seen[4][k.rsplit("/", 1)[0]][k.rsplit("/", 1)[1]].numpy(), a)
           for k, a in slot_theta.items()):
        raise AssertionError("the resumed run did not start from the epoch-4 slot's θ bitwise")
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    if [r["epoch"] for r in rows] != [0, 1, 2, 3, 4] or \
            not all(len(r.get("quality/combined/prompt_mean", [])) == m for r in rows):
        raise AssertionError(f"metrics.jsonl rows {[r['epoch'] for r in rows]} lack quality/combined/prompt_mean")

    state3, h3, l3, wall3, e3 = _train(torch, backend, suite,
                                       TrainConfig(num_epochs=1, **{**base, "quality": False, "save_every": 0,
                                                                    "run_name": "flagship_quality_off"}),
                                       expected1, "a flagship epoch with quality off")
    if any(k.startswith("quality/") for k in h3[0]):
        raise AssertionError("quality=False still logged quality/* metrics")
    telemetry = telemetry_run(torch, backend, suite, base, expected1, es["epoch_s"],
                              [h["step_time_s"] for h in h1[1:]])
    saves = [(ev["session"], ev["dur_s"]) for ev in load_events(run_dir) if ev["name"] == "checkpoint"]
    step_s = [h["step_time_s"] for h in h1 + h2]
    # the traced run's replayed epochs against the bare step's spread in this call (PERF.md §2)
    spread = (min(es["epoch_s"]), max(es["epoch_s"]))
    replayed = [h["step_time_s"] for h in h1[1:]]
    within = [spread[0] <= t <= spread[1] for t in replayed]
    log(f"[train] the traced run's span tree is the JAX package's ({spans}); trace/pop_eval (pop {pop}) twice "
        f"in compile, obs/pop_eval_traces {pop_eval_traces}; replayed epochs "
        f"{', '.join(f'{t:.4f}' for t in replayed)} s against the bare step's {spread[0]:.4f}-{spread[1]:.4f} s: "
        f"inside {within}")
    slot_mb = sum(p.stat().st_size for p in slot.iterdir()) / 2**20
    log(f"[train] flagship run_training (int8 base, quality on): epochs {', '.join(f'{s:.3f}' for s in step_s)} s "
        f"step_time_s (epoch 4 resumed; quality off: {h3[0]['step_time_s']:.3f} s) against the bare step's "
        f"{', '.join(f'{s:.3f}' for s in es['epoch_s'])} s (warm-up {es['warmup_epoch_s']:.3f} s) in this call; "
        f"checkpoint saves (session, s): {saves}; slot {slot_mb:.2f} MiB; runs {wall1:.2f} / {wall2:.2f} / "
        f"{wall3:.2f} s wall; launches counted {l1} / {l2} / {l3} over {e1} / {e2} / {e3} eager epochs")
    torch.cuda.empty_cache()
    return dict(step_time_s=step_s, step_time_s_quality_off=h3[0]["step_time_s"], bare_epoch_s=es["epoch_s"],
                checkpoint_save_s=[d for _, d in saves], slot_mib=slot_mb, wall_s=[wall1, wall2, wall3],
                launches=[l1, l2, l3], epochs=[len(h1), len(h2), len(h3)], eager_epochs=[e1, e2, e3],
                images_per_epoch=pop * m, spans=spans, pop_eval_traces=pop_eval_traces,
                traced_within_bare_spread=within,
                slot_digest=digest, telemetry=telemetry)


def phase_train_artifacts(torch, backend, suite):
    """The trainer's artifacts and profile window at the flagship
    (``RUNG_PLAN``/``RUNG_OPT["flagship"]``: int8 base, ``pop_fuse``, K3 and
    K1), on :func:`phase_es_flagship`'s backend: ``run_training`` for
    ``ART_EPOCHS`` epochs with ``log_hist_every`` 1, ``log_images_every`` and
    ``snapshot_every`` 2 and ``profile_epochs`` ``ART_PROFILE_EPOCHS``.
    Checks: every row's ``hist/*`` (64 bins, 4 scores, Δθ counted), ``mfu``
    and ``roofline/bound``; the best, median and worst strips (4 × 256 by
    256 pixels) of epochs 1 and 3 and two snapshot grids; epoch 3's best
    member regenerated twice on the card bitwise equal, and its strip's
    pixels (read back by ``utils.images.read_png``) equal to ``make_prompt_strip`` of
    that regeneration; the graph's pool unchanged by the regenerations;
    one ``programs.jsonl`` record with counted FLOPs and bytes;
    ``CALIB_train.json`` with the plan's row measured from the profile and
    K1 and K3 in its kernel evidence at the derived counts (the wrappers'
    counters over the window's eager work, the warm-up epoch and epoch 1's
    regenerations, plus one replayed epoch, which runs the warm-up's
    launches); ``QUALITY_train.json`` with a curve of every epoch over the
    calibrated device seconds; no ``cleanup_errors``; the final θ through
    ``export_peft_adapter`` read back (``weights.io``) equal to its factors
    transposed, bitwise."""
    import shutil

    import numpy as np

    from hyperscalees_t2i_tpu_torch.obs.calib import load_calib
    from hyperscalees_t2i_tpu_torch.obs.trace import load_events
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.checkpoints import export_peft_adapter
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils.graphs import pool_bytes
    from hyperscalees_t2i_tpu_torch.utils.images import make_prompt_strip
    from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
    from hyperscalees_t2i_tpu_torch.weights.io import load_state_dict

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    root = ROOT / "build" / "train_artifacts"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainConfig(num_epochs=ART_EPOCHS, pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m,
                     batches_per_gen=1, member_batch=mb, reward_tile=opt["reward_tile"],
                     noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"],
                     base_quant=opt["base_quant"], quality=True, save_every=0, log_hist_every=1, log_images_every=2,
                     snapshot_every=2, profile_epochs=ART_PROFILE_EPOCHS, run_dir=str(root), run_name="artifacts",
                     trace=True)
    expected1, _ = expected_es_launches(backend, suite, tc, m)
    last = ART_EPOCHS - 1
    caches, counted, before_last = [], {}, {}
    real = trainer.make_es_step

    def spying_make(*a, **kw):
        step = real(*a, **kw)
        caches.append(step.graphs)

        def spied(theta, prev_delta, flat_ids, key, *rest, **kwr):
            if torch.equal(key, trainer.epoch_key(tc.seed, last, key.device)):  # θ before the last epoch
                before_last.update({k: {f: t.detach().clone() for f, t in d.items()} for k, d in theta.items()})
            return step(theta, prev_delta, flat_ids, key, *rest, **kwr)

        spied.graphs = step.graphs
        return spied

    # the window's close, timed: the profiler's stop, the trace's export, the calibration
    close_s = {}
    real_stop, real_calibrate = trainer.stop_profile, trainer._calibrate

    def timed_stop(prof, path):
        t = time.perf_counter()
        prof.stop()
        close_s["stop_s"] = time.perf_counter() - t
        path.parent.mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        prof.export_chrome_trace(str(path))
        close_s["export_s"] = time.perf_counter() - t
        return path

    def timed_calibrate(*a, **kw):
        t = time.perf_counter()
        real_calibrate(*a, **kw)
        close_s["calibrate_s"] = time.perf_counter() - t

    trainer.make_es_step, trainer.stop_profile, trainer._calibrate = spying_make, timed_stop, timed_calibrate
    try:
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        state = trainer.run_training(backend, suite, tc, device="cuda",
                                     on_epoch_end=lambda e, s: counted.setdefault(e, _counters()))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        trainer.make_es_step, trainer.stop_profile, trainer._calibrate = real, real_stop, real_calibrate
    run_dir = root / "artifacts"
    rows = read_jsonl_rows(run_dir / "metrics.jsonl")
    if [r["epoch"] for r in rows] != list(range(ART_EPOCHS)) or counted.get(0) != expected1:
        raise AssertionError(f"artifacts run: rows {[r['epoch'] for r in rows]}, warm-up launches {counted.get(0)} "
                             f"(expected {expected1})")
    for r in rows:
        bad = [k for k in ("hist/theta", "hist/delta_theta") if len(r.get(k, {}).get("counts", [])) != 64]
        if bad or len(r.get("hist/pop_scores", [])) != pop or not sum(r["hist/delta_theta"]["counts"]) > 0:
            raise AssertionError(f"epoch {r['epoch']}: hist keys {bad} lack 64 bins, or pop_scores / Δθ is off")
        if not (isinstance(r.get("mfu"), float) and r.get("roofline/bound") in ("compute", "bandwidth", "latency")):
            raise AssertionError(f"epoch {r['epoch']}: mfu {r.get('mfu')}, roofline/bound {r.get('roofline/bound')}")
    if rows[-1].get("obs/cleanup_errors", 0) != 0:
        raise AssertionError(f"a best-effort step failed: obs/cleanup_errors {rows[-1]['obs/cleanup_errors']}")

    # strips and snapshots; epoch 3's best member regenerated on the card
    strips = {}
    for e in (1, 3):
        files = {p.name.split("_")[0]: p for p in (run_dir / f"epoch_{e:04d}").glob("*.png")}
        shapes = {k: read_png(p).shape for k, p in files.items()}
        if set(files) != {"best", "median", "worst"} or set(shapes.values()) != {(256, 256 * m, 3)}:
            raise AssertionError(f"epoch_{e:04d}: strips {shapes}")
        strips[e] = files
    grids = sorted((run_dir / "snapshots").glob("*.png"))
    if len(grids) != 2 or any(read_png(g).shape != (256, 256 * m, 3) for g in grids):
        raise AssertionError(f"snapshots: {[g.name for g in grids]}")
    best = int(strips[3]["best"].name.split("_member")[1].split("_")[0])
    info = backend.step_info(last, m, 1)
    (entry,) = [e for c in caches for e in c.entries.values()]
    graph_pool = pool_bytes(entry.captured.replay.__self__.pool())
    _reset_counters()
    t0 = time.perf_counter()
    regen = [trainer.regenerate_member_images(backend, before_last, tc, last, best, info) for _ in range(2)]
    regen_s = (time.perf_counter() - t0) / 2
    regen_launches = {k: v // 2 for k, v in _counters().items()}
    if not np.array_equal(regen[0], regen[1]):
        raise AssertionError("epoch 3's best member regenerated twice differs")
    strip_png = read_png(strips[3]["best"])
    if not np.array_equal(strip_png, make_prompt_strip(list(regen[0]), m)):
        raise AssertionError("the best strip's pixels differ from make_prompt_strip of the regeneration")
    if graph_pool != entry.stats.pool_bytes:
        raise AssertionError(f"the graph's pool holds {graph_pool} bytes, {entry.stats.pool_bytes} at its capture")

    # the ledger, the calibration and the quality artifact
    (rec,) = [json.loads(x) for x in (run_dir / "programs.jsonl").read_text().splitlines()]
    if not (rec["label"] == f"es_step_m{m}r1" and rec["flops"] > 0 and rec["bytes_accessed"] > 0):
        raise AssertionError(f"programs.jsonl: {rec}")
    payload = load_calib(run_dir / "CALIB_train.json")
    (row,) = [r for r in payload["rows"] if r["key"] == f"train/es_step_m{m}r1"]
    window_eager = counted[ART_PROFILE_EPOCHS - 1]
    want = {k: window_eager[k] + expected1[k] * (ART_PROFILE_EPOCHS - 1) for k in expected1}
    evidence = {k: v["events"] for k, v in payload["kernel_evidence"].items()}
    if row["measured_source"] != "profile" or evidence != want:
        raise AssertionError(f"CALIB_train.json: {row['measured_source']} row, kernel evidence {evidence} "
                             f"(expected {want})")
    quality = json.loads((run_dir / "QUALITY_train.json").read_text())
    if len(quality["curve"]) != ART_EPOCHS or quality["device_s_source"] != "calib":
        raise AssertionError(f"QUALITY_train.json: {len(quality['curve'])} points, {quality['device_s_source']}")

    # the final θ as a PEFT adapter, read back
    export_peft_adapter(run_dir / "peft", state.theta, rank=backend.cfg.lora_r, alpha=backend.cfg.lora_alpha,
                        module_name_fn=lambda p, i: p.replace("/", ".") + ("" if i is None else f".{i}"))
    sd = load_state_dict(run_dir / "peft" / "adapter_model.safetensors")
    final = _cpu_tree(torch, state.theta)
    n_checked = 0
    for path, d in final.items():
        a, b = d["a"].numpy(), d["b"].numpy()
        layers = [(f".{i}", a[i], b[i]) for i in range(a.shape[0])] if a.ndim == 3 else [("", a, b)]
        for suffix, ai, bi in layers:
            name = f"base_model.model.{path.replace('/', '.')}{suffix}"
            want_a = ai.transpose(3, 2, 0, 1) if ai.ndim == 4 else ai.T
            want_b = bi.T[:, :, None, None] if ai.ndim == 4 else bi.T
            if not (np.array_equal(sd[f"{name}.lora_A.weight"], want_a)
                    and np.array_equal(sd[f"{name}.lora_B.weight"], want_b)):
                raise AssertionError(f"PEFT export of {name} differs from θ's factors transposed")
            n_checked += 1
    if n_checked * 2 != len(sd):
        raise AssertionError(f"the PEFT file holds {len(sd)} tensors, θ {n_checked} factor pairs")

    spans = {}
    for ev in load_events(run_dir):
        spans.setdefault(ev["name"], []).append(ev["dur_s"])
    window_s = sum(ev["dur_s"] for ev in load_events(run_dir)
                   if ev["name"] == "epoch" and ev.get("attrs", {}).get("epoch", 99) < ART_PROFILE_EPOCHS)
    trace_mib = sum(p.stat().st_size for p in (run_dir / "profile").glob("*")) / 2**20
    out = dict(
        step_time_s=[r["step_time_s"] for r in rows], mfu=[r["mfu"] for r in rows],
        roofline=[{k: r.get(f"roofline/{k}") for k in ("bound", "intensity", "t_compute_s", "t_bandwidth_s",
                                                        "t_roofline_s")} for r in rows],
        record={k: rec[k] for k in ("flops", "bytes_accessed", "intensity", "counted_ops", "kernels", "warmup_s",
                                    "capture_s", "instantiate_s", "pool_bytes")},
        calib_row=row, kernel_evidence=evidence, quality={k: quality.get(k) for k in (
            "device_s_total", "device_s_source", "final_reward", "reward_per_device_s")},
        span_s={k: v for k, v in spans.items() if k in ("hist", "strip", "snapshot", "dispatch", "epoch")},
        window_s=window_s, window_close_s=close_s, trace_mib=trace_mib, wall_s=wall_s, regen_s=regen_s, regen_launches=regen_launches,
        launches_by_epoch=counted, graph_pool_bytes=graph_pool, peft_tensors=len(sd),
        launches={k: counted[last][k] for k in expected1},
    )
    log(f"[train-artifacts] flagship run_training, {ART_EPOCHS} epochs (hist every 1, strips and snapshots every 2, "
        f"profile window {ART_PROFILE_EPOCHS}): step_time_s {', '.join(f'{s:.3f}' for s in out['step_time_s'])}; "
        f"mfu {', '.join(f'{u:.4f}' for u in out['mfu'])}; roofline {[x['bound'] for x in out['roofline']]} "
        f"(intensity {rows[-1]['roofline/intensity']:.1f} FLOP/B, t_roofline {rows[-1]['roofline/t_roofline_s']:.4f} s); "
        f"counted {rec['flops'] / 1e12:.2f} TFLOP, {rec['bytes_accessed'] / 1e9:.2f} GB over {rec['counted_ops']} "
        f"ops an epoch (warm-up {rec['warmup_s']:.2f} s); calib measured {row['measured_s']:.4f} s over "
        f"{row['occurrences']} dispatches against predicted {row['predicted_s']:.4f} s: measured/predicted "
        f"{row['error_ratio']:.2f}, mfu measured {row['mfu_measured']:.4f}, claimed {row['mfu_claimed']:.4f}")
    log(f"[train-artifacts] seconds: hist {spans.get('hist')}, strip {spans.get('strip')}, snapshot "
        f"{spans.get('snapshot')}, profile window (epochs 0-{ART_PROFILE_EPOCHS - 1}) {window_s:.2f} s (closing it: "
        f"{ {k: round(v, 2) for k, v in close_s.items()} }), trace {trace_mib:.1f} MiB, run {wall_s:.2f} s wall; one regeneration {regen_s:.3f} s, launches {regen_launches}; "
        f"kernel evidence {evidence} = window's eager {window_eager} + a replay {expected1}; graph pool "
        f"{graph_pool / 2**30:.2f} GiB unchanged; QUALITY {out['quality']}; PEFT {len(sd)} tensors read back bitwise")
    torch.cuda.empty_cache()
    return out


def phase_train_chained(torch, suite):
    """Chained dispatch at the flagship: ``run_training`` on the flagship
    rung with its DiT cut to ``FLAGSHIP_CUT_LAYERS`` of 20 blocks
    (:func:`cut_flagship_backend`; the flagship reward suite ``suite``),
    ``CHAINED_EPOCHS`` epochs with
    ``steps_per_dispatch`` 1 and then ``CHAINED_EPOCHS - 1`` (quality on, no
    slots or histograms due): the chained run logs its first epoch and its
    last, with ``epochs_chained`` [1, CHAINED_EPOCHS - 1], and ends at the
    unchained run's θ bitwise, its last row's scores equal; each run's
    counted K1/K3 launches the derived counts × its one eager epoch (the
    program's warm-up; the others are replays)."""
    import shutil

    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    root = ROOT / "build" / "train_chained"
    shutil.rmtree(root, ignore_errors=True)
    backend = cut_flagship_backend(torch, FLAGSHIP_CUT_LAYERS, opt["base_quant"])
    last, chain = CHAINED_EPOCHS - 1, CHAINED_EPOCHS - 1
    base = dict(num_epochs=CHAINED_EPOCHS, pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, batches_per_gen=1,
                member_batch=mb, reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"],
                tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"], base_quant=opt["base_quant"],
                quality=True, save_every=0, log_hist_every=0, resume=False, run_dir=str(root))
    expected1, _ = expected_es_launches(backend, suite, TrainConfig(**base), m)
    runs = {}
    for spd in (1, chain):
        state, hist, launches, wall, eager_epochs = _train(
            torch, backend, suite, TrainConfig(steps_per_dispatch=spd, run_name=f"spd{spd}", **base), expected1,
            f"flagship run_training, steps_per_dispatch={spd}")
        runs[spd] = dict(theta=_cpu_tree(torch, state.theta), rows={h["epoch"]: h for h in hist}, launches=launches,
                         eager_epochs=eager_epochs, wall_s=wall, step_time_s=[h["step_time_s"] for h in hist],
                         epochs_chained=[h["epochs_chained"] for h in hist], epochs=[h["epoch"] for h in hist])
        torch.cuda.empty_cache()
    one, four = runs[1], runs[chain]
    if four["epochs"] != [0, last] or four["epochs_chained"] != [1, chain] or \
            one["epochs"] != list(range(CHAINED_EPOCHS)):
        raise AssertionError(f"chain layout: epochs {four['epochs']}, epochs_chained {four['epochs_chained']}")
    theta_diff = max(float((four["theta"][k][f] - one["theta"][k][f]).abs().max())
                     for k in one["theta"] for f in one["theta"][k])
    score_keys = ("opt_score_mean", "theta_norm", "delta_norm", "es/update_cosine")
    row_diff = max(abs(four["rows"][last][k] - one["rows"][last][k]) for k in score_keys)
    if theta_diff != 0.0 or row_diff != 0.0:
        raise AssertionError(f"steps_per_dispatch {chain} against 1: θ differs by {theta_diff}, epoch {last}'s "
                             f"scores by {row_diff}")
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-chained] flagship run_training at {FLAGSHIP_CUT_LAYERS} of 20 blocks, {CHAINED_EPOCHS} epochs: "
        f"steps_per_dispatch 1 step_time_s "
        f"{', '.join(f'{t:.3f}' for t in one['step_time_s'])} ({one['wall_s']:.2f} s wall); steps_per_dispatch {chain} "
        f"{', '.join(f'{t:.3f}' for t in four['step_time_s'])} (epochs_chained {four['epochs_chained']}, "
        f"{four['wall_s']:.2f} s wall); θ and epoch {last}'s scores bitwise equal; launches counted {one['launches']} / "
        f"{four['launches']} over {one['eager_epochs']} / {four['eager_epochs']} eager epochs")
    return {spd: {k: v for k, v in r.items() if k not in ("theta", "rows")} for spd, r in runs.items()}


def phase_dispatch_tax(torch, backend, suite):
    """``tools/dispatch_tax.py`` at the flagship rung on the backend
    :func:`phase_es_flagship` built: its row (eager, single, chained, fused,
    fused_qlora, fleet2)."""
    from hyperscalees_t2i_tpu_torch.tools import dispatch_tax

    # one timed step a variant: the whole script's time limit holds the Z-Image phases too
    row = dispatch_tax.run("flagship", steps=1, chain=3, device="cuda", built=(backend, suite))
    torch.cuda.empty_cache()
    log(f"[dispatch-tax] {json.dumps(row)}")
    if not row.get("fleet2_amortization"):
        raise AssertionError(f"dispatch_tax gave no fleet2 row: {row}")
    log(f"[dispatch-tax] fleet2 at the flagship: two jobs through one W=2 program "
        f"{row['step_time_fleet2_fused_s']:.4f} s a tick, through one solo program one after the other "
        f"{row['step_time_fleet2_sequential_s']:.4f} s; fleet2_amortization {row['fleet2_amortization']}")
    return row


def train_overhead(torch, pairs: int = 8):
    """The training loop's host cost at the flagship, in turns on one card
    (not part of :func:`main`): an epoch of the bare stateful step (host
    clock to a synchronize, as :func:`timed_epochs`), then its scalars'
    fetch to the host alone, and one ``run_training`` epoch resumed from
    the previous one's slot (its ``step_time_s``), alternating which goes
    first; the first pair warms up. Prints both series, the fetch times
    and the difference of the medians."""
    import shutil
    import statistics

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils import threefry

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    root = ROOT / "build" / "train_overhead"
    shutil.rmtree(root, ignore_errors=True)
    base = dict(pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, member_batch=mb,
                reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"],
                pop_fuse=opt["pop_fuse"], base_quant=opt["base_quant"], save_every=1, run_dir=str(root),
                run_name="overhead")
    backend, suite = build_train_backend("flagship", device="cuda", seed=0)
    step = trainer.make_es_step(backend, suite, TrainConfig(**base), m, 1, device="cuda", stateful_delta=True)
    flat = backend.step_info(0, m, 1).flat_ids
    theta = backend.init_theta(threefry.prng_key(1, "cuda"))
    delta = {k: {f: torch.zeros_like(t) for f, t in d.items()} for k, d in theta.items()}
    bare, fetch, loop = [], [], []
    for i in range(pairs + 1):
        for which in ((0, 1) if i % 2 == 0 else (1, 0)):
            if which == 0:
                t0 = time.perf_counter()
                theta, delta, metrics, _ = step(theta, delta, flat, epoch_key(0, 100 + i, "cuda"))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                {k: (v.tolist() if v.ndim else float(v)) for k, v in metrics.items()}
                t2 = time.perf_counter()
                if i:
                    bare.append(t1 - t0)
                    fetch.append(t2 - t1)
            else:
                history = []
                trainer.run_training(backend, suite, TrainConfig(num_epochs=i + 1, **base),
                                     on_epoch_end=lambda e, s: history.append(s), device="cuda")
                if [h["epoch"] for h in history] != [i]:
                    raise AssertionError(f"run {i} logged epochs {[h['epoch'] for h in history]}")
                if i:
                    loop.append(history[0]["step_time_s"])
    med = statistics.median
    out = dict(bare_epoch_s=bare, loop_epoch_s=loop, fetch_s=fetch, median_difference_s=med(loop) - med(bare),
               median_fetch_s=med(fetch), pairs=pairs)
    log(f"[train-overhead] in turns, {pairs} pairs: bare step {', '.join(f'{s:.3f}' for s in bare)} s "
        f"(median {med(bare):.4f}); run_training {', '.join(f'{s:.3f}' for s in loop)} s (median {med(loop):.4f}); "
        f"difference of medians {out['median_difference_s'] * 1e3:.1f} ms; scalar fetch after a synchronize "
        f"{med(fetch) * 1e3:.2f} ms (median)")
    print(json.dumps({"train_overhead": out}))
    return out


def kernel_checks_once(torch, phases: str = "k1,chain,k4,k4inf,inf"):
    """K1-K4's checks against their plain versions (``phase_k1_check``,
    ``phase_chain_check``, ``phase_k4_check``, ``phase_k4_infinity``,
    ``phase_inf_kernel_check``)
    untimed (``timed=False``: each timed function called once, no CUDA
    events, no profiler): the form that runs under
    ``compute-sanitizer`` (not part of :func:`main`). Build first, outside
    the tool, then run e.g. ``compute-sanitizer --tool memcheck python3 -c
    "import torch, chip_smoke; chip_smoke.kernel_checks_once(torch, 'k1')"``."""
    run = {"k1": phase_k1_check, "chain": phase_chain_check, "k4": phase_k4_check, "k4inf": phase_k4_infinity,
           "inf": phase_inf_kernel_check}
    for name in phases.split(","):
        run[name](torch, timed=False)
        torch.cuda.synchronize()
        log(f"[checks-once] {name}: passed")


def _k4_inputs(torch, g, B, nq, L, H, dh, dt, kv_len=None):
    """Main-path-like K4 inputs: unit-norm keys, queries of norm 4 (QK-l2
    with the initial log-4 scale), normal values; the cache past ``kv_len``
    holds NaN, which the kernel must never read."""
    from hyperscalees_t2i_tpu_torch.models.nn import l2_normalize

    q = (l2_normalize(torch.randn(B, nq, H, dh, generator=g, device="cuda")) * 4.0).to(dt)
    k = l2_normalize(torch.randn(B, L, H, dh, generator=g, device="cuda")).to(dt)
    v = torch.randn(B, L, H, dh, generator=g, device="cuda").to(dt)
    if kv_len is not None and kv_len < L:
        k[:, kv_len:] = float("nan")
        v[:, kv_len:] = float("nan")
    return q, k, v


def _plain_rows(torch, q, k, v, kv_len, mask, sm_scale, max_logit_bytes=3e9):
    """K4's plain version over row chunks whose f32 logits stay under
    ``max_logit_bytes``: the same function (rows are independent), without
    Infinity-2B's 2.5 GB-a-row logits at its last scale all on the card."""
    from hyperscalees_t2i_tpu_torch.ops.attention import naive_masked_attention

    B, nq, H, _ = q.shape
    kv = k.shape[1] if kv_len is None else kv_len
    step = max(1, min(B, int(max_logit_bytes // (nq * H * kv * 4))))
    return torch.cat([naive_masked_attention(q[r:r + step], k[r:r + step], v[r:r + step], kv_len,
                                             None if mask is None else mask[r:r + step], sm_scale)
                      for r in range(0, B, step)])


def _k4_row(torch, g, tag, *, B, nq, L, kv, H, dh, dt_name, mask=None, reps=20, **row):
    """One K4 shape on main-path-like inputs (:func:`_k4_inputs`, NaN past
    ``kv``; ``mask [B, kv]`` the key mask or None): error against the plain
    version (:func:`_plain_rows`), kernel / plain / SDPA ms by ``time_ms``,
    the kernel's and the plain version's ``device_ms``, the wrapper's
    ``host_us`` and the bound, over enough input sets to hold 100 MB. The
    bytes and operations count only the (row, key) pairs the mask lets
    through. Returns the row dict, ``row`` merged in."""
    import torch.nn.functional as F

    from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention

    dt = getattr(torch, dt_name)
    needed = B * kv if mask is None else int(mask[:, :kv].sum())  # (row, key) pairs the softmax keeps
    nbytes = (2 * B * nq * H * dh + 2 * needed * H * dh) * dt.itemsize + (0 if mask is None else B * kv)
    flop = 4.0 * needed * nq * H * dh
    sets = [_k4_inputs(torch, g, B, nq, L, H, dh, dt, kv) for _ in range(max(1, min(8, math.ceil(100e6 / nbytes))))]
    kernel_fns = [lambda s=s: decode_attention(s[0], s[1], s[2], kv_len=kv, kv_mask=mask, sm_scale=1.0) for s in sets]
    plain_fns = [lambda s=s: _plain_rows(torch, s[0], s[1], s[2], kv, mask, 1.0) for s in sets]
    sdpa_mask = None if mask is None else mask[:, None, None, :kv]
    lib_fns = [lambda s=s: F.scaled_dot_product_attention(
        s[0].transpose(1, 2), s[1][:, :kv].transpose(1, 2), s[2][:, :kv].transpose(1, 2), attn_mask=sdpa_mask,
        scale=1.0) for s in sets]
    out = kernel_fns[0]()
    torch.cuda.synchronize()
    err, tol, ref_max = check_close(f"decode_attention {tag} nq={nq} kv={kv} {dt_name}", out, plain_fns[0](),
                                    dt_name, torch, again=lambda: (kernel_fns[0](), plain_fns[0]()))
    del out
    ms, plain, lib = (time_ms(torch, fns, reps) for fns in (kernel_fns, plain_fns, lib_fns))
    dev_ms = device_ms(torch, kernel_fns, reps, "decode_attention")
    plain_dev_ms = device_ms(torch, plain_fns, reps)
    h_us = host_us(torch, kernel_fns, reps)
    b_ms, b_by = bound(dt_name, flop, nbytes)
    log(f"[k4] {tag} nq={nq:4d} kv={kv:4d} B={B} dh={dh} {dt_name:8s} err={err:.3g} rel={err / ref_max:.3g} "
        f"ms={ms:.4f} plain={plain:.4f} library={lib:.4f} bound={b_ms:.4f} ({b_by}) device_ms={dev_ms:.4f} "
        f"plain_device_ms={plain_dev_ms:.4f} host_us={h_us:.1f} {nbytes / dev_ms / 1e6:.1f} GB/s (device)" +
        (f"; before {row['before_ms']:.4f}" if "before_ms" in row else ""))
    return dict(nq=nq, kv_len=kv, B=B, H=H, dh=dh, dtype=dt_name, max_abs_err=err, tol=tol, ref_max=ref_max,
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by, device_ms=dev_ms,
                plain_device_ms=plain_dev_ms, host_us=h_us, gbytes_s=nbytes / ms / 1e6, **row)


def phase_k4_check(torch, timed: bool = True):
    """K4 at the VAR-d16 scale shapes (bf16, the main path, and f32) by
    :func:`_k4_row`, beside the bf16 rows ``K4_BEFORE_MS``; then the cases
    off the main path (masked dh-128 cross-attention, a multi-tile kv prefix
    with ragged query tiles, an all-masked row)."""
    from hyperscalees_t2i_tpu_torch.ops.attention import decode_attention, naive_masked_attention

    g = torch.Generator(device="cuda").manual_seed(777)
    B, H, dh, L = VAR_ROWS, VAR_HEADS, VAR_DH, sum(p * p for p in VAR_PATCH_NUMS)
    rows, pos = [], 0
    for si, pn in enumerate(VAR_PATCH_NUMS):
        nq, kv = pn * pn, pos + pn * pn
        pos = kv
        for dt_name in ("bfloat16", "float32"):
            main = dt_name == "bfloat16"
            before = dict(before_ms=K4_BEFORE_MS[si]) if main else {}
            rows.append(_k4_row(torch, g, f"VAR-d16 scale {si}", B=B, nq=nq, L=L, kv=kv, H=H, dh=dh,
                                dt_name=dt_name, site=f"scale {si} (pn {pn})", main_path=main,
                                calls_per_call=VAR_DEPTH if main else 0, reps=20 if timed else 0, **before))

    extra = []
    for name, (Bx, nq, L2, Hx, dhx, kv, lens) in (
        ("masked cross-attention dh 128", (4, 256, 512, 16, 128, 512, (512, 300, 77, 1))),
        ("multi-tile kv, ragged q tiles", (3, 100, 1200, 4, 64, 1000, None)),
        ("all-masked row", (2, 9, 96, 2, 64, 70, (70, 0))),
    ):
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            q, k, v = _k4_inputs(torch, g, Bx, nq, L2, Hx, dhx, dt, kv)
            mask = None
            if lens is not None:
                mask = torch.arange(L2, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
            out = decode_attention(q, k, v, kv_len=kv, kv_mask=mask, sm_scale=1.0 / math.sqrt(dhx))
            torch.cuda.synchronize()
            ref = naive_masked_attention(q, k, v, kv, mask, 1.0 / math.sqrt(dhx))
            err, tol, _ = check_close(f"decode_attention {name} {dt_name}", out, ref, dt_name, torch)
            if lens is not None and 0 in lens:  # JAX's answer: a uniform average of V over the prefix
                row = lens.index(0)
                uni = v[row, :kv].float().mean(dim=0)[None].expand(nq, Hx, dhx)
                check_close(f"decode_attention all-masked row {dt_name}", out[row], uni, dt_name, torch)
            extra.append(dict(case=name, dtype=dt_name, max_abs_err=err, tol=tol))
            log(f"[k4] {name:32s} {dt_name:8s} err={err:.3g} (tol {tol:.3g})")
    torch.cuda.empty_cache()
    return rows, extra


def phase_k4_invariance(torch):
    """Bitwise invariance of K4's bf16 route at VAR-d16's last scale (32
    rows, 256 queries, 680 keys, dh 64) and at Infinity-2B's scale 12 (8
    rows, 2304 queries, 5355 keys of a 9451-position cache, dh 128): a row
    range, a query range off the query tiles' grid, a query range the plan
    tiles otherwise and a single query, each alone, against the same
    outputs of the full call. Raises on any difference."""
    from hyperscalees_t2i_tpu_torch.ops.attention import _plan, decode_attention

    g = torch.Generator(device="cuda").manual_seed(96)
    n_parts = 0
    for name, rows, nq, kv, L, H, dh, parts in (
        ("VAR-d16 scale 9", VAR_ROWS, VAR_PATCH_NUMS[-1] ** 2, sum(p * p for p in VAR_PATCH_NUMS),
         sum(p * p for p in VAR_PATCH_NUMS), VAR_HEADS, VAR_DH,
         (("rows 5:9", slice(5, 9), slice(None)), ("queries 37:137", slice(None), slice(37, 137)),
          ("queries 0:36", slice(None), slice(0, 36)), ("query 200", slice(None), slice(200, 201)))),
        ("Infinity-2B scale 12", INF_ROWS, INF_PATCH_NUMS[12] ** 2, sum(p * p for p in INF_PATCH_NUMS[:13]),
         sum(p * p for p in INF_PATCH_NUMS), INF_HEADS, INF_DH,
         (("rows 3:5", slice(3, 5), slice(None)), ("queries 100:1000", slice(None), slice(100, 1000)),
          ("queries 0:40", slice(None), slice(0, 40)), ("query 2303", slice(None), slice(2303, 2304)))),
    ):
        q, k, v = _k4_inputs(torch, g, rows, nq, L, H, dh, torch.bfloat16, kv)
        full = decode_attention(q, k, v, kv_len=kv, sm_scale=1.0)
        plans = [("full", _plan(nq, kv, dh, torch.bfloat16).rows)]
        for what, rs, qs in parts:
            part = decode_attention(q[rs, qs], k[rs], v[rs], kv_len=kv, sm_scale=1.0)
            if not torch.equal(part, full[rs, qs]):
                diff = float((part.float() - full[rs, qs].float()).abs().max())
                raise AssertionError(f"decode_attention {what} alone differs from the full {name} call "
                                     f"(max abs {diff})")
            plans.append((what, _plan(part.shape[1], kv, dh, torch.bfloat16).rows))
        torch.cuda.synchronize()
        log(f"[k4] invariance: {len(plans) - 1} parts of the {name} call bitwise equal to it alone; "
            f"(part, rows per block): {plans}")
        n_parts += len(plans) - 1
        del q, k, v, full
    return n_parts


def k4_tile_sweep(torch, geometry: str = "var"):
    """Every rows-per-block and ring depth of K4's bf16 route at each scale
    of the VAR-d16 self-attention (``geometry="var"``: 32 rows, dh 64) or
    Infinity-2B's (``"infinity"``: 8 rows, dh 128, a 9451-position cache),
    by device time (``device_ms``): the numbers behind
    ``ops.attention._plan``'s rule (PERF.md). Launched by the wrapper's own
    ``_launch`` with the plan overridden (not counted); each must give
    bitwise the planned output. Not part of ``main``; run it after
    ``phase_build``."""
    from hyperscalees_t2i_tpu_torch.ops import attention as at

    g = torch.Generator(device="cuda").manual_seed(79)
    patch_nums, B, H, dh = {"var": (VAR_PATCH_NUMS, VAR_ROWS, VAR_HEADS, VAR_DH),
                            "infinity": (INF_PATCH_NUMS, INF_ROWS, INF_HEADS, INF_DH)}[geometry]
    L = sum(p * p for p in patch_nums)
    out, pos = [], 0
    for si, pn in enumerate(patch_nums):
        nq, kv = pn * pn, pos + pn * pn
        pos = kv
        nbytes = 2 * (2 * B * nq * H * dh + 2 * B * kv * H * dh)
        sets = [_k4_inputs(torch, g, B, nq, L, H, dh, torch.bfloat16, kv)
                for _ in range(max(1, min(8, math.ceil(100e6 / nbytes))))]
        plan = at._plan(nq, kv, dh, torch.bfloat16)
        ref = at.decode_attention(sets[0][0], sets[0][1], sets[0][2], kv_len=kv, sm_scale=1.0)
        times = {}
        for rows in (16, 32, 64, 128):
            for stages in (2, 3):
                outs = [torch.empty_like(s[0]) for s in sets]

                def call(i, p=plan._replace(rows=rows, stages=stages)):
                    at._launch(sets[i][0], sets[i][1], sets[i][2], None, outs[i], kv, 1.0, p)
                call(0)
                torch.cuda.synchronize()
                if not torch.equal(outs[0], ref):
                    raise AssertionError(f"K4 at {rows} rows, {stages} stages differs bitwise from the plan at "
                                         f"scale {si}")
                times[f"{rows}x{stages}"] = device_ms(torch, [lambda i=i: call(i) for i in range(len(sets))], 20,
                                                      "decode_attention")
        planned = f"{plan.rows}x{plan.stages}"
        out.append(dict(geometry=geometry, scale=si, nq=nq, kv_len=kv, plan=planned, device_ms=times))
        log(f"[k4-tiles] {geometry} scale {si} nq={nq:4d} kv={kv:4d} plan={planned} (rows x stages); device ms: " +
            " ".join(f"{name}={ms:.4f}" for name, ms in times.items()))
        del sets
    return out


def inf_text_mask(torch):
    """The main path's cross-attention key mask ``[8, 17]``: epoch 0's four
    prompts of the ``inf_2b`` run (``step_info(0, 4, 1)`` over
    ``BENCH_PROMPT_SET`` with hash-fallback text, prompt ``i``'s last ``i %
    3`` positions padded), the null token first, rows ``[cond | uncond]``
    as ``models.infinity.generate`` builds them (an uncond row sees only the
    null token)."""
    from hyperscalees_t2i_tpu_torch.backends.base import default_step_info
    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import hash_text_features
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_PLAN

    _, _, m, _ = RUNG_PLAN["inf_2b"]
    ids = default_step_info(0, len(BENCH_PROMPT_SET), m, 1).flat_ids
    _, text = hash_text_features(BENCH_PROMPT_SET, 1, torch.device("cpu"))
    cond = torch.cat([torch.ones(m, 1, dtype=torch.bool), text[ids]], dim=1)
    uncond = torch.zeros_like(cond)
    uncond[:, 0] = True
    return torch.cat([cond, uncond]).cuda()


INF_K4_REPS = 3  # phase_k4_infinity's timed repetitions a row


def phase_k4_infinity(torch, timed: bool = True):
    """K4 at the Infinity-2B shapes of its main path (bf16, its 8 rows) by
    :func:`_k4_row`: at each of the 14 scales, the dh-128 self-attention
    against the cache prefix (NaN past ``kv_len``) and the masked
    cross-attention into the 17 text positions under the main path's own
    mask (:func:`inf_text_mask`)."""
    g = torch.Generator(device="cuda").manual_seed(778)
    L = sum(p * p for p in INF_PATCH_NUMS)
    text_mask = inf_text_mask(torch)
    rows, pos = [], 0
    for si, pn in enumerate(INF_PATCH_NUMS):
        nq, kv = pn * pn, pos + pn * pn
        pos = kv
        for site in ("self", "cross"):
            cache, kvl, mask = (L, kv, None) if site == "self" else (INF_TEXT, INF_TEXT, text_mask)
            rows.append(_k4_row(torch, g, f"Infinity-2B {site} scale {si}", B=INF_ROWS, nq=nq, L=cache, kv=kvl,
                                H=INF_HEADS, dh=INF_DH, dt_name="bfloat16", mask=mask,
                                site=f"{site} scale {si} (pn {pn})", attention=site, main_path=True,
                                calls_per_call=INF_DEPTH, reps=INF_K4_REPS if timed else 0))
        torch.cuda.empty_cache()
    return rows


def phase_inf_reference(torch):
    """The tiny Infinity geometry in f32 on the card against the CPU, on the
    same weights, once with the released attention flags off and once on
    (QK-l2, 2D RoPE, QK-l2 cross-attention), with per-scale cfg/τ lists: one
    ``generate`` (two lanes with different adapters, injected Gumbel
    noise): bits equal, images within 1e-4; one ES step (pop 4, member_batch
    2): θ′ and reward rows within 1e-4; K4 launches exactly 2 × scales ×
    depth per generate call in both."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.lora import stack_adapters
    from hyperscalees_t2i_tpu_torch.models import clip, infinity as inf_mod
    from hyperscalees_t2i_tpu_torch.rewards.suite import clip_text_embed_table, make_clip_reward_fn
    from hyperscalees_t2i_tpu_torch.rungs import PROMPT_TOKEN_LEN, infinity_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    spec = infinity_rung_model("tiny")
    ccfg = spec["clip_b"]
    prompts = ["a red square", "a blue circle", "a green cat", "a woman reading"]
    pop, m, mb = 4, 4, 2
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb)
    results = {}
    for variant, flags in (("plain", {}), ("released", dict(attn_l2_norm=True, use_rope2d=True,
                                                             cross_attn_l2_norm=True))):
        bcfg = dataclasses.replace(spec["bcfg"], model=dataclasses.replace(spec["bcfg"].model, **flags),
                                   cfg_list=(3.0, 2.0), tau_list=(0.7,))
        kp, kc, ki = threefry.split(threefry.prng_key(41, "cpu"), 3)
        params = inf_mod.init_infinity(bcfg.model, kp)
        cparams = clip.init_clip(ccfg, kc)
        tids = threefry.randint(ki, (len(prompts) + 2, PROMPT_TOKEN_LEN), 0, ccfg.vocab_size)
        with torch.inference_mode():
            table = clip_text_embed_table(clip.CLIPModel(ccfg, cparams), tids)
        outs, launches = {}, {}
        for dev in (torch.device("cpu"), torch.device("cuda")):
            on = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
            backend = InfinityBackend(bcfg, dev, params=on(params), prompts=prompts)
            backend.setup()
            suite = RecordingReward(make_clip_reward_fn(clip.CLIPModel(ccfg, on(cparams)), table.to(dev)),
                                    -(-pop // mb))
            if dev.type == "cpu":
                gen = torch.Generator().manual_seed(42)
                thetas = []
                for i in range(2):
                    th = backend.init_theta(threefry.fold_in(threefry.prng_key(42, "cpu"), i))
                    thetas.append({k: {f: v + 0.1 * torch.randn(v.shape, generator=gen) for f, v in d.items()}
                                   for k, d in th.items()})
                # two lanes' Gumbel noise, drawn on the CPU so both devices sample from the same numbers
                lanes_noise = backend.sample_gen_noise(threefry.split(threefry.prng_key(44, "cpu")), range(2))
                theta = thetas[0]
                noise = sample_noise(threefry.prng_key(43, "cpu"), theta, pop, tc.es_config())
                flat = backend.step_info(0, m, 1).flat_ids
                gen_noise = backend.sample_gen_noise(threefry.prng_key(45, "cpu"), range(len(flat)))
            else:
                torch.cuda.synchronize()
                _reset_counters()
            with torch.inference_mode(), _RecordCalls(inf_mod, "sample_bits") as rec:
                images = backend.generate_p(on(stack_adapters(thetas)), [[0, 1], [2, 3]], None,
                                            noise=lanes_noise.to(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                launches["generate"] = _counters()
                _reset_counters()
            step = make_es_step(backend, suite, tc, m, 1, device=dev)
            theta_new, metrics, _ = step(theta, flat, threefry.prng_key(0, dev), noise=noise, gen_noise=gen_noise)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                launches["step"] = _counters()
            rows = reward_rows(torch, suite.rows, 1, len(flat))
            outs[dev.type] = (images.float().cpu(), torch.cat([b.reshape(-1) for b in rec.outs]),
                              tree_map(lambda a: a.float().cpu(), theta_new), rows.float().cpu(),
                              float(metrics["delta_norm"]))
            del backend, suite, step
        per_call = 2 * len(bcfg.model.patch_nums) * bcfg.model.depth
        expected = {"generate": {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0, "decode_attention": per_call},
                    "step": {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0,
                             "decode_attention": -(-pop // mb) * per_call}}
        img_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
        bits_equal = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        th_err = max(float((outs["cuda"][2][k][f] - outs["cpu"][2][k][f]).abs().max())
                     for k in outs["cpu"][2] for f in outs["cpu"][2][k])
        row_err = float((outs["cuda"][3] - outs["cpu"][3]).abs().max())
        log(f"[inf-tiny] {variant} attention: generate, 2 lanes × 2 images, card vs CPU: bits equal {bits_equal} "
            f"({outs['cpu'][1].numel()} bits), images max abs diff {img_err:.3g} (tol 1e-4); ES step: θ′ "
            f"{th_err:.3g}, reward rows {tuple(outs['cuda'][3].shape)} {row_err:.3g} (tol 1e-4), ‖Δθ‖ "
            f"{outs['cuda'][4]:.4g} (CPU {outs['cpu'][4]:.4g}); launches {launches} expected {expected}")
        if not bits_equal or not img_err <= 1e-4:
            raise AssertionError(f"card and CPU disagree on the tiny Infinity generate ({variant}): bits equal "
                                 f"{bits_equal}, images {img_err}")
        if tuple(outs["cuda"][3].shape) != (pop, len(flat)) or not (th_err <= 1e-4 and row_err <= 1e-4):
            raise AssertionError(f"card and CPU disagree on the tiny Infinity ES step ({variant}): θ′ {th_err}, "
                                 f"rows {row_err}")
        if not outs["cuda"][4] > 0:
            raise AssertionError("the tiny Infinity ES step made no update")
        if launches != expected:
            raise AssertionError(f"tiny Infinity ({variant}) launched {launches}, expected {expected}")
        results[variant] = {"images_max_abs": img_err, "bits_equal": bits_equal, "bits": int(outs["cpu"][1].numel()),
                            "theta_max_abs": th_err, "rows_max_abs": row_err, "delta_norm": outs["cuda"][4],
                            "launches": launches}
    torch.cuda.empty_cache()
    return results


def expected_inf_launches(backend, reward, tc, batch: int):
    """K1-K4 launches of one Infinity ES step, derived from the module
    trees. A generate → decode → reward call runs each adapted block site
    once a scale (``cross_kv`` once a call): with ``pop_fuse`` K3 over an
    int8 node and K2 over a float one; without it K1 over an int8 node (the
    adapter's delta in plain torch) and nothing over a float one. K1 also
    at every other int8 matmul: ``text_proj`` and ``pool_proj`` once a call,
    ``head_ada`` (the head's AdaLN of a converted checkpoint) once a call,
    ``head`` once a scale, ``word_embed`` once a scale but the last, the BSQ
    decoder's int8 1×1 convs and the towers' image sides once a call
    (``ada_lin`` dequantizes in plain torch; ``reward=None``: generation
    alone). K4 twice a layer a scale. Returns ``(per epoch, per call)`` as
    :func:`expected_es_launches`."""
    model = backend.model
    S, depth = len(model.cfg.patch_nums), model.cfg.depth
    modules = dict(model.named_modules())
    adapted = model.lora_sites()
    k1 = k2 = k3 = 0
    for name in adapted:
        per = 1 if name.endswith("cross_kv") else S
        if hasattr(modules[name], "q8"):
            k3, k1 = (k3 + per, k1) if tc.pop_fuse else (k3, k1 + per)
        elif tc.pop_fuse:
            k2 += per
    once = {"text_proj": 1, "pool_proj": 1, "head_ada": 1, "head": S, "word_embed": S - 1}
    for name, mod in modules.items():
        if name in adapted or name == "ada_lin" or not hasattr(mod, "q8"):
            continue
        if name not in once and not name.startswith("vq.decoder."):
            raise AssertionError(f"an int8 matmul module {name} that the launch count does not know")
        k1 += once.get(name, 1)
    for tower in (reward.clip_model, reward.pick_model) if reward is not None else ():
        if tower is not None:
            image_side = [tower.patch_embed, tower.vision, tower.visual_projection]
            k1 += sum(1 for part in image_side for m in part.modules() if hasattr(m, "q8"))
    k4 = 2 * S * depth
    calls = reward_calls(tc, batch)
    return ({"int8_matmul": k1 * calls, "lora_chain": k2 * calls, "fused_qlora": k3 * calls,
             "decode_attention": k4 * calls},
            {"k1_per_call": k1, "k2_per_call": k2, "k3_per_call": k3, "k4_per_call": k4, "calls": calls})


def _inf_cli_args(root, name: str, epochs: int, *extra: str):
    """The train CLI's settings of the ``inf_2b`` run (pop 4, 4 prompts,
    member_batch 1, ``epochs`` epochs, the rung's towers), plus ``extra``
    flags."""
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train import cli

    _, pop, m, mb = RUNG_PLAN["inf_2b"]
    return cli.build_parser().parse_args([
        "--backend", "infinity", "--pop_size", str(pop), "--prompts_per_gen", str(m), "--member_batch", str(mb),
        "--num_epochs", str(epochs), "--run_dir", str(root), "--run_name", name, "--resume", "false",
        "--tower_dtype", rung_opt("inf_2b")["tower_dtype"], *extra])


def _recording_make(trainer, steps):
    """``trainer.make_es_step`` that keeps every step it makes in ``steps``."""
    real = trainer.make_es_step

    def make(*a, **kw):
        steps.append(real(*a, **kw))
        return steps[-1]

    return real, make


# profiled epochs that _graph_run and timed_epochs may take to hold the
# device's launch count to the derived one. The first is the measured one:
# its busy ms, idle share, in-situ ms and top kernels are kept whatever it
# counted. The profiler has dropped a stretch of kernel records from a
# replay twice (74 of a Sana epoch's 2,160 K1, one CLIP-B call's; 133 of
# the flagship ES epoch's 5,264 K1; cause not found), which a replay of the
# same graph cannot do, so a miss runs the same epoch again under the
# profiler to count its launches only; every attempt's count is logged and
# returned
PROFILE_ATTEMPTS = 3


def _graph_run(torch, backend, suite, tc, weights_bytes: int, what: str, against_eager: bool = False,
               bitwise: bool = False, expected=None):
    """``run_training`` of a backend as a CUDA graph (:func:`_train`: the
    warm-up epoch counted by the wrappers), then one replayed epoch under
    ``torch.profiler`` whose K1-K4 on the device must be the derived counts
    (``expected(backend, suite, tc, batch)``, :func:`expected_inf_launches`
    by default; busy ms, idle share against the replayed epochs'
    ``step_time_s``). With ``against_eager``, the same step run eagerly
    (``GraphCache(graph=False)``) first, from the same θ, Δθ, ids and key:
    its launches counted by the wrappers, and the replay's θ′, Δθ, metrics,
    scores and reward rows equal to its outputs bitwise (``bitwise``), or
    else within 1e-4 with the difference recorded. Memory as
    ``weights_bytes`` (allocated after the build), the KV workspace and the
    graph's pool apart. Returns ``(state, numbers)``."""
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.parallel.pop_eval import effective_reward_tile
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves, tree_map

    m = tc.prompts_per_gen
    tile = effective_reward_tile(m, tc.reward_tile) or m
    expected1, per = (expected or expected_inf_launches)(backend, suite, tc, m)
    reward = RecordingReward(suite, per["calls"])
    steps = []
    real, trainer.make_es_step = _recording_make(trainer, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, history, launches, wall_s, eager_epochs = _train(torch, backend, reward, tc, expected1, what)
    finally:
        trainer.make_es_step = real
    run_peak = torch.cuda.max_memory_allocated()
    graph = next(iter(steps[0].graphs.stats().values()))
    step_s = [h["step_time_s"] for h in history]
    if len(step_s) != tc.num_epochs or eager_epochs != 1 or not all(math.isfinite(h["theta_norm"]) for h in history):
        raise AssertionError(f"{what}: {len(step_s)} epochs, {eager_epochs} eager, θ norms "
                             f"{[h['theta_norm'] for h in history]}")
    # θ sits on theta_max_norm from epoch 0, so only ‖Δθ‖ shows an update
    if not all(math.isfinite(h["delta_norm"]) and h["delta_norm"] > 0 for h in history):
        raise AssertionError(f"{what} made no update: ‖Δθ‖ {[h['delta_norm'] for h in history]}")

    def outputs(th, dl, metrics, opt_scores):
        return dict(theta=_clone_tree(th), delta=_clone_tree(dl), metrics={k: t.clone() for k, t in metrics.items()},
                    opt_scores=opt_scores.clone(), rows=reward_rows(torch, reward.rows, m // tile, tile).float().clone())

    ids = torch.as_tensor(backend.step_info(tc.num_epochs, m, 1).flat_ids, device="cuda")
    theta = _clone_tree(state.theta)
    delta = tree_map(torch.zeros_like, theta)
    key = epoch_key(tc.seed, 200, "cuda")
    turns = {}
    if against_eager:
        eager = trainer.make_es_step(backend, reward, tc, m, 1, "cuda", stateful_delta=True,
                                     graphs=GraphCache("cuda", graph=False))
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        x = outputs(*eager(theta, delta, ids, key))
        torch.cuda.synchronize()
        turns = dict(eager_epoch_s=time.perf_counter() - t0, eager_launches=_counters())
        del eager
        if turns["eager_launches"] != expected1:
            raise AssertionError(f"{what}: the eager epoch counted {turns['eager_launches']}, expected {expected1}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    def profiled_replay():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05)  # the trace may open late (as device_ms finds): let it open before the first launch
            ev[0].record()
            out = steps[0](theta, delta, ids, key)
            ev[1].record()
            torch.cuda.synchronize()
        return out, device_kernels(torch, prof)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    out, (kernels, busy, n_kernels, top) = profiled_replay()
    g = outputs(*out)
    replay_peak = torch.cuda.max_memory_allocated()
    prof_stats = dict(busy_ms=busy, kernels=n_kernels, event_ms=ev[0].elapsed_time(ev[1]),
                      launches=profiled_launches(kernels), in_situ_ms=profiled_launches(kernels, what=0),
                      top_kernels=[dict(name=t, ms=m_, launches=c) for m_, c, t in top])
    attempts = [dict(launches=prof_stats["launches"], kernels=n_kernels)]
    while attempts[-1]["launches"] != expected1 and len(attempts) < PROFILE_ATTEMPTS:
        log(f"[{what}] the profiler saw {attempts[-1]['launches']} in profiled replay {len(attempts)} of "
            f"{PROFILE_ATTEMPTS} ({attempts[-1]['kernels']} kernels), expected {expected1}: replaying again to count")
        _, (k_again, _, n_again, _) = profiled_replay()
        attempts.append(dict(launches=profiled_launches(k_again), kernels=n_again))
    # the count the gate holds (the last replay's); the timings stay the first's
    prof_stats["attempts"], prof_stats["launches"] = attempts, attempts[-1]["launches"]
    if attempts[-1]["launches"] != expected1 or _counters() != {k: 0 for k in expected1}:
        raise AssertionError(f"{what}: profiled replayed epochs launched {[a['launches'] for a in attempts]} on the "
                             f"device (expected {expected1}) and {_counters()} through the wrappers (expected none)")
    if against_eager:
        pairs = [(a, b) for n in ("theta", "delta") for a, b in zip(tree_leaves(g[n]), tree_leaves(x[n]))]
        pairs += [(g["metrics"][k], x["metrics"][k]) for k in g["metrics"]]
        pairs += [(g["opt_scores"], x["opt_scores"]), (g["rows"], x["rows"])]
        turns["graph_vs_eager_max_abs"] = worst = max(_max_abs(a, b) for a, b in pairs)
        turns["graph_vs_eager_bitwise"] = worst == 0.0
        if not worst <= (0.0 if bitwise else 1e-4):
            raise AssertionError(f"{what}: graph and eager differ by {worst}")
    rows = g["rows"]
    if tuple(rows.shape) != (tc.pop_size, m) or not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"{what}: reward rows {tuple(rows.shape)} not [{tc.pop_size}, {m}] and finite")
    # run_training's replayed epochs; a one-epoch run (warm-up and capture
    # alone) has the profiled replay's CUDA-event time instead
    replayed = step_s[1:] or [prof_stats["event_ms"] / 1e3]
    prof_stats["idle_share"] = 1.0 - busy / (1e3 * statistics.mean(replayed))
    images = tc.pop_size * m
    memory = dict(weights_gib=weights_bytes / 2**30, workspace_gib=graph["workspace_bytes"] / 2**30,
                  pool_gib=graph["pool_bytes"] / 2**30, peak_allocated_gib=replay_peak / 2**30,
                  run_peak_allocated_gib=run_peak / 2**30, total_gib=(replay_peak + graph["pool_bytes"]) / 2**30)
    stats = dict(step_time_s=step_s, first_epoch_s=step_s[0], epoch_s=replayed, images_per_epoch=images,
                 images_per_s=[images / s for s in replayed], wall_s=wall_s, launches=launches,
                 eager_epochs=eager_epochs, launches_profiled=prof_stats["launches"],
                 expected_launches_per_epoch=expected1, per_call=per, graph=graph, memory=memory, profile=prof_stats,
                 reward_rows=rows.cpu().tolist(), theta_norm=[h["theta_norm"] for h in history],
                 delta_norm=[h["delta_norm"] for h in history], **turns)
    per_call_dev = {k: v // per["calls"] for k, v in prof_stats["launches"].items()}
    log(f"[{what}] run_training as a CUDA graph: epochs {', '.join(f'{t:.3f}' for t in step_s)} s (the first: "
        f"warm-up {graph['warmup_s']:.3f} s + capture {graph['capture_s']:.3f} s + instantiate "
        f"{graph['instantiate_s']:.3f} s) = {', '.join(f'{x:.3f}' for x in stats['images_per_s'])} images/s replayed; "
        f"a profiled replayed epoch busy {busy:.1f} ms over {n_kernels} kernels (K1-K4 in situ "
        f"{ {k: round(v, 1) for k, v in prof_stats['in_situ_ms'].items()} } ms), idle share "
        f"{prof_stats['idle_share']:.4f}; memory: weights {memory['weights_gib']:.2f} GiB, KV workspace "
        f"{memory['workspace_gib']:.2f}, pool {memory['pool_gib']:.2f}, peak allocated under replay "
        f"{memory['peak_allocated_gib']:.2f} (+ pool = {memory['total_gib']:.2f}); launches counted {launches} over "
        f"{eager_epochs} eager epoch, on the device a replayed epoch {prof_stats['launches']} = {per_call_dev} a "
        f"generate call (expected {per}); rows {tuple(rows.shape)}, delta_norm {stats['delta_norm']}" +
        (f"; the same epoch eager {turns['eager_epoch_s']:.3f} s (launches {turns['eager_launches']}), graph against "
         f"eager max abs {turns['graph_vs_eager_max_abs']:.3g}" if against_eager else ""))
    for m_, c, t in top[:8]:
        log(f"[{what}]   {m_:9.3f} ms {c:6d} launches  {t}")
    del steps, reward, g
    return state, stats


def inf_fused_call(torch, backend, tc, theta, ids, gen_noise):
    """One eager Infinity-2B generate call (decode included) over
    ``backend``'s base with ``pop_fuse``: member 0's factored adapter
    (``factored_member_theta``), the launch counters set to 0 just before
    and read just after; K2 (a float base) or K3 (int8) at every adapted
    block site a scale and K4 twice a layer a scale must be counted, as
    :func:`expected_inf_launches` derives them for the generation. Its time
    by CUDA events; images finite in [0, 1]."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.es.noiser import factored_member_theta, sample_noise
    from hyperscalees_t2i_tpu_torch.utils import threefry

    tcf = dataclasses.replace(tc, pop_fuse=True)
    _, per = expected_inf_launches(backend, None, tcf, len(ids))
    with torch.inference_mode():
        noise = sample_noise(threefry.prng_key(7, "cuda"), theta, tcf.pop_size, tcf.es_config())
        theta_k = factored_member_theta(theta, noise, 0, tcf.pop_size, tcf.es_config())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        _reset_counters()
        ev[0].record()
        images = backend.generate_p(theta_k, ids[None], None, noise=gen_noise[None])
        ev[1].record()
        torch.cuda.synchronize()
    counted = _counters()
    want = {"int8_matmul": per["k1_per_call"], "lora_chain": per["k2_per_call"], "fused_qlora": per["k3_per_call"],
            "decode_attention": per["k4_per_call"]}
    if counted != want:
        raise AssertionError(f"one pop_fuse generate call launched {counted}, expected {want}")
    if not (bool(torch.isfinite(images).all()) and float(images.min()) >= 0.0 and float(images.max()) <= 1.0):
        raise AssertionError("the pop_fuse generate call's images are not finite in [0, 1]")
    out = dict(ms=ev[0].elapsed_time(ev[1]), launches=counted, images=tuple(images.shape))
    log(f"[inf-fused] one eager Infinity-2B generate call with pop_fuse ({tuple(images.shape)}): {out['ms']:.1f} ms; "
        f"launches {counted} (expected {want})")
    return out


def phase_inf_es(torch):
    """Infinity-2B's ES run on the card: the ``inf_2b`` rung
    (``infinity_backend.build_train_backend("2b")``: 14 scales to
    1024×1024, the 32-bit tokenizer, released attention flags, bf16, random
    weights and the rung's reward suite, CLIP-B/32 and CLIP-H/14 at their
    published widths, from seed 0) with the train CLI's settings (a float
    base, no ``pop_fuse``) cut to ``INF_FLOAT_DEPTH`` of its 32 blocks (every
    width kept), then ``run_training`` as a CUDA graph for
    ``INF_FLOAT_EPOCHS`` epochs (pop 4, 4 prompts, member_batch 1), the
    first one the warm-up and capture (:func:`_graph_run`: K4 2 × 14 ×
    ``INF_FLOAT_DEPTH`` launches a generate call and nothing else of K1-K3, counted at the
    warm-up and on the device in a profiled replayed epoch, which must
    equal the same epoch run eagerly just before it, bitwise; K4's in-situ
    ms a call from that epoch's profile). θ₀'s norm (``fold_in(PRNGKey(seed),
    17)``, the JAX package's θ₀) beside ``theta_max_norm``. Then K2's
    Infinity path: one eager generate call over this bf16 base with
    ``pop_fuse`` (:func:`inf_fused_call`: K2 85 and K4 28 a block)."""
    import dataclasses
    import shutil

    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.es.caps import global_norm
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, infinity_rung_model, rung_opt
    from hyperscalees_t2i_tpu_torch.train import cli, trainer
    from hyperscalees_t2i_tpu_torch.utils import threefry

    scale, pop, m, mb = RUNG_PLAN["inf_2b"]
    opt = rung_opt("inf_2b")
    root = ROOT / "build" / "inf_es"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    args = _inf_cli_args(root, "inf_2b", INF_FLOAT_EPOCHS)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend, suite = build_train_backend(scale, device=dev, seed=0, depth=INF_FLOAT_DEPTH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if backend.cfg.model != dataclasses.replace(infinity_rung_model(scale)["bcfg"].model, depth=INF_FLOAT_DEPTH):
        raise AssertionError(f"the rung built {backend.cfg.model}, not the inf_2b model at depth {INF_FLOAT_DEPTH}")
    weights_bytes = torch.cuda.memory_allocated()
    mcfg = backend.cfg.model
    tc = cli.train_config(args)
    _, per = expected_inf_launches(backend, suite, tc, m)
    k4_call = 2 * len(INF_PATCH_NUMS) * INF_FLOAT_DEPTH
    if (per["k1_per_call"], per["k2_per_call"], per["k3_per_call"], per["k4_per_call"]) != (0, 0, 0, k4_call):
        raise AssertionError(f"the inf_2b float-base plan is not K4 {k4_call} alone a call: {per}")
    theta0_norm = float(global_norm(trainer._init_theta(backend, tc, dev)))
    log(f"[inf] Infinity-2B ES backend (depth {mcfg.depth}, d {mcfg.d_model}, {mcfg.n_heads} heads of "
        f"{mcfg.head_dim}, L {mcfg.seq_len}, {mcfg.vq.bits} bits, {mcfg.vq.grid}→"
        f"{mcfg.vq.grid * 2 ** (len(mcfg.vq.dec_ch) - 1)} px) built in {build_s:.1f} s (peak device memory "
        f"{build_peak_gib:.2f} GiB); device memory {weights_bytes / 2**30:.2f} GiB; {per['calls']} generate "
        f"calls per epoch of {mb} lane × {m} images × 2 (CFG) = {2 * mb * m} rows; K4 {per['k4_per_call']} per "
        f"call; θ₀ = init_theta(fold_in(PRNGKey({tc.seed}), 17)) norm {theta0_norm:.4f} against theta_max_norm "
        f"{tc.theta_max_norm}")
    state, run = _graph_run(torch, backend, suite, tc, weights_bytes, f"inf_2b_depth{INF_FLOAT_DEPTH}",
                            against_eager=True, bitwise=True)

    ids = torch.as_tensor(backend.step_info(0, m, 1).flat_ids, device=dev)
    if not torch.equal(backend.text_mask[ids], inf_text_mask(torch)[:m, 1:]):
        raise AssertionError("phase_k4_infinity's text mask is not the inf_2b run's")
    gen_noise = backend.sample_gen_noise(threefry.prng_key(6, dev), range(len(ids)))
    fused = inf_fused_call(torch, backend, tc, state.theta, ids, gen_noise)
    stats = dict(plan=dict(pop=pop, prompts=m, member_batch=mb, depth=INF_FLOAT_DEPTH, **opt), build_s=build_s,
                 built_gib=weights_bytes / 2**30, build_peak_gib=build_peak_gib, theta0_norm=theta0_norm,
                 theta_max_norm=tc.theta_max_norm, peak_mem_gib=run["memory"]["total_gib"],
                 per_call={"k4_per_call": per["k4_per_call"], "calls": per["calls"]},
                 k4_in_situ_ms_per_call=run["profile"]["in_situ_ms"]["decode_attention"] / per["calls"],
                 fused_call=fused, **{k: v for k, v in run.items() if k != "per_call"})
    del backend, suite, state
    gc.collect()  # the step's closures hold the backend (and its 19.8 GB workspace) in cycles
    torch.cuda.empty_cache()
    return stats


def phase_inf_q8_reference(torch):
    """The tiny Infinity geometry in f32 (the released attention flags,
    per-scale cfg/τ lists) with ``pop_fuse``, on the card against the CPU
    on the same weights: on the int8 base (``quantize_tree(min_size=512)``
    on both devices: the blocks, ``ada_lin`` and the decoder's wide convs
    int8, φ float; the reward tower's image side int8 after its text table,
    as the CLI does) and on the float base. One ES step each (pop 4,
    member_batch 2, the draws made on the CPU), eager on both devices so
    that every sampled bit is recorded: θ′ and reward rows within 1e-4;
    every bit equal, with the smallest gap between a bit's two ``lg +
    gumbel`` on the CPU beside the largest guided-logit difference between
    the devices (the gap must exceed it); the card's launches counted by
    the wrappers exactly as :func:`expected_inf_launches` derives them: K3,
    K1 and K4 on the int8 base, K2 and K4 on the float one."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import InfinityBackend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.models import clip, infinity as inf_mod
    from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
    from hyperscalees_t2i_tpu_torch.rewards.suite import clip_text_embed_table, make_clip_reward_fn
    from hyperscalees_t2i_tpu_torch.rungs import PROMPT_TOKEN_LEN, infinity_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    spec = infinity_rung_model("tiny")
    ccfg = spec["clip_b"]
    prompts = ["a red square", "a blue circle", "a green cat", "a woman reading"]
    pop, m, mb = 4, 4, 2
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb, pop_fuse=True)
    bcfg = dataclasses.replace(spec["bcfg"], model=dataclasses.replace(
        spec["bcfg"].model, attn_l2_norm=True, use_rope2d=True, cross_attn_l2_norm=True), cfg_list=(3.0, 2.0),
        tau_list=(0.7,))
    results = {}
    for base in ("int8", "float"):
        kp, kc, ki = threefry.split(threefry.prng_key(47, "cpu"), 3)
        params = inf_mod.init_infinity(bcfg.model, kp)
        cparams = clip.init_clip(ccfg, kc)
        tids = threefry.randint(ki, (len(prompts) + 2, PROMPT_TOKEN_LEN), 0, ccfg.vocab_size)
        with torch.inference_mode():
            table = clip_text_embed_table(clip.CLIPModel(ccfg, cparams), tids)
        if base == "int8":
            params, cparams = quantize_tree(params, 512), quantize_tree(cparams, 512)
        outs, launches, expected = {}, None, None
        for dev in (torch.device("cpu"), torch.device("cuda")):
            on = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
            backend = InfinityBackend(bcfg, dev, params=on(params), prompts=prompts)
            backend.setup()
            tower = make_clip_reward_fn(clip.CLIPModel(ccfg, on(cparams)), table.to(dev))
            if dev.type == "cpu":
                theta = backend.init_theta(threefry.prng_key(42, "cpu"))
                theta = {k: {f: v + 0.05 for f, v in d.items()} for k, d in theta.items()}
                noise = sample_noise(threefry.prng_key(43, "cpu"), theta, pop, tc.es_config())
                flat = backend.step_info(0, m, 1).flat_ids
                gen_noise = backend.sample_gen_noise(threefry.prng_key(45, "cpu"), range(len(flat)))
            expected, per = expected_inf_launches(backend, tower, tc, len(flat))
            suite = RecordingReward(tower, per["calls"])
            step = make_es_step(backend, suite, tc, m, 1, device=dev, graphs=GraphCache(dev, graph=False))
            torch.cuda.synchronize()
            _reset_counters()
            with _RecordCalls(inf_mod, "sample_bits") as rec:
                theta_new, metrics, _ = step(on(theta), flat, threefry.prng_key(0, dev), noise=on(noise),
                                             gen_noise=gen_noise.to(dev))
            torch.cuda.synchronize()
            if dev.type == "cuda":
                launches = _counters()
            outs[dev.type] = dict(theta=tree_map(lambda a: a.float().cpu(), theta_new),
                                  rows=reward_rows(torch, suite.rows, 1, len(flat)).float().cpu(),
                                  lg=torch.cat([lg.reshape(-1) for lg, _ in rec.ins]),
                                  z=torch.cat([(lg + gumbel).reshape(-1, 2) for lg, gumbel in rec.ins]),
                                  bits=torch.cat([b.reshape(-1) for b in rec.outs]),
                                  delta_norm=float(metrics["delta_norm"]))
            del backend, suite, step
        c, g = outs["cpu"], outs["cuda"]
        th_err = max(float((g["theta"][k][f] - c["theta"][k][f]).abs().max())
                     for k in c["theta"] for f in c["theta"][k])
        row_err = float((g["rows"] - c["rows"]).abs().max())
        bits_equal = bool(torch.equal(g["bits"], c["bits"]))
        logit_diff = float((g["lg"] - c["lg"]).abs().max())
        gap = float((c["z"][:, 1] - c["z"][:, 0]).abs().min())
        log(f"[inf-q8-tiny] {base} base, pop_fuse: ES step card vs CPU: θ′ {th_err:.3g}, reward rows "
            f"{tuple(g['rows'].shape)} {row_err:.3g} (tol 1e-4); bits equal {bits_equal} ({c['bits'].numel()} bits), "
            f"smallest gap {gap:.3g} against the largest logit difference {logit_diff:.3g}; ‖Δθ‖ {g['delta_norm']:.4g} "
            f"(CPU {c['delta_norm']:.4g}); launches {launches} expected {expected}")
        if not (bits_equal and gap > logit_diff):
            raise AssertionError(f"tiny Infinity {base} pop_fuse: bits equal {bits_equal}, gap {gap}, logit "
                                 f"difference {logit_diff}")
        if tuple(g["rows"].shape) != (pop, m) or not (th_err <= 1e-4 and row_err <= 1e-4) or not g["delta_norm"] > 0:
            raise AssertionError(f"tiny Infinity {base} pop_fuse: θ′ {th_err}, rows {row_err}, ‖Δθ‖ {g['delta_norm']}")
        kinds = ("fused_qlora", "int8_matmul") if base == "int8" else ("lora_chain",)
        if launches != expected or not all(expected[k] > 0 for k in kinds + ("decode_attention",)):
            raise AssertionError(f"tiny Infinity {base} pop_fuse launched {launches}, expected {expected}")
        results[base] = dict(theta_max_abs=th_err, rows_max_abs=row_err, bits_equal=bits_equal,
                             bits=int(c["bits"].numel()), smallest_gap=gap, logit_max_abs=logit_diff,
                             delta_norm=g["delta_norm"], launches=launches)
    torch.cuda.empty_cache()
    return results


def phase_inf_q8_es(torch):
    """Infinity-2B on the int8 base with ``pop_fuse``: the ``inf_2b`` rung
    built by ``build_train_backend("2b", base_quant="int8")`` (the generator
    tree, the BSQ tokenizer included, and both towers' image sides int8:
    φ stays float at 36,864 elements) cut to ``INF_Q8_DEPTH`` of its 32
    blocks (every width kept), the train CLI's settings with ``--pop_fuse
    true --base_quant int8``, ``run_training`` as a CUDA graph for
    ``INF_EPOCHS`` epochs, the first the warm-up and capture
    (:func:`_graph_run` with ``against_eager``: K3 6 × 14 × 8 + 8 = 680,
    K4 224 and K1 as the module tree gives them, per generate call, counted
    at the warm-up and on the device in a profiled replayed epoch, which
    must equal the same epoch run eagerly just before it, bitwise or within
    1e-4). Memory: weights, the KV workspace and the graph's pool apart.
    The 32-block int8 run is :func:`phase_weights_infinity`'s."""
    import shutil

    from hyperscalees_t2i_tpu_torch.backends.infinity_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train import cli

    scale, pop, m, mb = RUNG_PLAN["inf_2b"]
    root = ROOT / "build" / "inf_q8_es"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tc = cli.train_config(_inf_cli_args(root, "inf_2b_q8", INF_EPOCHS, "--pop_fuse", "true",
                                        "--base_quant", "int8"))
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backend, suite = build_train_backend(scale, device=dev, seed=0, base_quant="int8", depth=INF_Q8_DEPTH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated()
    _, per = expected_inf_launches(backend, suite, tc, m)
    S = len(INF_PATCH_NUMS)
    k3_call, k4_call = (6 * S + 1) * INF_Q8_DEPTH, 2 * S * INF_Q8_DEPTH
    if (per["k2_per_call"], per["k3_per_call"], per["k4_per_call"]) != (0, k3_call, k4_call) or not per["k1_per_call"]:
        raise AssertionError(f"the inf_2b int8 pop_fuse plan at {INF_Q8_DEPTH} blocks is not K3 {k3_call}, K4 "
                             f"{k4_call} and K1 a call: {per}")
    log(f"[inf-q8] Infinity-2B ES backend on the int8 base at {INF_Q8_DEPTH} of {INF_DEPTH} blocks built in "
        f"{build_s:.1f} s; device memory {weights_bytes / 2**30:.2f} GiB; per generate call K3 {per['k3_per_call']}, "
        f"K1 {per['k1_per_call']}, K4 {per['k4_per_call']}; {per['calls']} calls an epoch")
    state, run = _graph_run(torch, backend, suite, tc, weights_bytes, f"inf_2b_q8_depth{INF_Q8_DEPTH}",
                            against_eager=True)
    stats = dict(build_s=build_s, depth=INF_Q8_DEPTH, **run)
    del backend, suite, state
    gc.collect()  # the step's closures hold the backend (and its 19.8 GB workspace) in cycles
    torch.cuda.empty_cache()
    return stats


# Z-Image-Turbo's transformer at its released widths (Tongyi-MAI/Z-Image-Turbo,
# transformer/config.json: dim 3840, n_layers 30, n_heads 30, cap_feat_dim
# 2560; the SwiGLU hidden 10,240 = 8/3 · dim), the geometry the port's
# weights.zimage.infer_zimage_config reads from that checkpoint; the KL-VAE
# decoder at the widths the train CLI builds for a diffusers AutoencoderKL
# (blocks_per_stage 3, ch 512/512/256/128, 16 latent channels); 512×512
# images (latent 64: 1,024 image tokens beside 24 text tokens)
ZIMAGE_TURBO = dict(d_model=3840, n_layers=30, n_heads=30, caption_dim=2560, ff_ratio=8 / 3, in_channels=16,
                    patch_size=2, qk_norm=True)
ZIMAGE_VAE = dict(blocks_per_stage=3)
ZIMAGE_LATENT = 64
# the ES plan: pop 8 (antithetic), 2 prompts, one chunk of 8 lanes, r_l 8 on
# the transformer and r 4 on the decoder, noise f32, towers bf16, int8 base
ZIMAGE_POP, ZIMAGE_PROMPTS, ZIMAGE_MB = 8, 2, 8
ZIMAGE_EPOCHS = 2  # run_training epochs of phase_zimage_es, the first the warm-up and capture
# the ES run's depth, of Z-Image-Turbo's 30 blocks: its kernels' shapes and the
# per-layer work do not depend on it (phase_zimage_kernel_check keeps all 30)
ZIMAGE_ES_LAYERS = 6
ZIMAGE_TEXT = 24  # synthetic prompt positions (backends.zimage_backend.SYNTH_TEXT_LEN)


def zimage_geometry():
    """``(rows of a generate call, tokens a row, steps, d, hidden, layers)``
    of the :data:`ZIMAGE_TURBO` run."""
    d, L = ZIMAGE_TURBO["d_model"], ZIMAGE_TURBO["n_layers"]
    hid = round(d * ZIMAGE_TURBO["ff_ratio"])
    return ZIMAGE_MB * ZIMAGE_PROMPTS, (ZIMAGE_LATENT // 2) ** 2 + ZIMAGE_TEXT, 8, d, hid, L


def zimage_chain_sites():
    """K3's (int8 base) and K2's (bf16 base) adapted sites of a generate
    call: ``(site, K, N, calls a call)``, each once a layer a step on the
    chunk's 8 lanes × 2 images × 1,048 tokens."""
    _, _, steps, d, hid, L = zimage_geometry()
    return [("qkv", d, 3 * d, L * steps), ("attn_proj", d, d, L * steps), ("fc1", d, 2 * hid, L * steps),
            ("fc2", hid, d, L * steps)]


def zimage_k1_shapes():
    """K1's calls of one Z-Image generate → decode → reward call on the
    int8 base: ``(site, rows, K, N, dtype on the main path, calls)``. The
    DiT's int8 sites outside the blocks take f32 activations once a step,
    as in the JAX package (``ada_lin`` dequantizes one layer at a time in
    plain torch); the decoder's int8 1×1 convs (the mid attention's q/k/v
    and projection at 64², stage 2's 512 → 256 skip at 256²; stage 3's
    skip is below the floor, the 3×3 convs dequantize for cuDNN) and the
    bf16 towers' image sides once a call, over the call's 16 images."""
    R, _, steps, d, _, _ = zimage_geometry()
    n_img = (ZIMAGE_LATENT // 2) ** 2
    pp = 4 * ZIMAGE_TURBO["in_channels"]
    out = [("patch_embed", R * n_img, pp, d, "float32", steps),
           ("caption_proj", R * ZIMAGE_TEXT, ZIMAGE_TURBO["caption_dim"], d, "float32", steps),
           ("time_embed linear_1", R, 256, d, "float32", steps), ("time_embed linear_2", R, d, d, "float32", steps),
           ("final_ada", R, d, 2 * d, "float32", steps), ("proj_out", R * n_img, d, pp, "float32", steps),
           ("vae mid attention qkv", R * ZIMAGE_LATENT ** 2, 512, 1536, "bfloat16", 1),
           ("vae mid attention proj", R * ZIMAGE_LATENT ** 2, 512, 512, "bfloat16", 1),
           ("vae stage 2 skip", R * (4 * ZIMAGE_LATENT) ** 2, 512, 256, "bfloat16", 1)]
    out += [(site, R * T, din, dout, "bfloat16", es) for site, T, din, dout, _, _, es in K1_SHAPES
            if site.startswith("clip")]
    return out


def expected_zimage_launches(backend, reward, tc, batch: int):
    """K1-K3 launches of one Z-Image ES step, derived from the module trees.
    A generate → decode → reward call runs the DiT ``num_steps`` times
    (twice that under guidance): each adapted block site once a pass, K3
    over an int8 node with ``pop_fuse`` (K1 without it, the adapter's delta
    in plain torch), K2 over a float node with ``pop_fuse``; K1 at every
    other int8 dense module of the DiT once a pass (``ada_lin``
    dequantizes in plain torch), at every int8 1×1 conv of the decoder and
    the towers' image sides once a call (``reward=None``: generation and
    decode alone). No K4. Returns ``(per epoch, per call)``."""
    model = backend.model
    passes = backend.cfg.num_steps * (2 if backend.cfg.guidance_scale > 0 else 1)
    modules = dict(model.named_modules())
    adapted = model.lora_sites()
    k1 = k2 = k3 = 0
    for name in adapted:
        if hasattr(modules[name], "q8"):
            k3, k1 = (k3 + passes, k1) if tc.pop_fuse else (k3, k1 + passes)
        elif tc.pop_fuse:
            k2 += passes
    k1 += passes * sum(1 for n, mod in modules.items() if hasattr(mod, "q8") and n not in adapted and n != "ada_lin")
    if backend.vae is not None:
        k1 += sum(1 for mod in backend.vae.modules() if hasattr(mod, "q8"))
    for tower in (reward.clip_model, reward.pick_model) if reward is not None else ():
        if tower is not None:
            image_side = [tower.patch_embed, tower.vision, tower.visual_projection]
            k1 += sum(1 for part in image_side for mod in part.modules() if hasattr(mod, "q8"))
    calls = reward_calls(tc, batch)
    return ({"int8_matmul": k1 * calls, "lora_chain": k2 * calls, "fused_qlora": k3 * calls, "decode_attention": 0},
            {"k1_per_call": k1, "k2_per_call": k2, "k3_per_call": k3, "calls": calls, "dit_passes": passes})


def phase_zimage_kernel_check(torch, timed: bool = True):
    """K1, K2 and K3 at the Z-Image run's main-path shapes, in its dtypes,
    each against its plain version (bf16 within 2⁻⁷, f32 within 1e-5 of
    the largest output): K3 over an int8 base and K2 over a bf16 one at the
    four adapted block sites (:func:`zimage_chain_sites`) on one chunk's 8
    lanes of 2 × 1,048 rows (16,768 rows, K to 10,240, N to 20,480; each
    lane its own factored ``a_k``, ``b_k``), K1 at every int8 matmul site of
    a call (:func:`zimage_k1_shapes`: its f32 route at the DiT's embedders,
    ``final_ada`` and ``proj_out``). Per shape as
    :func:`phase_inf_kernel_check`: ``ms`` by CUDA events (K1 rotating over
    ≥ 100 MB of input and weight copies), the plain
    version's, ``device_ms`` under ``torch.profiler``, the library call's
    (K3: ``torch.matmul`` on the bf16 weight + ``baddbmm`` with each lane's
    prebuilt ``a_k``, ``b_k``; K2: two ``bmm``; K1: ``torch.matmul`` on the
    pre-dequantized weight) and the bound. Returns ``{"int8_matmul",
    "lora_chain", "fused_qlora": rows}`` with ``calls_per_call``."""
    from hyperscalees_t2i_tpu_torch.lora import effective_factor
    from hyperscalees_t2i_tpu_torch.ops.fused_lora import member_lora_delta, member_lora_delta_reference
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul, fused_qlora_reference
    from hyperscalees_t2i_tpu_torch.ops.quant_mm import int8_matmul, int8_matmul_reference

    g = torch.Generator(device="cuda").manual_seed(3840)
    rows = {"int8_matmul": [], "lora_chain": [], "fused_qlora": []}
    R, S, _, _, _, _ = zimage_geometry()
    lanes = ZIMAGE_MB
    T = R * S

    def weight(din, dout):
        q8 = torch.randint(-127, 128, (din, dout), generator=g, device="cuda", dtype=torch.int8)
        return q8, torch.rand(1, dout, generator=g, device="cuda") * (2.0 / (127 * math.sqrt(din)))

    def record(name, tag, site, T, din, dout, dt_name, calls, fns, flop, nbytes, marker, reps, **extra):
        kernel, plain, lib, again = fns  # kernel, plain, lib: one call for each input set
        out = kernel[0]()
        torch.cuda.synchronize()
        err, tol, ref_max = check_close(f"{name} at Z-Image {site} {T}x{din}x{dout} {dt_name}", out, plain[0](),
                                        dt_name, torch, again=again)
        del out
        ms = time_ms(torch, kernel, reps)
        plain_ms = time_ms(torch, plain, reps)
        lib_ms = time_ms(torch, lib, reps)
        dev_ms = device_ms(torch, kernel, reps, marker)
        b_ms, b_by = bound(dt_name, flop, nbytes)
        rows[name].append(dict(site=site, T=T, din=din, dout=dout, dtype=dt_name, main_path=True,
                               calls_per_call=calls, max_abs_err=err, tol=tol, ref_max=ref_max, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by,
                               tflops=flop / ms / 1e9 if reps else math.nan, **extra))
        log(f"[{tag}-zimage] {site:24s} T={T:7d} {din:5d}x{dout:5d} {dt_name:8s} calls {calls:4d} err={err:.3g} "
            f"rel={err / ref_max:.3g} ms={ms:.4f} plain={plain_ms:.4f} library={lib_ms:.4f} device_ms={dev_ms:.4f} "
            f"bound={b_ms:.4f} ({b_by})")

    # K3 and K2 at the adapted block sites, one chunk of 8 lanes: one input
    # set a shape, as each call reads 129-343 MB of bf16 activations and
    # writes 129-687 MB (beside 15-79 MB of s8 weights for K3), far more
    # than the 50 MB L2
    ndt = torch.float32
    for site, din, dout, calls in zimage_chain_sites():
        x = torch.randn(T, din, generator=g, device="cuda").to(torch.bfloat16)
        a, b = _factor(torch, g, din, R_L, ndt, lanes), _factor(torch, g, R_L, dout, ndt, lanes)
        q8, scale = weight(din, dout)
        w = (q8.float() * scale).to(torch.bfloat16)
        ak, bk = effective_factor(a, torch.bfloat16), effective_factor(b, torch.bfloat16)
        x3 = x.reshape(lanes, -1, din)
        fac_bytes = 4 * (din * R_L + R_L * dout) + lanes * (4 * (din + 2 * R_L + dout) * R_E + 8)
        chain_flop = 2.0 * T * ((din + dout) * (R_L + R_E) + 2 * R_L * R_E)
        k3_bytes = 2 * (T * din + T * dout) + din * dout + 4 * dout + fac_bytes
        k3 = lambda: fused_qlora_matmul(x, q8, scale, a, b, LORA_SCALE)  # noqa: E731
        k3p = lambda: fused_qlora_reference(x, q8, scale, a, b, LORA_SCALE)  # noqa: E731
        record("fused_qlora", "k3", site, T, din, dout, "bfloat16", calls,
               ([k3], [k3p], [lambda: torch.baddbmm(torch.matmul(x3, w), torch.bmm(x3, ak), bk, alpha=LORA_SCALE)],
                lambda: (k3(), k3p())),
               chain_flop + 2.0 * T * din * dout, k3_bytes, "::qlora_", _inf_reps(chain_flop + 2.0 * T * din * dout,
                                                                                  timed),
               noise_dtype="float32", lanes=lanes)
        k2 = lambda: member_lora_delta(x, a, b, LORA_SCALE)  # noqa: E731
        k2p = lambda: member_lora_delta_reference(x, a, b, LORA_SCALE)  # noqa: E731
        record("lora_chain", "k2", site, T, din, dout, "bfloat16", calls,
               ([k2], [k2p], [lambda: torch.bmm(torch.bmm(x3, ak), bk) * LORA_SCALE], lambda: (k2(), k2p())),
               chain_flop, 2 * (T * din + T * dout) + fac_bytes, "::lora_chain_", _inf_reps(chain_flop, timed),
               noise_dtype="float32", lanes=lanes)
        del x, x3, a, b, q8, scale, w, ak, bk
        torch.cuda.empty_cache()

    # K1 at the other int8 sites of a call on the int8 base, rotating over
    # ≥ 100 MB of input and weight copies (up to 128 sets) so that no site's
    # weights stay in the 50 MB L2 between calls, as on the main path
    for site, T1, din, dout, dt_name, calls in zimage_k1_shapes():
        dt = getattr(torch, dt_name)
        esize = dt.itemsize
        call_bytes = T1 * din * esize + din * dout + 4 * dout + T1 * dout * esize

        def make(T1=T1, din=din, dout=dout, dt=dt):
            x = torch.randn(T1, din, generator=g, device="cuda").to(dt)
            q8, scale = weight(din, dout)
            return dict(x=x, q8=q8, scale=scale, w=(q8.float() * scale).to(dt))

        sets = [make() for _ in range(max(1, min(128, math.ceil(100e6 / call_bytes))))]
        s0 = sets[0]
        k1 = lambda s: int8_matmul(s["x"], s["q8"], s["scale"])  # noqa: E731
        k1p = lambda s: int8_matmul_reference(s["x"], s["q8"], s["scale"])  # noqa: E731
        flop = 2.0 * T1 * din * dout
        record("int8_matmul", "k1", site, T1, din, dout, dt_name, calls,
               ([lambda s=s: k1(s) for s in sets], [lambda s=s: k1p(s) for s in sets],
                [lambda s=s: torch.matmul(s["x"], s["w"]) for s in sets], lambda: (k1(s0), k1p(s0))),
               flop, call_bytes, "::int8_mma_kernel" if dt_name == "bfloat16" else "::f32_", _inf_reps(flop, timed),
               input_sets=len(sets))
        del sets, s0
    torch.cuda.empty_cache()
    return rows


def _zimage_tiny(torch):
    """The tiny Z-Image backend config of the JAX CLI's ``--model_scale
    tiny`` geometry (f32, 2 Euler steps, latent 4, VAE LoRA on)."""
    from hyperscalees_t2i_tpu_torch.backends.zimage_backend import ZImageBackendConfig
    from hyperscalees_t2i_tpu_torch.models import vaekl, zimage

    f32 = torch.float32
    return ZImageBackendConfig(
        model=zimage.ZImageConfig(in_channels=4, d_model=24, n_layers=2, n_heads=2, caption_dim=12, ff_ratio=2.0,
                                  compute_dtype=f32),
        vae=vaekl.VAEDecoderConfig(latent_channels=4, ch=(8, 8), blocks_per_stage=1, compute_dtype=f32),
        num_steps=2, width_latent=4, height_latent=4, lora_r=2, lora_alpha=4.0, train_vae_decoder_lora=True)


def phase_zimage_reference(torch):
    """The tiny Z-Image geometry in f32 (:func:`_zimage_tiny`: the dual
    adapter, conv LoRA on the decoder) with ``pop_fuse`` on an int8 base
    (``quantize_tree(min_size=512)`` of both trees and of the reward
    tower's image side, after its text table), on the card against the CPU
    on the same weights. One ES step (pop 4, 3 prompts with synthetic ragged
    embeddings, 2 a step, member_batch 2, the draws made on the CPU), eager
    on both devices: θ′ (both adapters) and reward rows within 1e-4; the
    card's launches counted by the wrappers exactly as
    :func:`expected_zimage_launches` derives them (K3 and K1). Then the
    same step on the card as a CUDA graph (warm-up, capture, a replay):
    the replay's θ′ and rows equal to the eager step's, bitwise."""
    from hyperscalees_t2i_tpu_torch.backends.zimage_backend import ZImageBackend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.models import clip, vaekl, zimage
    from hyperscalees_t2i_tpu_torch.ops.quant import quantize_tree
    from hyperscalees_t2i_tpu_torch.rewards.suite import clip_text_embed_table, make_clip_reward_fn
    from hyperscalees_t2i_tpu_torch.rungs import PROMPT_TOKEN_LEN, infinity_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves, tree_map

    bcfg = _zimage_tiny(torch)
    ccfg = infinity_rung_model("tiny")["clip_b"]
    prompts = ["a red square", "a blue circle", "a green cat"]
    pop, m, mb = 4, 2, 2
    tc = TrainConfig(pop_size=pop, sigma=0.05, egg_rank=2, member_batch=mb, pop_fuse=True)
    kp, kv, kc, ki = threefry.split(threefry.prng_key(53, "cpu"), 4)
    params = quantize_tree(zimage.init_zimage(bcfg.model, kp), 512)
    vae = quantize_tree(vaekl.init_decoder(bcfg.vae, kv), 512)
    cparams = clip.init_clip(ccfg, kc)
    tids = threefry.randint(ki, (len(prompts) + 2, PROMPT_TOKEN_LEN), 0, ccfg.vocab_size)
    with torch.inference_mode():
        table = clip_text_embed_table(clip.CLIPModel(ccfg, cparams), tids)
    cparams = quantize_tree(cparams, 512)
    outs = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        on = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
        backend = ZImageBackend(bcfg, dev, params=on(params), vae_params=on(vae), prompts=prompts)
        backend.setup()
        tower = make_clip_reward_fn(clip.CLIPModel(ccfg, on(cparams)), table.to(dev))
        if dev.type == "cpu":
            theta = tree_map(lambda t: t + 0.05, backend.init_theta(threefry.prng_key(42, "cpu")))
            noise = sample_noise(threefry.prng_key(43, "cpu"), theta, pop, tc.es_config())
            flat = backend.step_info(0, m, 1).flat_ids
            gen_noise = backend.sample_gen_noise(threefry.prng_key(45, "cpu"), range(len(flat)))
        expected, per = expected_zimage_launches(backend, tower, tc, len(flat))
        suite = RecordingReward(tower, per["calls"])
        step = make_es_step(backend, suite, tc, m, 1, device=dev, graphs=GraphCache(dev, graph=False))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _reset_counters()
        theta_new, metrics, _ = step(on(theta), flat, threefry.prng_key(0, dev), noise=on(noise),
                                     gen_noise=gen_noise.to(dev))
        launches = _counters()
        outs[dev.type] = dict(theta=tree_map(lambda a: a.float().cpu(), theta_new),
                              rows=reward_rows(torch, suite.rows, 1, len(flat)).float().cpu(),
                              delta_norm=float(metrics["delta_norm"]), launches=launches, expected=expected)
        if dev.type == "cuda":
            graph = make_es_step(backend, suite, tc, m, 1, device=dev)
            for _ in range(2):  # the warm-up and capture, then a replay
                g_theta, _, _ = graph(on(theta), flat, threefry.prng_key(0, dev), noise=on(noise),
                                      gen_noise=gen_noise.to(dev))
            torch.cuda.synchronize()
            outs["graph"] = dict(theta=tree_map(lambda a: a.float().cpu(), g_theta),
                                 rows=reward_rows(torch, suite.rows, 1, len(flat)).float().cpu())
            del graph
        del backend, suite, step
    c, g, gr = outs["cpu"], outs["cuda"], outs["graph"]
    th_err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(g["theta"]), tree_leaves(c["theta"])))
    row_err = float((g["rows"] - c["rows"]).abs().max())
    graph_err = max([float((a - b).abs().max()) for a, b in zip(tree_leaves(gr["theta"]), tree_leaves(g["theta"]))]
                    + [float((gr["rows"] - g["rows"]).abs().max())])
    log(f"[zimage-tiny] int8 base, pop_fuse, VAE LoRA: ES step card vs CPU: θ′ {th_err:.3g}, reward rows "
        f"{tuple(g['rows'].shape)} {row_err:.3g} (tol 1e-4); the card's graph against its eager step "
        f"{graph_err:.3g}; ‖Δθ‖ {g['delta_norm']:.4g} (CPU {c['delta_norm']:.4g}); launches {g['launches']} "
        f"expected {g['expected']}")
    if tuple(g["rows"].shape) != (pop, m) or not (th_err <= 1e-4 and row_err <= 1e-4) or not g["delta_norm"] > 0:
        raise AssertionError(f"tiny Z-Image: θ′ {th_err}, rows {row_err}, ‖Δθ‖ {g['delta_norm']}")
    if graph_err != 0.0:
        raise AssertionError(f"tiny Z-Image: the graph's step differs from the eager one by {graph_err}")
    if g["launches"] != g["expected"] or not (g["expected"]["fused_qlora"] > 0 and g["expected"]["int8_matmul"] > 0):
        raise AssertionError(f"tiny Z-Image launched {g['launches']}, expected {g['expected']}")
    torch.cuda.empty_cache()
    return dict(theta_max_abs=th_err, rows_max_abs=row_err, graph_vs_eager_max_abs=graph_err,
                delta_norm=g["delta_norm"], launches=g["launches"])


class _TimedCalls:
    """``fn`` (a function, or the reward suite) with CUDA events recorded on
    the current stream around each call outside a CUDA graph's capture
    (``spans``, one ``(start, end)`` a call, in order); other attributes
    read through (the suite's towers)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.spans = torch, fn, []

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *a, **kw):
        torch = self.torch
        if torch.cuda.is_current_stream_capturing():
            return self.fn(*a, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*a, **kw)
        ev[1].record()
        self.spans.append(ev)
        return out

    def last_ms(self) -> float:
        start, end = self.spans[-1]
        return start.elapsed_time(end)


def zimage_fused_call(torch, backend, tc, theta, ids, gen_noise):
    """One eager generate call (decode included) of one member chunk over
    ``backend``'s base with ``pop_fuse``: members ``0..member_batch-1``'s
    factored adapter, the launch counters set to 0 just before and read
    just after, as :func:`expected_zimage_launches` derives them for the
    generation (over a bf16 base: K2 at every adapted site, 4 × layers × 8,
    nothing else). Under ``torch.profiler``: the kernels' in-situ
    device ms. Images finite in [0, 1]."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.es.noiser import factored_member_theta, sample_noise
    from hyperscalees_t2i_tpu_torch.utils import threefry

    tcf = dataclasses.replace(tc, pop_fuse=True)
    _, per = expected_zimage_launches(backend, None, tcf, len(ids))
    n = tcf.member_batch
    with torch.inference_mode():
        noise = sample_noise(threefry.prng_key(7, "cuda"), theta, tcf.pop_size, tcf.es_config())
        theta_k = factored_member_theta(theta, noise, list(range(n)), tcf.pop_size, tcf.es_config())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        _reset_counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            images = backend.generate_p(theta_k, ids.expand(n, -1), None,
                                        noise=gen_noise.expand(n, *gen_noise.shape))
            ev[1].record()
            torch.cuda.synchronize()
    counted = _counters()
    kernels, busy, n_kernels, _ = device_kernels(torch, prof)
    want = {"int8_matmul": per["k1_per_call"], "lora_chain": per["k2_per_call"], "fused_qlora": per["k3_per_call"],
            "decode_attention": 0}
    if counted != want or profiled_launches(kernels) != want:
        raise AssertionError(f"one pop_fuse generate call launched {counted} ({profiled_launches(kernels)} on the "
                             f"device), expected {want}")
    if not (bool(torch.isfinite(images).all()) and float(images.min()) >= 0.0 and float(images.max()) <= 1.0):
        raise AssertionError("the pop_fuse generate call's images are not finite in [0, 1]")
    out = dict(ms=ev[0].elapsed_time(ev[1]), launches=counted, images=tuple(images.shape), busy_ms=busy,
               kernels=n_kernels, in_situ_ms=profiled_launches(kernels, what=0))
    log(f"[zimage-fused] one eager generate call with pop_fuse over the bf16 base ({tuple(images.shape)}): "
        f"{out['ms']:.1f} ms, busy {busy:.1f} ms over {n_kernels} kernels; launches {counted} (expected {want}); "
        f"in situ {({k: round(v, 2) for k, v in out['in_situ_ms'].items()})} ms")
    return out


def phase_zimage_es(torch):
    """Z-Image's ES run on the card at :data:`ZIMAGE_TURBO`'s widths
    (``ZIMAGE_ES_LAYERS`` of its 30 blocks), the
    KL-VAE decoder, CLIP-B/32 and CLIP-H/14 (bf16, int8 image sides), 512²
    images, every backend built by the train CLI's builder (``cli.
    zimage_backend``) from the CLI's flags (``--backend zimage --pop_fuse
    true --train_vae_decoder_lora true --latent_size 64``, pop 8, 2
    prompts, member_batch 8, ``BENCH_PROMPT_SET`` as the prompt file).
    First over a bf16 base (``--base_quant off``, the weights drawn from
    seed 0 as ``setup`` draws them, each node cast to bf16 as it is drawn,
    so the f32 tree of ≈ 8.0 B values is never whole): one eager
    ``pop_fuse`` generate call of one chunk (:func:`zimage_fused_call`: K2
    4 × layers × 8, in situ). Then ``--base_quant int8``, the weights drawn by
    ``setup`` and quantized node by node as the CLI does without
    ``--weights``: ``run_training`` as a CUDA graph for ``ZIMAGE_EPOCHS``
    epochs, the first the warm-up and capture (:func:`_graph_run` with
    ``against_eager``: K3 4 × layers × 8 and K1 as the module tree gives
    them, per generate call, counted at the warm-up and on the device in a
    profiled replayed epoch, which must equal the same epoch run eagerly,
    bitwise). The eager epoch's stages by CUDA events: the DiT
    (``generate_latents``), the decoder and the towers. Memory: weights,
    the graph's pool, and the ``ada_lin`` temporary (one layer's f32
    dequantized slice, computed from the shape)."""
    import dataclasses
    import shutil

    from hyperscalees_t2i_tpu_torch.backends import zimage_backend
    from hyperscalees_t2i_tpu_torch.es.caps import global_norm
    from hyperscalees_t2i_tpu_torch.models import clip, vaekl, zimage
    from hyperscalees_t2i_tpu_torch.rewards.suite import build_random_reward_suite
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET
    from hyperscalees_t2i_tpu_torch.train import cli, trainer
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import cast_floating, tree_leaves, tree_map

    root = ROOT / "build" / "zimage_es"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    prompts_txt = root / "prompts.txt"
    prompts_txt.write_text("\n".join(BENCH_PROMPT_SET) + "\n")
    dev = torch.device("cuda")

    def flags(base_quant: str):
        return cli.build_parser().parse_args([
            "--backend", "zimage", "--pop_size", str(ZIMAGE_POP), "--prompts_per_gen", str(ZIMAGE_PROMPTS),
            "--member_batch", str(ZIMAGE_MB), "--num_epochs", str(ZIMAGE_EPOCHS), "--run_dir", str(root),
            "--run_name", "zimage", "--resume", "false", "--pop_fuse", "true", "--base_quant", base_quant,
            "--train_vae_decoder_lora", "true", "--tower_dtype", "bfloat16", "--latent_size", str(ZIMAGE_LATENT),
            "--prompts_txt", str(prompts_txt)])

    model_cfg = zimage.ZImageConfig(**{**ZIMAGE_TURBO, "n_layers": ZIMAGE_ES_LAYERS})
    vae_cfg = vaekl.VAEDecoderConfig(**ZIMAGE_VAE)
    tc = cli.train_config(flags("int8"))
    m = tc.prompts_per_gen
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    kt, kv = threefry.split(threefry.prng_key(0, dev))
    bf16 = lambda tree: cast_floating(tree, torch.bfloat16)  # noqa: E731
    tree = zimage.init_zimage(model_cfg, kt, node_fn=bf16)
    vae = bf16(vaekl.init_decoder(vae_cfg, kv))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = (torch.cuda.max_memory_allocated() - base0) / 2**30
    n_values = sum(t.numel() for t in tree_leaves(tree))
    t0 = time.perf_counter()
    suite = build_random_reward_suite(dataclasses.replace(clip.CLIP_B32, compute_dtype=torch.bfloat16),
                                      dataclasses.replace(clip.CLIP_H14, compute_dtype=torch.bfloat16),
                                      len(BENCH_PROMPT_SET), threefry.prng_key(1, dev), torch.bfloat16, "int8")
    b16 = cli.zimage_backend(flags("off"), model_cfg, vae_cfg, dev, params=tree, vae_params=vae)
    del tree, vae
    b16.setup()
    if b16.prompts != list(BENCH_PROMPT_SET):
        raise AssertionError(f"the Z-Image backend read {len(b16.prompts)} prompts, not BENCH_PROMPT_SET")
    torch.cuda.synchronize()
    build16_s = time.perf_counter() - t0
    bf16_bytes = torch.cuda.memory_allocated() - base0
    theta0 = tree_map(lambda t: t.to(dev), trainer._init_theta(b16, tc, dev))
    theta0_norm = float(global_norm(theta0))
    ids = torch.as_tensor(b16.step_info(0, m, 1).flat_ids, device=dev)
    gen_noise = b16.sample_gen_noise(threefry.prng_key(6, dev), range(m))
    fused = zimage_fused_call(torch, b16, tc, theta0, ids, gen_noise)
    del b16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = cli.zimage_backend(flags("int8"), model_cfg, vae_cfg, dev)
    backend.setup()
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    int8_peak = (torch.cuda.max_memory_allocated() - base0) / 2**30
    weights_bytes = torch.cuda.memory_allocated()
    _, per = expected_zimage_launches(backend, suite, tc, m)
    _, _, steps, d, _, _ = zimage_geometry()
    L = ZIMAGE_ES_LAYERS
    if (per["k2_per_call"], per["k3_per_call"], per["calls"]) != (0, 4 * L * steps, 1) or not per["k1_per_call"]:
        raise AssertionError(f"the Z-Image int8 pop_fuse plan is not K3 {4 * L * steps} and K1 in one call: {per}")
    ada_tmp = d * 6 * d * 4
    log(f"[zimage] Z-Image-Turbo widths (d {d}, {L} layers, {model_cfg.n_heads} heads of {model_cfg.head_dim}, "
        f"hidden {model_cfg.hidden}, caption {model_cfg.caption_dim}; {ZIMAGE_LATENT}² latents → "
        f"{8 * ZIMAGE_LATENT}² px): {n_values / 1e9:.3f} B transformer values drawn in bf16 in {draw_s:.1f} s (peak "
        f"{draw_peak:.2f} GiB), bf16 backend + reward suite {build16_s:.1f} s ({bf16_bytes / 2**30:.2f} GiB with the "
        f"towers); the int8 backend drawn and quantized node by node in {int8_s:.1f} s (peak {int8_peak:.2f} GiB), "
        f"device memory {weights_bytes / 2**30:.2f} GiB; θ₀ norm {theta0_norm:.4f} against theta_max_norm "
        f"{tc.theta_max_norm}; per generate call K3 {per['k3_per_call']}, K1 {per['k1_per_call']}; the ada_lin "
        f"temporary, computed from its shape: one layer's f32 slice {ada_tmp / 2**20:.1f} MiB (the whole stack's: "
        f"{L * ada_tmp / 2**30:.2f} GiB)")
    zmod, vmod = zimage_backend.zimage, zimage_backend.vaekl
    dit, dec, towers = (_TimedCalls(torch, f) for f in (zmod.generate_latents, vmod.decode, suite))
    zmod.generate_latents, vmod.decode = dit, dec
    try:
        state, run = _graph_run(torch, backend, towers, tc, weights_bytes, "zimage", against_eager=True,
                                bitwise=True, expected=expected_zimage_launches)
    finally:
        zmod.generate_latents, vmod.decode = dit.fn, dec.fn
    torch.cuda.synchronize()
    # the last eager call of each stage: the epoch run eagerly against the graph
    stages = dict(dit_ms=dit.last_ms(), vae_ms=dec.last_ms(), towers_ms=towers.last_ms(), eager_calls=len(dit.spans))
    log(f"[zimage] the eager epoch's stages by CUDA events: DiT {stages['dit_ms']:.1f} ms, decoder "
        f"{stages['vae_ms']:.1f} ms, towers {stages['towers_ms']:.1f} ms")
    stats = dict(plan=dict(pop=ZIMAGE_POP, prompts=m, member_batch=ZIMAGE_MB, **ZIMAGE_TURBO, latent=ZIMAGE_LATENT),
                 transformer_values=n_values, draw_s=draw_s, draw_peak_gib=draw_peak, build_bf16_s=build16_s,
                 bf16_gib=bf16_bytes / 2**30, build_int8_s=int8_s, build_int8_peak_gib=int8_peak,
                 ada_lin_temporary_gib=ada_tmp / 2**30, theta0_norm=theta0_norm, theta_max_norm=tc.theta_max_norm,
                 fused_call=fused, stages_ms=stages, **run)
    del backend, suite, state, theta0, towers
    gc.collect()
    torch.cuda.empty_cache()
    return stats


class _RecordCalls:
    """Wraps ``module.name`` (a sampler) to keep every output, and every
    call's tensor arguments, on the CPU (eager runs only)."""

    def __init__(self, module, name: str):
        self.mod, self.name, self.orig, self.outs, self.ins = module, name, getattr(module, name), [], []

    def __enter__(self):
        def rec(*a, **kw):
            out = self.orig(*a, **kw)
            self.outs.append(out.cpu())
            self.ins.append([t.float().cpu() for t in a if hasattr(t, "cpu")])
            return out

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def phase_var_reference(torch):
    """The tiny VAR geometry in f32 on the card against the CPU, on the same
    weights: one ``generate`` (two lanes with different adapters, injected
    Gumbel noise): token ids equal, images within 1e-4; one ES step (pop 4,
    member_batch 2, σ 0.1): θ′ and reward rows within 1e-4, ‖Δθ‖ > 0, K4
    launches exactly calls × scales × depth."""
    from hyperscalees_t2i_tpu_torch.backends.var_backend import VarBackend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.lora import stack_adapters
    from hyperscalees_t2i_tpu_torch.models import clip, var as var_mod
    from hyperscalees_t2i_tpu_torch.rewards.suite import clip_text_embed_table, make_clip_reward_fn
    from hyperscalees_t2i_tpu_torch.rungs import PROMPT_TOKEN_LEN, var_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    spec = var_rung_model("tiny")
    bcfg, ccfg = spec["bcfg"], spec["clip_b"]
    kp, kc, ki = threefry.split(threefry.prng_key(31, "cpu"), 3)
    params = var_mod.init_var(bcfg.model, kp)
    cparams = clip.init_clip(ccfg, kc)
    tids = threefry.randint(ki, (bcfg.model.num_classes + 2, PROMPT_TOKEN_LEN), 0, ccfg.vocab_size)
    with torch.inference_mode():
        table = clip_text_embed_table(clip.CLIPModel(ccfg, cparams), tids)
    pop, m, mb = 4, 4, 2
    # σ 0.1: at 0.01 no member's perturbation flips a token of this tiny
    # model on these draws, every reward row is the same and the update is 0
    tc = TrainConfig(pop_size=pop, sigma=0.1, egg_rank=4, member_batch=mb)
    outs = {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        on = lambda t: tree_map(lambda a: a.to(dev), t)  # noqa: E731
        backend = VarBackend(bcfg, dev, params=on(params))
        backend.setup()
        suite = RecordingReward(make_clip_reward_fn(clip.CLIPModel(ccfg, on(cparams)), table.to(dev)),
                                -(-pop // mb))
        if dev.type == "cpu":
            gen = torch.Generator().manual_seed(32)
            thetas = []
            for i in range(2):
                th = backend.init_theta(threefry.fold_in(threefry.prng_key(32, "cpu"), i))
                thetas.append({k: {f: v + 0.1 * torch.randn(v.shape, generator=gen) for f, v in d.items()}
                               for k, d in th.items()})
            # two lanes' Gumbel noise, drawn on the CPU so both devices sample from the same numbers
            lanes_noise = backend.sample_gen_noise(threefry.split(threefry.prng_key(34, "cpu")), range(2))
            theta = thetas[0]
            noise = sample_noise(threefry.prng_key(33, "cpu"), theta, pop, tc.es_config())
            flat = backend.step_info(0, m, 1).flat_ids
            gen_noise = backend.sample_gen_noise(threefry.prng_key(35, "cpu"), range(len(flat)))
        with torch.inference_mode(), _RecordCalls(var_mod, "sample_top_k_top_p") as rec:
            images = backend.generate_p(on(stack_adapters(thetas)), [[0, 1], [2, 3]], None, noise=lanes_noise.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            _reset_counters()
        step = make_es_step(backend, suite, tc, m, 1, device=dev)
        theta_new, metrics, _ = step(theta, flat, threefry.prng_key(0, dev), noise=noise, gen_noise=gen_noise)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = _counters()
        rows = reward_rows(torch, suite.rows, 1, len(flat))
        outs[dev.type] = (images.float().cpu(), torch.cat([i.reshape(-1) for i in rec.outs]),
                          tree_map(lambda a: a.float().cpu(), theta_new), rows.float().cpu(),
                          float(metrics["delta_norm"]))
        del backend, suite, step
    calls = -(-pop // mb)
    expected = {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0,
                "decode_attention": calls * len(bcfg.model.patch_nums) * bcfg.model.depth}
    img_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    ids_equal = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
    th_err = max(float((outs["cuda"][2][k][f] - outs["cpu"][2][k][f]).abs().max())
                 for k in outs["cpu"][2] for f in outs["cpu"][2][k])
    row_err = float((outs["cuda"][3] - outs["cpu"][3]).abs().max())
    log(f"[var-tiny] generate, 2 lanes × 2 images, card vs CPU: ids equal {ids_equal} "
        f"({outs['cpu'][1].numel()} tokens), images max abs diff {img_err:.3g} (tol 1e-4); ES step: θ′ "
        f"{th_err:.3g}, reward rows {tuple(outs['cuda'][3].shape)} {row_err:.3g} (tol 1e-4), ‖Δθ‖ "
        f"{outs['cuda'][4]:.4g} (CPU {outs['cpu'][4]:.4g}); launches {launches} expected {expected}")
    if not ids_equal or not img_err <= 1e-4:
        raise AssertionError(f"card and CPU disagree on the tiny VAR generate: ids equal {ids_equal}, images {img_err}")
    if tuple(outs["cuda"][3].shape) != (pop, len(flat)) or not (th_err <= 1e-4 and row_err <= 1e-4):
        raise AssertionError(f"card and CPU disagree on the tiny VAR ES step: θ′ {th_err}, rows {row_err}")
    if not outs["cuda"][4] > 0:
        raise AssertionError("the tiny VAR ES step made no update")
    if launches != expected:
        raise AssertionError(f"tiny VAR ES step launched {launches}, expected {expected}")
    torch.cuda.empty_cache()
    return {"images_max_abs": img_err, "ids_equal": ids_equal, "tokens": int(outs["cpu"][1].numel()),
            "theta_max_abs": th_err, "rows_max_abs": row_err, "delta_norm": outs["cuda"][4], "launches": launches,
            "expected": expected}


def call_breakdown(torch, tag: str, generate, decode, reward, ids, reps: int = 2):
    """One generate → decode → reward call of an AR epoch: ``generate()``
    gives f̂ ``[n, b, ...]``, ``decode`` maps f̂ ``[n·b, ...]`` to images,
    ``reward`` scores them against ``ids`` repeated ``n`` times. Stage times
    by CUDA events (mean of ``reps`` warm runs): generation (transformer,
    K4, sampling, pyramid), decode, reward (resize + both towers). Then one
    run under ``torch.profiler``: device time per kernel name, busy time,
    idle share, and K4's time in situ."""
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    acc = [0.0, 0.0, 0.0]
    n = []

    def one():
        ev[0].record()
        f_hat = generate()
        ev[1].record()
        images = decode(f_hat.reshape(-1, *f_hat.shape[2:]))
        ev[2].record()
        reward(images, ids.repeat(f_hat.shape[0]))
        ev[3].record()
        torch.cuda.synchronize()
        n[:] = [f_hat.shape[0]]

    with torch.inference_mode():
        for i in range(reps + 1):
            one()
            if i:  # the first run warms up
                for j in range(3):
                    acc[j] += ev[j].elapsed_time(ev[j + 1]) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device kernels only: CPU events slow the trace
            one()
    kernels, busy, n_kernels, top = device_kernels(torch, prof)
    k4 = [(ms, cnt) for name, (ms, cnt) in kernels.items() if "decode_attention" in name]
    out = {"generation": acc[0], "decode": acc[1], "reward": acc[2], "device_busy_profiled": busy,
           "idle_share": 1.0 - busy / sum(acc), "device_kernels": n_kernels,
           "k4_in_situ_ms": sum(ms for ms, _ in k4), "k4_in_situ_launches": sum(c for _, c in k4),
           "top_kernels": [dict(name=t, ms=m_, launches=c) for m_, c, t in top]}
    log(f"[{tag}] one generate call ({n[0]} lanes × {ids.numel()} images), device time: generation "
        f"{acc[0]:.2f} ms, decode {acc[1]:.2f} ms, reward {acc[2]:.2f} ms; {out['device_kernels']} kernels busy "
        f"{busy:.2f} ms (profiled) = idle share {out['idle_share']:.3f}; K4 in situ {out['k4_in_situ_ms']:.2f} ms "
        f"over {out['k4_in_situ_launches']} launches")
    for m_, c, t in top:
        log(f"[{tag}]   {m_:9.3f} ms {c:5d} launches  {t}")
    return out


def var_stage_breakdown(torch, backend, reward, theta, noise, tc, ids, gen_noise, reps: int = 2):
    """:func:`call_breakdown` of one VAR generate call: a chunk of
    ``member_batch`` members, each on the epoch's images."""
    from hyperscalees_t2i_tpu_torch.es.noiser import perturb_member
    from hyperscalees_t2i_tpu_torch.lora import stack_adapters
    from hyperscalees_t2i_tpu_torch.models import msvq, var as var_mod

    n = tc.member_batch
    cfg = backend.cfg
    labels = backend._pool[ids].expand(n, -1)
    with torch.inference_mode():
        theta_k = stack_adapters([perturb_member(theta, noise, k, tc.pop_size, tc.es_config()) for k in range(n)])
        theta_k = {k: {f: t.to("cuda") for f, t in d.items()} for k, d in theta_k.items()}
    return call_breakdown(
        torch, "var",
        lambda: var_mod.generate(backend.model, labels, gen_noise.expand(n, *gen_noise.shape), cfg_scale=cfg.cfg_scale,
                                 top_k=cfg.top_k, top_p=cfg.top_p, lora=theta_k, lora_scale=backend.lora_scale,
                                 decode=False),
        lambda f_hat: msvq.decode_img(backend.model.vq, f_hat), reward, ids, reps)


def phase_var_es(torch):
    """The VAR-d16 ES epoch step (``RUNG_PLAN``/``RUNG_OPT["ar_d16"]``) at
    ``VAR_ES_LAYERS`` of its 16 blocks, every width kept: one warm-up, then
    two timed epochs with the launch counters set to 0 just before and read
    just after; K4 must launch 10 × ``VAR_ES_LAYERS`` times per generate
    call."""
    from hyperscalees_t2i_tpu_torch.backends.var_backend import build_train_backend
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.models import var as var_mod
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache

    scale, pop, m, mb = RUNG_PLAN["ar_d16"]
    opt = rung_opt("ar_d16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend, suite = build_train_backend(scale, device="cuda", seed=0, depth=VAR_ES_LAYERS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb, promptnorm=True,
                     reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"], pop_fuse=opt["pop_fuse"])
    info = backend.step_info(0, m, 1)
    B = len(info.flat_ids)
    mcfg = backend.cfg.model
    calls = -(-pop // mb)
    per_call = len(mcfg.patch_nums) * mcfg.depth
    expected1 = {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0, "decode_attention": per_call * calls}

    def make_step(graph: bool):
        reward = RecordingReward(suite, calls)
        return make_es_step(backend, reward, tc, len(info.unique_ids), 1, device="cuda", stateful_delta=True,
                            graphs=GraphCache("cuda", graph=graph)), reward

    log(f"[var] VAR-d16 ES backend ({VAR_ES_LAYERS} of {VAR_DEPTH} blocks) built in {build_s:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; {calls} generate calls per epoch of {mb} lanes × {B} "
        f"images × 2 (CFG) = {2 * mb * B} rows; K4 {per_call} per call")
    theta = backend.init_theta(threefry.prng_key(1, "cuda"))  # a fresh run's θ: b = 0
    # every scale's sampled token ids, graph against eager
    with SlotRecorder(var_mod, "sample_top_k_top_p", calls * len(mcfg.patch_nums)) as ids_rec:
        theta, run = timed_epochs(torch, make_step, theta, info.flat_ids, expected1, pop, 1, "var",
                                  "VAR-d16 ES epoch", record=ids_rec)
    noise = sample_noise(threefry.prng_key(5, "cuda"), theta, pop, tc.es_config())
    ids = torch.as_tensor(info.flat_ids, device="cuda")
    gen_noise = backend.sample_gen_noise(threefry.prng_key(6, "cuda"), range(B))
    breakdown = var_stage_breakdown(torch, backend, suite, theta, noise, tc, ids, gen_noise)
    stats = dict(plan=dict(pop=pop, prompts=m, member_batch=mb, **opt), build_s=build_s, layers=VAR_ES_LAYERS,
                 per_call={"k4_per_call": per_call, "calls": calls}, call_breakdown_ms=breakdown, **run)
    del backend, suite
    torch.cuda.empty_cache()
    return stats


# card vs CPU on the normals and Gumbels of the stream: both apply the same
# erf_inv polynomial and -log(-log u) to bitwise-equal uniforms; only the
# devices' log1p/log/sqrt rounding differs
THREEFRY_ATOL = 1e-5
# flat elements per key that the CPU re-draws at each end of a card draw
THREEFRY_CPU_SPAN = 1 << 18


class _DrawLog:
    """Records every whole draw ``utils.threefry._draw`` makes (key, shape,
    converter, dtype) while active."""

    def __init__(self, threefry):
        self.tf, self.orig, self.calls = threefry, threefry._draw, []

    def __enter__(self):
        def rec(key, shape, convert, dtype):
            self.calls.append((key.clone(), self.tf._shape(shape), convert, dtype))
            return self.orig(key, shape, convert, dtype)

        self.tf._draw = rec
        return self

    def __exit__(self, *exc):
        self.tf._draw = self.orig


def phase_threefry(torch, flagship_backend):
    """The JAX noise stream (``utils.threefry``) on the card at each path's
    full-width draws: the flagship ES noise for the flagship θ (bf16 store),
    the flagship Sana latents of one ES epoch, the VAR-d16 Gumbel slab of
    one generate call (every scale, 4 images), Infinity-2B's Gumbel noise of
    one generate call, and one whole stacked Infinity-2B leaf
    (``blocks/ada_lin/kernel``, 805 M normals, drawn in chunks). Every
    primitive draw that a path makes is re-drawn on the CPU over its first
    and last ``THREEFRY_CPU_SPAN`` flat elements per key: the random bits
    and the uniforms (on [0, 1), on normal's and on Gumbel's ranges) must be
    bitwise equal, the normals and Gumbels within ``THREEFRY_ATOL``. Each
    path's draw is timed by CUDA events (``time_ms``), by device time under
    the profiler, with its kernel count. Returns one row per path."""
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.models import sana
    from hyperscalees_t2i_tpu_torch.ops.sampling import per_scale_gumbel
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, infinity_rung_model, rung_opt, var_rung_model
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    _, pop, m, _ = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    es_cfg = TrainConfig(pop_size=pop, egg_rank=4, noise_dtype=opt["noise_dtype"]).es_config()
    theta = flagship_backend.init_theta(threefry.prng_key(1, dev))
    var_m = var_rung_model("d16")["bcfg"].model
    inf_m = infinity_rung_model("2b")["bcfg"].model
    ada = (inf_m.depth, inf_m.d_model, 6 * inf_m.d_model)
    paths = {
        "flagship_es_noise": lambda: sample_noise(threefry.prng_key(5, dev), theta, pop, es_cfg),
        "flagship_latents": lambda: flagship_backend.sample_gen_noise(threefry.prng_key(6, dev), range(m)),
        "var_d16_gumbel": lambda: per_scale_gumbel(threefry.prng_key(6, dev), range(RUNG_PLAN["ar_d16"][2]),
                                                   var_m.patch_nums, (var_m.vq.vocab_size,)),
        "inf_2b_gumbel": lambda: per_scale_gumbel(threefry.prng_key(6, dev), range(RUNG_PLAN["inf_2b"][2]),
                                                  inf_m.patch_nums, (inf_m.vq.bits, 2)),
        "inf_2b_leaf": lambda: threefry.normal(threefry.prng_key(7, dev), ada),
    }
    los = {"unit": (0.0, 1.0), "normal": (threefry.NORMAL_LO, 1.0), "gumbel": (threefry.F32_TINY, 1.0)}
    rows = []
    for name, fn in paths.items():
        with torch.inference_mode(), _DrawLog(threefry) as rec:
            fn()
        torch.cuda.synchronize()
        ms = time_ms(torch, [fn], 3)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        _, dev_ms, n_kernels, _ = device_kernels(torch, prof)
        elements = sum(math.prod(k.shape[:-1]) * math.prod(shape) for k, shape, _, _ in rec.calls)
        worst, checked = 0.0, 0
        for key, shape, convert, dtype in rec.calls:
            n = math.prod(shape)
            span = max(1, THREEFRY_CPU_SPAN // max(1, math.prod(key.shape[:-1])))
            ranges = [(0, min(n, span))] + ([(n - span, n)] if n > span else [])
            for lo, hi in ranges:
                both = [threefry.flat_bits(k, torch.arange(lo, hi, dtype=torch.int64, device=k.device))
                        for k in (key, key.to(cpu))]
                if not torch.equal(both[0].cpu(), both[1]):
                    raise AssertionError(f"threefry {name}: card and CPU bits differ on {shape} [{lo}, {hi})")
                for kind, (a, b) in los.items():
                    u = [threefry.uniform_from_bits(x, a, b) for x in both]
                    if not torch.equal(u[0].cpu(), u[1]):
                        raise AssertionError(f"threefry {name}: card and CPU {kind} uniforms differ on {shape}")
                vals = [convert(x) for x in both]
                if dtype != torch.int64:
                    err = float((vals[0].cpu() - vals[1]).abs().max())
                    if not err <= THREEFRY_ATOL:
                        raise AssertionError(f"threefry {name}: card and CPU values differ by {err} on {shape}")
                    worst = max(worst, err)
                checked += vals[1].numel()
        row = dict(path=name, draws=len(rec.calls), elements=elements, ms=ms, device_ms=dev_ms,
                   kernels=n_kernels, cpu_checked_elements=checked, max_abs_card_vs_cpu=worst,
                   gelements_per_s=elements / ms / 1e6)
        rows.append(row)
        log(f"[threefry] {name}: {len(rec.calls)} draws, {elements} elements: {ms:.3f} ms (CUDA events), "
            f"{dev_ms:.3f} ms device time over {n_kernels} kernels = {row['gelements_per_s']:.2f} G elements/s; "
            f"card vs CPU on {checked} elements: bits and uniforms bitwise equal, values max abs {worst:.3g} "
            f"(tol {THREEFRY_ATOL})")
        torch.cuda.empty_cache()
    del theta
    return rows


def threefry_shares(rows, es, var_es, inf_full, inf_q8):
    """Each path's draw time as a share of the epoch (or call) that draws it
    once, from this run's path phases: the flagship ES noise and latents
    per flagship ES epoch, VAR-d16's Gumbel slab per VAR epoch and per one
    generate call's generation stage, Infinity-2B's Gumbel per epoch and per
    generate call of a replayed epoch (``inf_full``: the int8 run at the
    full depth, from the released-layout files), its stacked leaf per
    random backend build (``inf_q8``: the int8 rung at ``INF_Q8_DEPTH``
    blocks, the only random Infinity-2B int8 build left)."""
    import statistics

    med = statistics.median
    per = {
        "flagship_es_noise": {"flagship_es_epoch_ms": med(es["epoch_s"]) * 1e3},
        "flagship_latents": {"flagship_es_epoch_ms": med(es["epoch_s"]) * 1e3},
        "var_d16_gumbel": {f"var_d16_depth{VAR_ES_LAYERS}_es_epoch_ms": med(var_es["epoch_s"]) * 1e3,
                           f"var_d16_depth{VAR_ES_LAYERS}_generation_ms": var_es["call_breakdown_ms"]["generation"]},
        "inf_2b_gumbel": {"inf_2b_epoch_ms": med(inf_full["epoch_s"]) * 1e3,
                          "inf_2b_call_ms": med(inf_full["epoch_s"]) * 1e3 / inf_full["per_call"]["calls"]},
        "inf_2b_leaf": {f"inf_2b_depth{INF_Q8_DEPTH}_build_ms": inf_q8["build_s"] * 1e3},
    }
    for r in rows:
        r["share"] = {k: r["ms"] / v for k, v in per[r["path"]].items()}
        log(f"[threefry] {r['path']}: {r['ms']:.3f} ms = " +
            ", ".join(f"{share:.4%} of {k[:-3]} ({per[r['path']][k]:.1f} ms)" for k, share in r["share"].items()))
    return rows


# ---------------------------------------------------------------------------
# the Sana pipeline mode and the serving tier
# ---------------------------------------------------------------------------

PIPELINE_STEPS = 2  # DiT passes an image in the pipeline phases (the JAX CLI's default)
TIER_RATES = (0.5, 1.5)  # the sweep's rates, × the graph engine's measured images/s
TIER_WINDOW_S = 4.0
TIER_LANES = 4


def pipeline_draw_check(torch, steps: int = PIPELINE_STEPS, items: int = 16, shape=(32, 32, 32)):
    """The pipeline's draws (``models.sana.pipeline_noise``) at the
    flagship latent shape for one epoch's items, card against CPU: every key
    of the ``split`` chain and every draw's bits equal, bitwise; the normals
    within 1e-5 (``phase_threefry``'s bound)."""
    from hyperscalees_t2i_tpu_torch.models import sana
    from hyperscalees_t2i_tpu_torch.utils import threefry

    out = {}
    for dev in ("cpu", "cuda"):
        key, keys, bits = threefry.prng_key(41, dev), [], []
        for _ in range(steps + 1):
            pair = threefry.split(key)
            key, nkey = pair[0], pair[1]
            keys.append(nkey.cpu())
            bits.append(threefry.random_bits(threefry.fold_in(nkey[None], threefry.indices(range(items), dev)),
                                             shape).cpu())
        out[dev] = (torch.stack(keys), torch.stack(bits),
                    sana.pipeline_noise(threefry.prng_key(41, dev), range(items), steps, shape).float().cpu())
    keys_equal = torch.equal(out["cpu"][0], out["cuda"][0])
    bits_equal = torch.equal(out["cpu"][1], out["cuda"][1])
    normal_err = float((out["cpu"][2] - out["cuda"][2]).abs().max())
    if not (keys_equal and bits_equal and normal_err <= 1e-5):
        raise AssertionError(f"pipeline draws, card vs CPU: keys equal {keys_equal}, bits equal {bits_equal}, "
                             f"normals max abs {normal_err}")
    return {"keys_bitwise": keys_equal, "bits_bitwise": bits_equal, "normal_max_abs": normal_err,
            "draws": int(out["cpu"][2].numel())}


def phase_pipeline_reference(torch):
    """The tiny Sana rung in ``pipeline`` mode (``PIPELINE_STEPS`` DiT
    passes an image), f32, every kernel int8 (min_size 0), on the card
    against the CPU on the same weights: one ``generate`` (a served request,
    K1 at every int8 site, the DiT's ``PIPELINE_STEPS`` times) within 1e-4,
    and one ES step (``pop_fuse``: K3 at the adapted sites of each DiT pass,
    K1 elsewhere) with θ′ and the step's reward rows within 1e-4; the card's
    launches exactly as derived from the module trees; the pipeline's draws
    bitwise (:func:`pipeline_draw_check`)."""
    from hyperscalees_t2i_tpu_torch.es.noiser import sample_noise
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.train.trainer import make_es_step
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    _, pop, m, mb = RUNG_PLAN["tiny"]
    g = torch.Generator().manual_seed(51)
    trees = _es_trees(torch, "tiny", True, threefry.prng_key(51, "cpu"))
    tc = TrainConfig(pop_size=pop, sigma=0.01, egg_rank=4, member_batch=mb, pop_fuse=True)
    outs, launches = {}, {}
    for dev in (torch.device("cpu"), torch.device("cuda")):
        one_step, suite = _es_parts(torch, "tiny", dev, trees)
        backend = one_step.with_mode("pipeline", PIPELINE_STEPS)
        reward = RecordingReward(suite, -(-pop // mb))
        if dev.type == "cpu":
            theta = backend.init_theta(threefry.prng_key(52, "cpu"))
            theta = {k: {f: v + 0.05 * torch.randn(v.shape, generator=g) for f, v in d.items()}
                     for k, d in theta.items()}
            noise = sample_noise(threefry.prng_key(53, "cpu"), theta, pop, tc.es_config())
            flat = backend.step_info(0, m, 1).flat_ids
            gen_noise = backend.sample_gen_noise(threefry.prng_key(54, "cpu"), range(len(flat)))
        else:
            sites = [mod for mod in backend.model.modules() if hasattr(mod, "q8")]
            vae_sites = [mod for mod in backend.vae.modules() if hasattr(mod, "q8")]
            expected_gen = {"int8_matmul": len(sites) * PIPELINE_STEPS + len(vae_sites), "lora_chain": 0,
                            "fused_qlora": 0, "decode_attention": 0}
            expected_step, per = expected_es_launches(backend, suite, tc, len(flat))
            torch.cuda.synchronize()
            _reset_counters()
        with torch.inference_mode():
            images = backend.generate(theta, [0, 1], threefry.prng_key(55, dev)).float().cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches["generate"] = _counters()
            _reset_counters()
        step = make_es_step(backend, reward, tc, m, 1, device=dev)
        theta_new, _, _ = step(theta, flat, threefry.prng_key(0, dev), noise=noise, gen_noise=gen_noise)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches["es_step"] = _counters()
        calls_per_chunk = len(reward.rows) // -(-pop // mb)
        rows = reward_rows(torch, reward.rows, calls_per_chunk, len(flat) // calls_per_chunk)
        outs[dev.type] = (images, tree_map(lambda a: a.float().cpu(), theta_new), rows.float().cpu())
        del one_step, backend, suite, reward, step
    img_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    th_err = max(float((outs["cuda"][1][k][f] - outs["cpu"][1][k][f]).abs().max())
                 for k in outs["cpu"][1] for f in outs["cpu"][1][k])
    row_err = float((outs["cuda"][2] - outs["cpu"][2]).abs().max())
    draws = pipeline_draw_check(torch)
    log(f"[pipeline-tiny] tiny rung, pipeline mode ({PIPELINE_STEPS} DiT passes), f32 int8, card vs CPU: images "
        f"{tuple(outs['cuda'][0].shape)} max abs diff {img_err:.3g}, ES step θ′ {th_err:.3g}, reward rows "
        f"{tuple(outs['cuda'][2].shape)} {row_err:.3g} (tol 1e-4); launches generate {launches['generate']} "
        f"(expected {expected_gen}), ES step {launches['es_step']} (expected {expected_step}: K3 "
        f"{per['k3_per_call']}, K1 {per['k1_per_call']} a call); draws {draws}")
    if tuple(outs["cuda"][2].shape) != (pop, len(flat)):
        raise AssertionError(f"pipeline reward rows {tuple(outs['cuda'][2].shape)} are not [{pop}, {len(flat)}]")
    if not (img_err <= 1e-4 and th_err <= 1e-4 and row_err <= 1e-4):
        raise AssertionError(f"card and CPU disagree on the pipeline: images {img_err}, θ′ {th_err}, rows {row_err}")
    if launches["generate"] != expected_gen or launches["es_step"] != expected_step or \
            per["dit_passes"] != PIPELINE_STEPS or launches["es_step"]["fused_qlora"] == 0:
        raise AssertionError(f"the pipeline launched {launches}, expected generate {expected_gen}, "
                             f"ES step {expected_step}")
    torch.cuda.empty_cache()
    return {"images_max_abs": img_err, "theta_max_abs": th_err, "rows_max_abs": row_err, "launches": launches,
            "expected": {"generate": expected_gen, "es_step": expected_step}, "per_call": per, "draws": draws}


def cut_flagship_backend(torch, layers: int, base_quant: str, seed: int = 0):
    """The flagship rung's Sana backend as ``sana_backend.build_train_backend``
    builds it from ``PRNGKey(seed)`` (the same keys for the DiT, the DC-AE
    decoder and the prompt embeddings, bf16, ``base_quant``), its DiT cut to
    ``layers`` blocks, every width kept; no reward suite (the caller's)."""
    import dataclasses

    from hyperscalees_t2i_tpu_torch.backends.sana_backend import SanaBackend
    from hyperscalees_t2i_tpu_torch.models import dcae, sana
    from hyperscalees_t2i_tpu_torch.ops.quant import maybe_quantize_tree
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, rung_opt, sana_rung_model
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import cast_floating

    bcfg = sana_rung_model("flagship", tower_dtype=rung_opt("flagship")["tower_dtype"])["bcfg"]
    bcfg = dataclasses.replace(bcfg, model=dataclasses.replace(bcfg.model, n_layers=layers))
    kt, kv, ke = threefry.split(threefry.prng_key(seed, "cuda"), 3)
    params = maybe_quantize_tree(cast_floating(sana.init_sana(bcfg.model, kt), torch.bfloat16), base_quant)
    vae = maybe_quantize_tree(cast_floating(dcae.init_decoder(bcfg.vae, kv), torch.bfloat16), base_quant)
    prompts = list(BENCH_PROMPT_SET)
    backend = SanaBackend(bcfg, "cuda", params=params, vae_params=vae, prompts=prompts)
    del params, vae
    backend.set_prompt_embeds(threefry.normal(ke, (len(prompts), bcfg.prompt_embed_len, bcfg.model.caption_dim)))
    backend.setup()
    return backend


def phase_pipeline_es(torch, suite, es):
    """The flagship ES rung (``RUNG_PLAN``/``RUNG_OPT["flagship"]``) with its
    DiT cut to ``FLAGSHIP_CUT_LAYERS`` of 20 blocks (:func:`cut_flagship_backend`;
    the flagship's reward suite ``suite``) in ``pipeline`` mode (``PIPELINE_STEPS`` DiT
    passes an image: ``SanaBackend.with_mode``) under ``run_training`` as a
    CUDA graph: 3 epochs, the first warm (its warm-up and capture). Counted
    launches: the derived counts × the one eager epoch (K3
    ``PIPELINE_STEPS`` × (8 a block + 4) an image); then one profiled
    replayed epoch, whose K1-K4 on the device must be the derived counts.
    Reward rows ``[4, 4]`` finite, ‖Δθ‖ > 0. Prints the replayed epochs'
    s and images/s, busy ms and idle share, peak memory (peak allocated +
    the graph's pool) beside the one-step epoch of ``es`` (20 blocks)."""
    import shutil

    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    t0 = time.perf_counter()
    pipe = cut_flagship_backend(torch, FLAGSHIP_CUT_LAYERS, opt["base_quant"]).with_mode("pipeline", PIPELINE_STEPS)
    build_s = time.perf_counter() - t0
    root = ROOT / "build" / "train_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    tc = TrainConfig(num_epochs=3, pop_size=pop, sigma=0.01, egg_rank=4, prompts_per_gen=m, batches_per_gen=1,
                     member_batch=mb, reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"],
                     tower_dtype=opt["tower_dtype"], pop_fuse=opt["pop_fuse"], base_quant=opt["base_quant"],
                     quality=False, save_every=0, resume=False, run_dir=str(root), run_name="pipeline")
    expected1, per = expected_es_launches(pipe, suite, tc, m)
    k3_image = PIPELINE_STEPS * (8 * FLAGSHIP_CUT_LAYERS + 4)
    if (per["k3_per_call"], per["calls"]) != (k3_image, pop * m):
        raise AssertionError(f"the flagship pipeline plan at {FLAGSHIP_CUT_LAYERS} blocks is not K3 {k3_image} per "
                             f"image: {per}")
    reward = RecordingReward(suite, per["calls"])
    steps = []
    real, trainer.make_es_step = _recording_make(trainer, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, history, launches, wall_s, eager_epochs = _train(torch, pipe, reward, tc, expected1,
                                                                "the flagship pipeline run_training")
    finally:
        trainer.make_es_step = real
    peak_allocated = torch.cuda.max_memory_allocated()
    graph = next(iter(steps[0].graphs.stats().values()))
    rows = reward_rows(torch, reward.rows, per["calls"] // -(-pop // mb), 1).float()
    delta_norms = [h["delta_norm"] for h in history]
    if tuple(rows.shape) != (pop, m) or not bool(torch.isfinite(rows).all()) or not min(delta_norms) > 0:
        raise AssertionError(f"pipeline rows {tuple(rows.shape)} finite {bool(torch.isfinite(rows).all())}, "
                             f"delta_norm {delta_norms}")
    ids = torch.tensor(pipe.step_info(0, m, 1).flat_ids, dtype=torch.long, device="cuda")
    prof = profiled_epoch(torch, steps[0], state.theta, ids, epoch_key(tc.seed, 200, "cuda"))
    if prof["launches"] != expected1:
        raise AssertionError(f"the profiled pipeline epoch launched {prof['launches']} on the device, "
                             f"expected {expected1}")
    epoch_s = [h["step_time_s"] for h in history[1:]]
    images = pop * m
    prof["idle_share"] = 1.0 - prof["busy_ms"] / (1e3 * statistics.mean(epoch_s))
    memory_gib = (peak_allocated + graph["pool_bytes"]) / 2**30
    stats = dict(epoch_s=epoch_s, first_epoch_s=history[0]["step_time_s"], images_per_epoch=images,
                 images_per_s=[images / s for s in epoch_s], one_step_epoch_s=es["epoch_s"], profile=prof,
                 launches_counted=launches, eager_epochs=eager_epochs, launches_profiled=prof["launches"],
                 expected_launches_per_epoch=expected1, per_call=per, graph=graph, peak_mem_gib=memory_gib,
                 peak_allocated_gib=peak_allocated / 2**30, reward_rows=rows.cpu().tolist(), delta_norm=delta_norms,
                 wall_s=wall_s, dit_passes=PIPELINE_STEPS, layers=FLAGSHIP_CUT_LAYERS, build_s=build_s)
    log(f"[pipeline-es] flagship ES epoch at {FLAGSHIP_CUT_LAYERS} of 20 blocks (built in {build_s:.1f} s), pipeline mode "
        f"({PIPELINE_STEPS} DiT passes), run_training as a graph: "
        f"epochs {', '.join(f'{s:.3f}' for s in epoch_s)} s ({', '.join(f'{x:.3f}' for x in stats['images_per_s'])} "
        f"images/s; first {history[0]['step_time_s']:.3f} s incl. capture {graph['capture_s']:.3f} s) against the "
        f"one-step epoch at 20 blocks {', '.join(f'{s:.3f}' for s in es['epoch_s'])} s in this call; profiled replay busy "
        f"{prof['busy_ms']:.1f} ms over {prof['kernels']} kernels, idle share {prof['idle_share']:.4f}; memory "
        f"{memory_gib:.2f} GiB (peak allocated {peak_allocated / 2**30:.2f} + pool {graph['pool_bytes'] / 2**30:.2f}); "
        f"launches counted {launches} over {eager_epochs} eager epoch, on the device {prof['launches']} "
        f"(K3 {per['k3_per_call']}, K1 {per['k1_per_call']} an image); rows {tuple(rows.shape)}, delta_norm "
        f"{delta_norms}")
    del steps, state, reward, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _scrape(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def phase_serve_tier(torch, backend, serve):
    """The serving tier on the flagship serving backend :func:`phase_serve`
    built: a ``ServeEngine`` of ``TIER_LANES`` lanes (member_batch 1, a CUDA
    graph) with ``overload=OverloadConfig()``, SLOs ``latency_p95=2s,
    availability=99.9`` and the exporter on 127.0.0.1, built by
    ``tools.loadgen.build_engine`` (a store of 24 adapters).

    - Admission: the estimate (probes at 1 and 2 lanes) beside the bytes the
      built program holds and the replay's peak allocated + pool; then a
      second engine with a budget below the estimate must raise
      ``ServeAdmissionError`` naming both numbers, with no kernel launched,
      nothing captured and ``serve_compiles`` absent.
    - Load: a ``loadgen`` sweep at ``TIER_RATES`` × the images/s
      :func:`phase_serve`'s graph engine measured (window ``TIER_WINDOW_S``,
      Zipf 1.1 over 64 tenants, 1 image a request): each step's
      p50/p95/p99, open-loop p99, goodput, store churn, and the knee. Every
      served image is checked finite and in [0, 1].
    - Telemetry: ``/metrics`` scraped over HTTP and parsed; the request
      latency histogram's count and ``+Inf`` bucket equal the requests the
      engine served; every ``serve_*_seconds`` histogram present;
      ``/healthz`` answers.
    - Overload: ``run_degrade`` at 1.5 × the measured images/s with the
      layer OFF and ON (fresh engines, the client deadline the SLO):
      sheds by reason and goodput; ``not_resident`` 0 with it ON.
    - Bitwise: a request served alone equals it batched.
    - Pipeline: one profiled flush of a ``pipeline``-mode engine sharing the
      flagship modules; K1 on the device as derived (the DiT's sites
      ``PIPELINE_STEPS`` times); its images differ from the one-step
      engine's for the same (adapter, prompt, seed)."""
    from hyperscalees_t2i_tpu_torch.serve import OverloadConfig, ServeEngine
    from hyperscalees_t2i_tpu_torch.tools import loadgen
    from hyperscalees_t2i_tpu_torch.utils import threefry

    capacity_ips = statistics.mean(serve["images_per_s"])
    template = backend.init_theta(threefry.prng_key(0, "cuda"))
    engine, pop = loadgen.build_engine("flagship", 24, metrics_port=_free_port(), overload=OverloadConfig(),
                                       backend=backend, template=template, adapter_batch=TIER_LANES,
                                       slo="latency_p95=2s,availability=99.9")
    if engine.exporter is None:
        raise AssertionError("the exporter did not start")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (label,) = engine.warmup()
    warm_s = time.perf_counter() - t0
    rec = dict(engine.admission[label])
    if not rec["armed"] or rec.get("measured_bytes") is None:
        raise AssertionError(f"admission did not arm or measure: {rec}")
    pool = next(iter(engine.programs.stats().values()))["pool_bytes"]

    # every image the tier's engines serve (this one, the degrade run's OFF
    # and ON engines) is checked finite and in [0, 1] as it is delivered
    checked = {"images": 0}
    real_flush = ServeEngine.flush

    def checking_flush(self, *a, **kw):
        res = real_flush(self, *a, **kw)
        for r in res:
            if r.ok:
                lo, hi = float(r.images.min()), float(r.images.max())
                if not (lo >= 0.0 and hi <= 1.0):
                    raise AssertionError(f"served image outside [0, 1] or not finite: min {lo} max {hi}")
                checked["images"] += 1
        return res

    ServeEngine.flush = checking_flush
    try:
        return _serve_tier(torch, backend, serve, engine, pop, template, rec, pool, warm_s, capacity_ips, checked)
    finally:
        ServeEngine.flush = real_flush


def _serve_tier(torch, backend, serve, engine, pop, template, rec, pool, warm_s, capacity_ips, checked):
    """:func:`phase_serve_tier` from its first flush on, with every delivered
    image checked."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.obs.exporter import parse_prometheus_text
    from hyperscalees_t2i_tpu_torch.serve import ServeAdmissionError, ServeConfig, ServeEngine
    from hyperscalees_t2i_tpu_torch.tools import loadgen

    # the replay's peak allocated + pool (PERF.md's definition), over one full flush
    for i in range(TIER_LANES):
        pop.ensure(engine, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = [engine.submit(pop.adapter_id(i), [i % backend.num_items], seed=i) for i in range(TIER_LANES)]
    batched = {r.request.request_id: r for r in engine.flush()}
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated() + pool
    est, meas = rec["estimate_bytes"], rec["measured_bytes"]
    log(f"[serve-tier] admission at adapter_batch {TIER_LANES}: estimate {est / 2**30:.3f} GiB (base "
        f"{rec['base_bytes'] / 2**30:.3f} + program {rec['estimate_program_bytes'] / 2**30:.3f}; probes "
        f"{ {k: round(v / 2**30, 3) for k, v in rec['probe_bytes'].items()} } GiB at 1/2 lanes) against the built "
        f"program's {meas / 2**30:.3f} GiB (program {rec['measured_program_bytes'] / 2**30:.3f}) and the replay's "
        f"peak allocated + pool {replay_peak / 2**30:.3f} GiB: estimate/measured {est / meas:.4f}, "
        f"estimate/replay {est / replay_peak:.4f}; budget {rec['budget_bytes'] / 2**30:.2f} GiB "
        f"({rec['budget_source']}); warmup {warm_s:.2f} s")
    # the refusal: a budget below the estimate, decided from the remembered estimate
    budget = int(rec["base_bytes"] + 0.5 * rec["estimate_program_bytes"])
    torch.cuda.synchronize()
    _reset_counters()
    refused = ServeEngine(backend, ServeConfig(adapter_batch=TIER_LANES, member_batch=1, hbm_budget_bytes=budget,
                                               device="cuda"), theta_template=template)
    refused.put_adapter("t0", template)
    try:
        refused.generate("t0", [0], seed=0)
        raise AssertionError("a budget below the estimate was admitted")
    except ServeAdmissionError as e:
        refusal = str(e)
        if not (e.peak_bytes > e.budget_bytes == float(budget)) or "GB" not in refusal:
            raise AssertionError(f"the refusal does not name both numbers: {refusal}")
    torch.cuda.synchronize()
    refused_launches = _counters()
    if any(refused_launches.values()) or refused.programs.entries or \
            "serve_compiles" in refused.registry.snapshot():
        raise AssertionError(f"the refused geometry ran: launches {refused_launches}, programs "
                             f"{list(refused.programs.entries)}")
    log(f"[serve-tier] refusal under a {budget / 2**30:.3f} GiB budget: {refusal}; launches {refused_launches}, "
        "nothing captured")
    del refused

    rates = [round(f * capacity_ips, 3) for f in TIER_RATES]
    sweep = loadgen.run_sweep("flagship", rates, window_s=TIER_WINDOW_S, zipf_s=1.1, population=64,
                              store_adapters=24, slo_p99_s=2.0, engine=engine, pop=pop)
    for row in sweep["steps"]:
        log(f"[serve-tier] sweep {row['offered_rps']:.3f} req/s: completed {row['completed']}/{row['arrivals']}, "
            f"p50 {row['p50_s']} p95 {row['p95_s']} p99 {row['p99_s']} s, open-loop p99 {row['p99_open_s']} s, "
            f"goodput {row['goodput_rps']} req/s, end queue {row['queue_end_depth']}, store hits "
            f"{row['store_hits']} misses {row['store_misses']} evictions {row['store_evictions']}, shed "
            f"{row['shed_by_reason']}, not_resident {row['not_resident_refusals']}")
    disp = engine.dispatch_seconds
    occupancy = engine.registry.value("serve_requests") / max(len(disp), 1) / TIER_LANES
    log(f"[serve-tier] knee {sweep['knee']}; capacity {sweep['capacity_rps']} req/s at open-loop p99 <= 2 s, "
        f"goodput {sweep['goodput_rps']} req/s (graph engine measured {capacity_ips:.3f} images/s); {len(disp)} "
        f"dispatches, mean {statistics.mean(disp):.4f} s (median {statistics.median(disp):.4f}), mean occupancy "
        f"{occupancy:.3f}; {pop.materializations} adapters materialized")

    served = int(engine.registry.value("serve_requests"))
    parsed = parse_prometheus_text(_scrape(engine.exporter.port, "/metrics"))
    count = parsed["serve_request_latency_seconds_count"][0][1]
    inf = dict((lab["le"], v) for lab, v in parsed["serve_request_latency_seconds_bucket"])["+Inf"]
    missing = [n for n in ("serve_queue_wait_seconds_count", "serve_batch_assembly_seconds_count",
                           "serve_dispatch_seconds_count", "slo_latency_p95_burn_fast", "serve_adapter_hotness")
               if n not in parsed]
    health = json.loads(_scrape(engine.exporter.port, "/healthz"))
    if count != served or inf != served or missing or health.get("status") != "ok":
        raise AssertionError(f"/metrics: latency count {count}, +Inf {inf}, served {served}, missing {missing}; "
                             f"/healthz {health.get('status')}")
    log(f"[serve-tier] /metrics scraped over HTTP: {len(parsed)} series; serve_request_latency_seconds count "
        f"{count:g} = +Inf bucket = {served} requests served; /healthz {health['status']}, pressure rung "
        f"{health['pressure']['rung']}; latency percentiles {engine.latency_percentiles()}; images checked "
        f"{checked['images']}")

    # a request alone (padded to the lanes) equals it batched, bitwise
    r0 = batched[first[0].request_id]
    index = int(r0.request.adapter_id.split("-")[1])
    pop.ensure(engine, index)  # the sweep's churn may have evicted it; its bytes are the same again
    solo = engine.generate(r0.request.adapter_id, r0.request.prompt_ids, r0.request.seed)
    solo_diff = float(np.abs(solo - r0.images).max())
    if solo_diff != 0.0:
        raise AssertionError(f"served alone and batched differ by {solo_diff}")
    one_step_image = solo
    one_step_request = (r0.request.adapter_id, r0.request.prompt_ids, r0.request.seed, pop.theta_for(index))
    faults = _serve_faults(engine, pop, backend)
    engine.close()
    del engine, batched

    degrade = loadgen.run_degrade("flagship", rates, window_s=TIER_WINDOW_S, zipf_s=1.1, population=64,
                                  store_adapters=24, slo_p99_s=2.0, geometry_mix=((1, 1.0),),
                                  overload_rate_rps=round(1.5 * capacity_ips, 3), backend=backend, template=template,
                                  capacity=sweep, adapter_batch=TIER_LANES)
    off, on = degrade["off"], degrade["on"]
    log(f"[serve-tier] degrade at {degrade['overload_rate_rps']} req/s (images checked so far {checked['images']}): OFF completed {off['completed']}/"
        f"{off['arrivals']} goodput {off['goodput_rps']} p99_open {off['p99_open_s']} not_resident "
        f"{off['not_resident_refusals']} errors {off['errors']}; ON completed {on['completed']}/{on['arrivals']} "
        f"goodput {on['goodput_rps']} p99 {on['p99_s']} p99_open {on['p99_open_s']} shed {on['shed_by_reason']} "
        f"(client-expired {on['client_expired']}) not_resident {on['not_resident_refusals']} lease-blocked "
        f"{on['lease_blocked_evictions']}; retention ON {degrade['goodput_retention']}, OFF "
        f"{degrade['off_goodput_retention']}")
    if on["not_resident_refusals"] != 0:
        raise AssertionError(f"not_resident {on['not_resident_refusals']} with the overload layer on")

    # the pipeline mode behind an engine, sharing the flagship modules
    pipe = backend.with_mode("pipeline", PIPELINE_STEPS)
    peng = ServeEngine(pipe, ServeConfig(adapter_batch=2, images_per_request=1, member_batch=1, device="cuda"))
    aid, prompt_ids, seed, theta = one_step_request
    peng.put_adapter(aid, theta)
    peng.warmup()
    sites = [mod for mod in backend.model.modules() if hasattr(mod, "q8")]
    vae_sites = [mod for mod in backend.vae.modules() if hasattr(mod, "q8")]
    expected = {"int8_matmul": (len(sites) * PIPELINE_STEPS + len(vae_sites)) * 2, "lora_chain": 0,
                "fused_qlora": 0, "decode_attention": 0}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        peng.submit(aid, prompt_ids, seed)
        (res,) = peng.flush()
        torch.cuda.synchronize()
    kernels, busy, n_kernels, _ = device_kernels(torch, prof)
    pipe_launches = profiled_launches(kernels)
    pipe_diff = float(np.abs(res.images - one_step_image).max())
    lo, hi = float(res.images.min()), float(res.images.max())
    log(f"[serve-tier] pipeline engine ({PIPELINE_STEPS} DiT passes, 2 lanes): a profiled flush launched "
        f"{pipe_launches} on the device (expected {expected}), busy {busy:.1f} ms over {n_kernels} kernels; its image "
        f"differs from the one-step image of the same request by {pipe_diff:.4g} (max abs), in [{lo:.4g}, {hi:.4g}]")
    if pipe_launches != expected or not res.ok or not pipe_diff > 0 or not (lo >= 0.0 and hi <= 1.0):
        raise AssertionError(f"pipeline serving: launches {pipe_launches} (expected {expected}), ok {res.ok}, "
                             f"diff from one-step {pipe_diff}, range [{lo}, {hi}]")
    del peng, pipe
    torch.cuda.empty_cache()
    return dict(capacity_images_per_s=capacity_ips, admission=rec, replay_peak_bytes=replay_peak,
                estimate_over_measured=est / meas, estimate_over_replay_peak=est / replay_peak,
                refusal=refusal, refusal_budget_bytes=budget, refused_launches=refused_launches,
                sweep={k: sweep[k] for k in ("rates", "steps", "knee", "capacity_rps", "goodput_rps", "headline",
                                             "store", "adapter_hotness")},
                metrics_series=len(parsed), served=served, images_checked=checked["images"],
                dispatch_s_mean=statistics.mean(disp), dispatches=len(disp), mean_occupancy=occupancy,
                degrade={k: degrade[k] for k in ("overload_rate_rps", "off", "on", "on_overload",
                                                 "goodput_retention", "off_goodput_retention")},
                solo_vs_batched_max_abs=solo_diff, pipeline=dict(launches_profiled=pipe_launches, expected=expected,
                                                                 busy_ms=busy, vs_one_step_max_abs=pipe_diff),
                warmup_s=warm_s, faults=faults)


SERVE_SLOW_FAULT_S = 0.5  # HYPERSCALEES_SLOW_FAULT_S of the serving faults


def _serve_faults(engine, pop, backend):
    """The serving faults on the tier's engine (``resilience.faultinject``):
    ``store_io*1`` over one full flush of ``TIER_LANES`` requests must fail
    exactly one request (the first's ``AdapterStore.get``) while the others
    of the batch complete, in one dispatch; ``slow_dispatch*2`` over three
    one-request flushes must give the first two dispatches a ``dispatch_s``
    of at least the sleep ``SERVE_SLOW_FAULT_S`` plus 0.8 × the engine's
    fastest undisturbed dispatch, and the overload layer's EWMA for the
    geometry must take those ``dispatch_s`` (its update rule, to 1 ms) and
    rise at both."""
    from hyperscalees_t2i_tpu_torch.resilience import faultinject

    for i in range(TIER_LANES):
        pop.ensure(engine, i)
    dispatches = engine.stats()["dispatches"]
    faultinject.set_fault_plan(faultinject.FaultPlan.parse("store_io*1"))
    reqs = [engine.submit(pop.adapter_id(i), [i % backend.num_items], seed=1000 + i) for i in range(TIER_LANES)]
    res = engine.flush()
    failed = [r for r in res if not r.ok]
    if len(res) != TIER_LANES or len(failed) != 1 or failed[0].request.request_id != reqs[0].request_id or \
            "injected store_io fault" not in (failed[0].error or "") or \
            engine.stats()["dispatches"] != dispatches + 1:
        raise AssertionError(f"store_io*1: {len(failed)} of {len(res)} requests failed "
                             f"({[r.error for r in failed]}), {engine.stats()['dispatches'] - dispatches} dispatches")
    ewma, old = engine._governor.ewma, os.environ.get("HYPERSCALEES_SLOW_FAULT_S")
    before = ewma.get(reqs[1].geometry_key)
    os.environ["HYPERSCALEES_SLOW_FAULT_S"] = str(SERVE_SLOW_FAULT_S)
    try:
        faultinject.set_fault_plan(faultinject.FaultPlan.parse("slow_dispatch*2"))
        n0, preds = len(engine.dispatch_seconds), []
        for i in range(3):
            engine.submit(pop.adapter_id(0), [0], seed=2000 + i)
            (r,) = engine.flush()
            if not r.ok:
                raise AssertionError(f"slow_dispatch: a request failed: {r.error}")
            preds.append(ewma.get(r.request.geometry_key))
        slow, steady = engine.dispatch_seconds[n0:n0 + 2], engine.dispatch_seconds[n0 + 2]
    finally:
        faultinject.set_fault_plan(None)
        if old is None:
            os.environ.pop("HYPERSCALEES_SLOW_FAULT_S", None)
        else:
            os.environ["HYPERSCALEES_SLOW_FAULT_S"] = old
    # the sleep is inside the timed dispatch: a slowed dispatch_s holds the
    # sleep and a dispatch's own work (at least 0.8 × the fastest undisturbed
    # dispatch of this engine: a replay after an idle sleep can run faster
    # than any in the sweep); the EWMA takes those dispatch_s (its own
    # reading ends a few µs before the engine's dispatch_seconds entry)
    fastest = min(engine.dispatch_seconds[:n0] + [steady])
    a = ewma.alpha
    want = [a * slow[0] + (1 - a) * before]
    want += [a * slow[1] + (1 - a) * want[0], a * steady + (1 - a) * preds[1]]
    if min(slow) < SERVE_SLOW_FAULT_S + 0.8 * fastest or max(abs(p - w) for p, w in zip(preds, want)) > 1e-3 \
            or not before < preds[0] < preds[1]:
        raise AssertionError(f"slow_dispatch*2: dispatch_s {slow} against {steady} (fastest {fastest}, sleep "
                             f"{SERVE_SLOW_FAULT_S}); EWMA {before} then {preds} (want {want})")
    log(f"[serve-tier] faults: store_io*1 failed 1 of {TIER_LANES} requests in one dispatch, the others served; "
        f"slow_dispatch*2 ({SERVE_SLOW_FAULT_S} s): dispatch_s {slow[0]:.4f}, {slow[1]:.4f} s against {steady:.4f} "
        f"s undisturbed (the engine's fastest {fastest:.4f} s), the EWMA {before:.4f} → {preds[0]:.4f} → "
        f"{preds[1]:.4f} → {preds[2]:.4f} s")
    return dict(store_io_failed=1, requests=TIER_LANES, slow_dispatch_s=slow, steady_dispatch_s=steady,
                fastest_dispatch_s=fastest,
                ewma=[before] + preds, sleep_s=SERVE_SLOW_FAULT_S)



# ---------------------------------------------------------------------------
# fleet training (W ES jobs through one program) and the trainer's telemetry
# ---------------------------------------------------------------------------

FLEET_W = 2
# (σ, lr_scale, seed) of the tiny reference's jobs; σ/√r of the second is not an f32
FLEET_REF_JOBS = ((0.01, 1.0, 41), (0.013, 1.5, 43))
# the flagship fleet's jobs: id → (σ, lr_scale, seed, epochs); "c" joins after the first tick
FLEET_JOBS = {"a": (0.01, 1.0, 61, 3), "b": (0.014, 0.8, 62, 2), "c": (0.007, 1.4, 63, 3)}


def _flat_tree(torch, tree):
    return torch.cat([t.reshape(-1) for d in tree.values() for t in d.values()])


def _job_slice(tree, j):
    return {k: {f: t[j] for f, t in d.items()} for k, d in tree.items()}


def phase_fleet_reference(torch):
    """Fleet training at the tiny rung in f32 over an int8 base (K3 at the
    adapted sites, K1 elsewhere): ``FLEET_W`` jobs with their own σ,
    lr_scale and seed through one ``make_fleet_step`` program, θ₀ from each
    job's seed (drawn on the CPU, moved), the keys ``epoch_key(seed, 0)``.
    The card's tick (its warm-up, then a replay of the captured graph)
    against the same tick on the CPU: reward rows, θ′ and Δθ within 1e-4.
    On the card each job's rows, θ′, Δθ, scores and metrics are bitwise the
    port's solo step for that job (rows from ``make_solo_reward_rows``, the
    update from ``make_es_step``'s graph), the replay bitwise the warm-up;
    the warm-up's counted launches are ``FLEET_W`` × a job epoch's derived
    counts, and a profiled replay's on the device the same."""
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.lora import stack_adapters
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN
    from hyperscalees_t2i_tpu_torch.train import fleet, trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    _, pop, m, mb = RUNG_PLAN["tiny"]
    W = FLEET_W
    trees = _es_trees(torch, "tiny", True, threefry.prng_key(51, "cpu"))
    tcs = [TrainConfig(pop_size=pop, sigma=s, lr_scale=lr, seed=seed, egg_rank=4, prompts_per_gen=m,
                       member_batch=mb, pop_fuse=True) for s, lr, seed in FLEET_REF_JOBS]
    cpu = torch.device("cpu")
    outs = {}
    for dev in (cpu, torch.device("cuda")):
        backend, suite = _es_parts(torch, "tiny", dev, trees)
        ids = backend.step_info(0, m, 1).flat_ids
        thetas = [tree_map(lambda t: t.to(dev), trainer._init_theta(backend, tc, cpu)) for tc in tcs]
        zeros = [tree_map(torch.zeros_like, th) for th in thetas]
        keys = torch.stack([epoch_key(tc.seed, 0, dev) for tc in tcs])
        args = (stack_adapters(thetas), stack_adapters(zeros), torch.tensor([ids] * W, device=dev), keys,
                *(torch.from_numpy(x).to(dev) for x in trainer.fleet_scalar_args(tcs)))
        step = trainer.make_fleet_step(backend, suite, tcs[0], m, 1, W, dev)
        if dev.type == "cpu":
            out = step(*args)
        else:
            expected1, _ = expected_es_launches(backend, suite, tcs[0], len(ids))
            expected = {k: W * v for k, v in expected1.items()}
            torch.cuda.synchronize()
            _reset_counters()
            warm = step(*args)  # the warm-up's result, then the capture
            torch.cuda.synchronize()
            launches = _counters()
            warm = torch.utils._pytree.tree_map(torch.clone, warm)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(*args)  # a replay
                torch.cuda.synchronize()
            profiled = profiled_launches(device_kernels(torch, prof)[0])
            if launches != expected or profiled != expected:
                raise AssertionError(f"the tiny fleet tick launched {launches} (warm-up, counted) and {profiled} "
                                     f"(replay, on the device), expected {expected}")
            if step.graphs.stats() == {} or step.traces != 2:
                raise AssertionError(f"the tiny fleet tick was not captured: {step.graphs.stats()}, "
                                     f"{step.traces} traces")
            graph_eager = max(_max_abs(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(out),
                                                             torch.utils._pytree.tree_leaves(warm)))
            # each job against the port's solo step, on the card
            solo_bad = []
            for j, tc in enumerate(tcs):
                rows = fleet.make_solo_reward_rows(backend, suite, tc)(thetas[j], ids, keys[j])
                th, dl, met, opt = trainer.make_es_step(backend, suite, tc, m, 1, dev, stateful_delta=True)(
                    thetas[j], zeros[j], ids, keys[j])
                pairs = [("rows", out[2]["fleet_reward_rows"][j], rows), ("opt_scores", out[3][j], opt),
                         ("theta", _flat_tree(torch, _job_slice(out[0], j)), _flat_tree(torch, th)),
                         ("delta", _flat_tree(torch, _job_slice(out[1], j)), _flat_tree(torch, dl))]
                pairs += [(k, out[2][k][j], v) for k, v in met.items()]
                solo_bad += [(j, name) for name, a, b in pairs if not torch.equal(a, b)]
            if solo_bad or graph_eager != 0.0:
                raise AssertionError(f"the card's fleet tick is not bitwise the solo steps ({solo_bad[:4]}) or "
                                     f"its replay differs from its warm-up by {graph_eager}")
        outs[dev.type] = [(out[2]["fleet_reward_rows"][j].float().cpu(),
                           _flat_tree(torch, _job_slice(out[0], j)).float().cpu(),
                           _flat_tree(torch, _job_slice(out[1], j)).float().cpu()) for j in range(W)]
        del backend, suite, step
    errs = [max(float((a - b).abs().max()) for a, b in zip(c, g)) for c, g in zip(outs["cpu"], outs["cuda"])]
    log(f"[fleet-tiny] tiny fleet tick, {W} jobs (σ, lr_scale, seed) {FLEET_REF_JOBS}, f32 int8 base pop_fuse: "
        f"card vs CPU max abs diff per job {[f'{e:.3g}' for e in errs]} (tol 1e-4); on the card each job bitwise "
        f"its solo step (rows, θ′, Δθ, scores, metrics), the replay bitwise the warm-up; launches counted at the "
        f"warm-up {launches}, on the device in a replay {profiled}")
    if not max(errs) <= 1e-4:
        raise AssertionError(f"card and CPU disagree on the tiny fleet tick: {errs}")
    torch.cuda.empty_cache()
    return {"max_abs_per_job": errs, "launches": launches, "launches_profiled": profiled,
            "bitwise_solo": True, "jobs": FLEET_REF_JOBS}


class K3Spy:
    """Patches ``models.nn.fused_qlora_dense`` so the K3 calls numbered in
    ``at`` (in call order, outside a capture) keep a copy of their inputs:
    the fleet's launches of K3 as the path gives them, each lane's ``c``
    its job's."""

    def __init__(self, at):
        self.at, self.n, self.calls = set(at), 0, []

    def __enter__(self):
        import torch

        from hyperscalees_t2i_tpu_torch.lora import FactoredDelta
        from hyperscalees_t2i_tpu_torch.models import nn as nn_mod

        self.mod, self.orig = nn_mod, nn_mod.fused_qlora_dense

        def spy(x, qk, leaf, lora_scale):
            if not torch.cuda.is_current_stream_capturing():
                if self.n in self.at:
                    cp = lambda f: FactoredDelta(*(t.clone() for t in f))  # noqa: E731
                    self.calls.append(dict(x=x.clone(), q8=qk["q8"], scale=qk["scale"], a=cp(leaf["a"]),
                                           b=cp(leaf["b"]), lora_scale=lora_scale))
                self.n += 1
            return self.orig(x, qk, leaf, lora_scale)

        nn_mod.fused_qlora_dense = spy
        return self

    def __exit__(self, *exc):
        self.mod.fused_qlora_dense = self.orig


def phase_fleet_flagship(torch, backend, suite, es):
    """Fleet training at the flagship (``RUNG_PLAN``/``RUNG_OPT["flagship"]``,
    quality on) on the backend :func:`phase_es_flagship` built: a
    ``FleetScheduler`` with ``max_width`` ``FLEET_W`` over three jobs
    (:data:`FLEET_JOBS`), "c" submitted after the first tick, so fair share
    runs (a, b), (c, a), (b, c), (a, c): c takes b's place at the same width
    with another σ, and b leaves. Every tick is at width 2: one program,
    captured at the first tick (its warm-up's counted K1/K3 launches must be
    2 × a job epoch's derived counts; every later tick counts none), and
    ``fleet_compiles`` stays 1 across the join, the swap and the leave. One
    replayed tick is profiled: K3 and K1 on the device exactly 2 × 16 ×
    (164, 329), its busy ms and idle share. Job c's rows of every epoch
    and its final θ and Δθ are bitwise its solo steps (``make_es_step``'s
    graph from its θ₀). K3 at two of the fleet's launches (the first of
    each job in the warm-up, copied by :class:`K3Spy`) against its plain
    version, each ``c`` its job's ``f32(σ/√r)``. Prints the tick times, each
    job's images/s, the tick against the bare solo epoch of ``es`` (this
    call), peak allocated + the graph's pool."""
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key
    from hyperscalees_t2i_tpu_torch.obs.metrics import MetricsRegistry
    from hyperscalees_t2i_tpu_torch.ops.fused_qlora import fused_qlora_matmul, fused_qlora_reference
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt
    from hyperscalees_t2i_tpu_torch.train import fleet, trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    W = FLEET_W
    root = ROOT / "build" / "fleet_flagship"
    shutil.rmtree(root, ignore_errors=True)
    base = dict(pop_size=pop, egg_rank=4, prompts_per_gen=m, batches_per_gen=1, member_batch=mb,
                reward_tile=opt["reward_tile"], noise_dtype=opt["noise_dtype"], tower_dtype=opt["tower_dtype"],
                pop_fuse=opt["pop_fuse"], base_quant=opt["base_quant"], quality=True, save_every=0)
    jobs = {jid: TrainConfig(num_epochs=n, sigma=s, lr_scale=lr, seed=seed, **base)
            for jid, (s, lr, seed, n) in FLEET_JOBS.items()}
    expected1, per = expected_es_launches(backend, suite, jobs["a"], m)
    if (per["k3_per_call"], per["k1_per_call"], per["calls"]) != (164, 329, pop * m):
        raise AssertionError(f"the flagship plan is not K3 164, K1 329 per image over {pop * m} images: {per}")
    expected = {k: W * v for k, v in expected1.items()}
    reg = MetricsRegistry()
    sched = fleet.FleetScheduler(backend, suite, jobs["a"], root, max_width=W, device="cuda", registry=reg)
    k3_per_job = per["k3_per_call"] * per["calls"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks, counted, profiled = [], [], None
    for jid in ("a", "b"):
        sched.submit(fleet.FleetJobSpec(jid, jobs[jid]))
    with K3Spy(at=(0, k3_per_job)) as spy:
        _reset_counters()
        t0 = time.perf_counter()
        sched.tick()  # the warm-up (eager), then the capture
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_launches = _counters()
    sched.submit(fleet.FleetJobSpec("c", jobs["c"]))
    prof_tick = 2
    while True:
        _reset_counters()
        torch.cuda.synchronize()
        if len(ticks) + 1 == prof_tick:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                more = sched.tick()
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
            kernels, busy, n_kernels, top = device_kernels(torch, prof)
            profiled = dict(launches=profiled_launches(kernels), busy_ms=busy, kernels=n_kernels, wall_s=prof_s,
                            top_kernels=[dict(name=t, ms=ms, launches=n) for ms, n, t in top[:6]])
            counted.append(_counters())
            ticks.append(None)
            continue
        t0 = time.perf_counter()
        more = sched.tick()
        torch.cuda.synchronize()
        if not more:
            break
        ticks.append(time.perf_counter() - t0)
        counted.append(_counters())
    peak = torch.cuda.max_memory_allocated()
    stats = sched.programs.stats()
    snap = reg.snapshot()
    lines = [json.loads(ln) for ln in (root / "metrics.jsonl").read_text().splitlines() if ln.startswith("{")]
    order = [sorted(ln[k] for k in ln if k.endswith("/job_id")) for ln in lines]
    timed = [t for t in ticks if t is not None]
    nothing = {k: 0 for k in expected}
    if warm_launches != expected or any(c != nothing for c in counted):
        raise AssertionError(f"the fleet's warm-up tick counted {warm_launches} (expected {expected}); the "
                             f"replayed ticks counted {counted} (expected none)")
    if profiled is None or profiled["launches"] != expected:
        raise AssertionError(f"the profiled fleet tick launched {profiled and profiled['launches']} on the "
                             f"device, expected {expected}")
    if order != [["a", "b"], ["a", "c"], ["b", "c"], ["a", "c"]] or [ln["fleet_width"] for ln in lines] != [W] * 4:
        raise AssertionError(f"fair share ran {order} at widths {[ln['fleet_width'] for ln in lines]}")
    if snap.get("obs/fleet_compiles") != 1 or len(stats) != 1 or snap.get("obs/fleet_traces") != 2 or \
            snap.get("obs/fleet_leaves") != 3:
        raise AssertionError(f"join/swap/leave at width {W} built {snap.get('obs/fleet_compiles')} programs "
                             f"({snap.get('obs/fleet_traces')} traces, {snap.get('obs/fleet_leaves')} leaves)")
    for jid, tc in jobs.items():
        st = sched.job_state(jid)
        if not st["done"] or st["epoch"] != tc.num_epochs:
            raise AssertionError(f"job {jid} ended at {st}")
        if not all(np.isfinite(v) for v in st["scalars"].values() if isinstance(v, float)):
            raise AssertionError(f"job {jid}'s scalars are not finite")

    # job c (swapped in for b at width 2, its own σ) against its solo steps
    tc = jobs["c"]
    reward = RecordingReward(suite, per["calls"])
    solo = trainer.make_es_step(backend, reward, tc, m, 1, "cuda", stateful_delta=True)
    theta = trainer._init_theta(backend, tc, torch.device("cuda"))
    delta = tree_map(torch.zeros_like, theta)
    calls_per_chunk = per["calls"] // -(-pop // mb)
    solo_digests = []
    for e in range(tc.num_epochs):
        ids = backend.step_info(e, m, 1).flat_ids
        theta, delta, _, _ = solo(theta, delta, ids, epoch_key(tc.seed, e, "cuda"))
        theta, delta = _clone_tree(theta), _clone_tree(delta)
        solo_digests.append(fleet.reward_rows_digest(
            reward_rows(torch, reward.rows, calls_per_chunk, len(ids) // calls_per_chunk)))
    fleet_theta, fleet_delta = sched.job_theta("c")
    c_bitwise = dict(rows=solo_digests == sched.job_state("c")["rows_digests"],
                     theta=bool(torch.equal(_flat_tree(torch, fleet_theta), _flat_tree(torch, theta))),
                     delta=bool(torch.equal(_flat_tree(torch, fleet_delta), _flat_tree(torch, delta))))
    del solo, reward
    if not all(c_bitwise.values()):
        raise AssertionError(f"job c in the fleet is not bitwise its solo steps: {c_bitwise}")

    # K3 at the fleet's launches, each lane's c its job's
    k3_rows = []
    c_want = [float(np.float32(FLEET_JOBS[j][0] / math.sqrt(4))) for j in ("a", "b")]
    for j, call in enumerate(spy.calls):
        args = (call["x"], call["q8"], call["scale"], call["a"], call["b"], call["lora_scale"])
        out = fused_qlora_matmul(*args)
        torch.cuda.synchronize()
        T, din = call["x"].reshape(-1, call["x"].shape[-1]).shape
        err, tol, _ = check_close(f"fused_qlora at a fleet launch (job {j}) {T}x{din}x{call['q8'].shape[1]}",
                                  out, fused_qlora_reference(*args), "bfloat16", torch,
                                  again=lambda: (fused_qlora_matmul(*args), fused_qlora_reference(*args)))
        c = float(call["a"].c.abs().max())
        k3_rows.append(dict(job=j, T=T, din=din, dout=int(call["q8"].shape[1]), c=c, max_abs_err=err, tol=tol))
        if c != c_want[j]:
            raise AssertionError(f"K3's c at job {j}'s fleet launch is {c}, not its job's {c_want[j]}")
    if len(k3_rows) != 2:
        raise AssertionError(f"the spy caught {len(k3_rows)} of the fleet's K3 launches, not one a job")
    del spy

    entry = next(iter(stats.values()))
    mem_gib = (peak + entry["pool_bytes"]) / 2**30
    images = W * pop * m
    tick_mean = statistics.mean(timed)
    idle = 1.0 - profiled["busy_ms"] / (1e3 * tick_mean)
    out = dict(jobs=FLEET_JOBS, width=W, warmup_tick_s=warm_s, tick_s=timed, profiled_tick=profiled,
               idle_share=idle, images_per_tick=images, job_images_per_s=[pop * m / t for t in timed],
               solo_epoch_s=es["epoch_s"], tick_over_solo_epoch=tick_mean / statistics.mean(es["epoch_s"]),
               peak_allocated_gib=peak / 2**30, pool_gib=entry["pool_bytes"] / 2**30, memory_gib=mem_gib,
               graph=entry, warmup_launches=warm_launches, launches_profiled=profiled["launches"],
               fleet_compiles=snap["obs/fleet_compiles"], fleet_traces=snap["obs/fleet_traces"],
               tick_order=order, swap_bitwise=c_bitwise, k3_fleet_launches=k3_rows)
    log(f"[fleet] flagship fleet, {W} of 3 jobs a tick (σ, lr_scale, seed, epochs) {FLEET_JOBS}, order {order}: "
        f"warm-up tick {warm_s:.3f} s (capture {entry['capture_s']:.3f} s + instantiate "
        f"{entry['instantiate_s']:.3f} s); replayed ticks {', '.join(f'{t:.3f}' for t in timed)} s = "
        f"{images / tick_mean:.2f} images/s, {pop * m / tick_mean:.2f} a job; against the bare solo epoch "
        f"{', '.join(f'{t:.3f}' for t in es['epoch_s'])} s in this call (tick / epoch "
        f"{out['tick_over_solo_epoch']:.3f}); profiled tick busy {profiled['busy_ms']:.1f} ms over "
        f"{profiled['kernels']} kernels, idle share {idle:.4f}; memory {mem_gib:.2f} GiB (peak allocated "
        f"{peak / 2**30:.2f} + pool {entry['pool_bytes'] / 2**30:.2f}); fleet_compiles {snap['obs/fleet_compiles']} "
        f"across the join, the swap and {snap['obs/fleet_leaves']} leaves; K1/K3 counted at the warm-up "
        f"{warm_launches}, none in {len(counted)} replays, on the device in a replay {profiled['launches']} "
        f"(expected {expected}); job c bitwise its solo steps {c_bitwise}; K3 at the fleet's launches "
        + ", ".join(f"job {r['job']} c={r['c']:.6g} err {r['max_abs_err']:.3g} (tol {r['tol']:.3g})"
                    for r in k3_rows))
    del sched
    torch.cuda.empty_cache()
    return out


def telemetry_run(torch, backend, suite, base, expected1, bare_epoch_s, loop_epoch_s):
    """``run_training`` at the flagship with the live telemetry on: the
    exporter on a free port, ``slo``, heartbeats every second with a stall
    cap far above the first epoch's warm-up + capture, and the anomaly
    watchdog ticking from its second epoch. A thread scrapes ``/metrics``
    and ``/healthz`` while it runs. Counts the heartbeat lines and the
    watchdog's ticks (one per logged dispatch), and prints the run's epochs
    beside the bare step's ``bare_epoch_s`` and the replayed epochs of a
    ``run_training`` without telemetry (``loop_epoch_s``), both of this
    call."""
    import threading

    from hyperscalees_t2i_tpu_torch.obs import anomaly, heartbeat
    from hyperscalees_t2i_tpu_torch.obs.exporter import parse_prometheus_text
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

    port = _free_port()
    tc = TrainConfig(**{**base, "num_epochs": 4, "save_every": 2, "run_name": "flagship_telemetry",
                        "trace": False, "resume": False},
                     metrics_port=port, metrics_host="127.0.0.1", slo="latency_p95=5s,availability=99",
                     heartbeat_interval_s=1.0, stall_cap_s=120.0, anomaly_min_epochs=2)
    beats, ticks, scrapes = [], [], {"n": 0, "series": 0, "healthz": None, "errors": 0}
    real_emit, real_observe = heartbeat.emit_heartbeat, anomaly.AnomalyWatchdog.observe

    def counting_emit(name, phase, stream=None, **extra):
        beats.append((name, phase))
        return real_emit(name, phase, stream=stream, **extra)

    def counting_observe(self, epoch, scalars):
        ticks.append(epoch)
        return real_observe(self, epoch, scalars)

    stop = threading.Event()

    def scrape():
        while not stop.wait(0.25):
            try:
                fams = parse_prometheus_text(_scrape(port, "/metrics"))
                hz = json.loads(_scrape(port, "/healthz"))
            except OSError:
                scrapes["errors"] += 1
                continue
            scrapes["n"] += 1
            scrapes["series"] = len(fams)
            scrapes["healthz"] = hz

    heartbeat.emit_heartbeat = counting_emit
    anomaly.AnomalyWatchdog.observe = counting_observe
    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    try:
        state, hist, launches, wall, eager = _train(torch, backend, suite, tc, expected1,
                                                    "flagship run_training with telemetry")
    finally:
        stop.set()
        scraper.join(timeout=10)
        heartbeat.emit_heartbeat = real_emit
        anomaly.AnomalyWatchdog.observe = real_observe
    hz = scrapes["healthz"] or {}
    phases = sorted({p for n, p in beats if n == "train"})
    step_s = [h["step_time_s"] for h in hist]
    stalls = hist[-1].get("obs/stalls", 0)
    anomaly_keys = sorted(k for k in hist[-1] if k.startswith("anomaly/"))
    slo_keys = sorted(k for k in hist[-1] if k.startswith("slo/"))
    spread = (min(bare_epoch_s), max(bare_epoch_s))
    replays = step_s[1:]
    out = dict(epochs=len(hist), step_time_s=step_s, bare_epoch_s=bare_epoch_s, loop_epoch_s=loop_epoch_s,
               within_bare_spread=[spread[0] <= s <= spread[1] for s in replays],
               median_over_loop=statistics.median(replays) / statistics.median(loop_epoch_s),
               scrapes=scrapes["n"], scrape_errors=scrapes["errors"], series=scrapes["series"],
               healthz_keys=sorted(hz), heartbeats=len(beats), heartbeat_phases=phases, anomaly_ticks=ticks,
               anomaly_keys=anomaly_keys, slo_keys=slo_keys, stalls=stalls, launches=launches, eager_epochs=eager,
               wall_s=wall)
    log(f"[train-telemetry] flagship run_training with exporter, SLOs, heartbeats (1 s, stall cap 120 s) and the "
        f"anomaly watchdog: epochs {', '.join(f'{s:.3f}' for s in step_s)} s step_time_s (the first warm) against "
        f"the bare step's {', '.join(f'{s:.3f}' for s in bare_epoch_s)} s and run_training's without telemetry "
        f"{', '.join(f'{s:.3f}' for s in loop_epoch_s)} s in this call (median ratio "
        f"{out['median_over_loop']:.4f}); {scrapes['n']} scrapes "
        f"during the run ({scrapes['series']} series on /metrics, /healthz keys {sorted(hz)}); {len(beats)} "
        f"heartbeat lines (train phases {phases}); anomaly ticks at epochs {ticks}, {len(anomaly_keys)} anomaly/* "
        f"gauges; slo/* {len(slo_keys)}; stalls {stalls}; launches {launches} over {eager} eager epoch(s)")
    want_hz = {"backend", "run_dir", "topology", "membership", "resilience", "queue", "status"}
    if scrapes["n"] == 0 or scrapes["series"] == 0 or not want_hz <= set(hz):
        raise AssertionError(f"no live scrape of the run: {scrapes['n']} scrapes, {scrapes['series']} series, "
                             f"healthz keys {sorted(hz)}")
    if ticks != [h["epoch"] for h in hist] or not anomaly_keys or not slo_keys:
        raise AssertionError(f"the watchdog ticked at {ticks} for rows {[h['epoch'] for h in hist]}; anomaly "
                             f"gauges {anomaly_keys}, slo gauges {slo_keys}")
    if "compile" not in phases or stalls:
        raise AssertionError(f"heartbeat phases {phases}, stalls {stalls}")
    return out


# ---------------------------------------------------------------------------
# The run tools over the trainer's run dirs, and preflight on the card
# ---------------------------------------------------------------------------

RUN_TOOLS_HBM_GB = 4  # the preflight child's target capacity: the flagship must not fit
PREFLIGHT_PEAK_TOL = 0.15  # preflight's flagship peak against phase_es_flagship's memory
PREFLIGHT_MFUS = (0.10, 0.25)  # the predicted step times logged beside the measured epoch


def _preflight_child(out_dir, go, *argv_lists):
    """A fresh process (its own CUDA context) that does its host start (the
    imports, the first tokenizer lookup, which imports ``transformers``),
    waits for the file ``go`` to say ``go`` (:func:`_wait_word`), then runs
    ``tools.preflight.main`` once per argument list; exits with the largest
    exit code. Its output goes to ``out_dir/log.txt``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    code = (child_prelude() + "from pathlib import Path; from hyperscalees_t2i_tpu_torch.tools import preflight; "
            "from hyperscalees_t2i_tpu_torch.rewards.suite import tokenize_with_hf; tokenize_with_hf(['a photo']); "
            f"chip_smoke._wait_word(Path({str(go)!r}), 'to start'); "
            f"sys.exit(max(preflight.main(a) for a in {[list(a) for a in argv_lists]!r}))")
    log_file = open(out_dir / "log.txt", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_file


def start_preflight_children():
    """:func:`phase_run_tools`' two preflight children, started early: they
    do their host start while the trainer phases have the card and wait on
    ``build/run_tools/go``. One runs ``--rungs tiny,flagship`` under a
    ``RUN_TOOLS_HBM_GB`` GB budget, the other ``--serve flagship:2`` and
    ``--fleet tiny:2``."""
    import shutil

    root = ROOT / "build" / "run_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    go = root / "go"
    nofit = _preflight_child(root / "preflight_rungs", go, ["--rungs", "tiny,flagship", "--hbm-gb",
                                                            str(RUN_TOOLS_HBM_GB), "--out", str(root / "preflight_rungs")])
    modes = _preflight_child(root / "preflight_modes", go,
                             ["--serve", "flagship:2", "--out", str(root / "preflight_modes")],
                             ["--fleet", "tiny:2", "--out", str(root / "preflight_modes")])
    return {"root": root, "nofit": nofit, "modes": modes}


def stop_preflight_children(children):
    """Tell the preflight children to leave without touching the card, and
    wait for them."""
    _tell(children["root"], "stop")
    for proc, log_file in (children["nofit"], children["modes"]):
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log_file.close()


def phase_run_tools(torch, backend, suite, es, children):
    """The run tools of the port over the run dirs the trainer phases wrote,
    and preflight on the card:

    - ``tools.trace_report`` over :func:`phase_train_flagship`'s traced run
      dir: the phase table, top-level coverage ≥ 0.90, the Chrome export.
    - ``tools.run_report`` over :func:`phase_train_artifacts`'s run dir and
      :func:`phase_fleet_flagship`'s: HTML with the roofline,
      predicted-against-measured and Fleet panels, no external asset.
    - ``tools.sentry``: a baseline from the artifacts run (4 epochs), a check
      of the telemetry run (4 epochs of the same plan and seed) exits 0; a
      copy of it with every ``step_time_s`` ×3 exits 2 naming the metric;
      then the checked run dir resumed for one epoch with the exporter on,
      whose ``/healthz`` must carry ``sentry_verdict`` (K1 and K3 counted
      over that epoch's warm-up as derived).
    - ``tools.preflight`` in the two child processes of
      :func:`start_preflight_children` (``children``), told to start first,
      each a fresh CUDA context: ``--rungs tiny,flagship --hbm-gb RUN_TOOLS_HBM_GB`` exits
      1 naming the flagship as a no-fit, its flagship record's peak within
      ``PREFLIGHT_PEAK_TOL`` of ``es``'s measured memory (less what earlier
      phases of this process held when it began: the child starts empty) and its warm-up's
      launches K1 329 and K3 164 an image; the other runs ``--serve
      flagship:2`` and ``--fleet tiny:2`` and exits 0.

    Returns the numbers, the parent's counted launches under ``launches``
    and the flagship preflight's under ``preflight_launches``."""
    import contextlib
    import io
    import shutil
    import urllib.request

    from hyperscalees_t2i_tpu_torch.obs.program_cost import load_programs
    from hyperscalees_t2i_tpu_torch.obs.regress import VERDICT_FILE
    from hyperscalees_t2i_tpu_torch.obs.trace import load_events
    from hyperscalees_t2i_tpu_torch.tools import run_report, sentry, trace_report
    from hyperscalees_t2i_tpu_torch.train import trainer
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig
    from hyperscalees_t2i_tpu_torch.utils.jsonl import read_jsonl_rows
    from hyperscalees_t2i_tpu_torch.utils.mfu import device_hbm_bandwidth, device_peak_flops

    root, nofit, modes = children["root"], children["nofit"], children["modes"]
    t_children = time.perf_counter()
    _tell(root, "go")
    out = {}
    try:
        # trace_report: the flagship trainer's traced run
        run_dir = ROOT / "build" / "train_flagship" / "flagship"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = trace_report.main([str(run_dir), "--chrome"])
        text = buf.getvalue()
        events = trace_report.latest_session(load_events(run_dir))
        cov = trace_report.coverage(events)
        chrome = json.loads((run_dir / "trace_chrome.json").read_text())
        table = [line for line in text.splitlines() if line.startswith("| ")]
        if rc != 0 or cov < 0.90 or not chrome["traceEvents"] or not any(r.startswith("| dispatch |") for r in table):
            raise AssertionError(f"trace_report on {run_dir}: rc {rc}, coverage {cov:.4f}, "
                                 f"{len(chrome['traceEvents'])} Chrome events, table {table[:3]}")
        out["trace_report"] = dict(coverage=cov, spans=len(events), chrome_events=len(chrome["traceEvents"]),
                                   phases=len(table) - 2)
        log(f"[run-tools] trace_report {run_dir.name}: coverage {100 * cov:.1f}% over {len(events)} spans, "
            f"{len(chrome['traceEvents'])} Chrome events; the phase table's top rows: {table[2:6]}")

        # run_report: the artifacts run and the fleet's
        reports = {}
        for tag, d, needles in (("artifacts", ROOT / "build" / "train_artifacts" / "artifacts",
                                 ("Roofline &amp; programs", "Predicted vs measured", "Host-side phase times")),
                                ("fleet", ROOT / "build" / "fleet_flagship", ("Fleet", "Jobs seen"))):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = run_report.main([str(d), "-o", str(root / f"run_report_{tag}.html")])
            page = (root / f"run_report_{tag}.html").read_text()
            external = [n for n in ("http://", "https://", "<script", "@import") if n in page]
            missing = [n for n in needles if n not in page]
            if rc != 0 or missing or external:
                raise AssertionError(f"run_report {tag}: rc {rc}, missing {missing}, external {external}")
            reports[tag] = len(page)
        out["run_report_bytes"] = reports
        log(f"[run-tools] run_report: artifacts {reports['artifacts']} bytes (roofline, predicted vs measured, "
            f"phase table), fleet {reports['fleet']} bytes (Fleet panel); no external asset")

        # sentry: the artifacts run as the baseline, the telemetry run checked
        base_dir = ROOT / "build" / "train_artifacts" / "artifacts"
        cand = ROOT / "build" / "train_flagship" / "flagship_telemetry"
        manifest = root / "sentry_baseline.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_base = sentry.main(["baseline", "--out", str(manifest), str(base_dir)])
            rc_pass = sentry.main(["check", str(cand), "--manifest", str(manifest)])
        verdict = json.loads((cand / VERDICT_FILE).read_text())
        doctored = root / "doctored"
        shutil.copytree(cand, doctored, ignore=shutil.ignore_patterns("ckpt"))
        rows = read_jsonl_rows(doctored / "metrics.jsonl")
        (doctored / "metrics.jsonl").write_text("".join(
            json.dumps({**r, "step_time_s": 3 * r["step_time_s"]} if "step_time_s" in r else r) + "\n" for r in rows))
        buf2 = io.StringIO()
        with contextlib.redirect_stdout(buf2):
            rc_breach = sentry.main(["check", str(doctored), "--manifest", str(manifest)])
        breached = [b["metric"] for b in json.loads((doctored / VERDICT_FILE).read_text())["breaches"]]
        if rc_base != 0 or rc_pass != 0 or rc_breach != 2 or breached != ["step_time_s"] or \
                "BREACH step_time_s[run]" not in buf2.getvalue():
            raise AssertionError(f"sentry: baseline rc {rc_base}, same-plan check rc {rc_pass} ({verdict['breaches']}), "
                                 f"doctored rc {rc_breach} breaching {breached}:\n{buf.getvalue()}{buf2.getvalue()}")
        out["sentry"] = dict(checked=verdict["checked"], skipped=len(verdict["skipped"]), pass_rc=rc_pass,
                             doctored_rc=rc_breach, breached=breached)
        log(f"[run-tools] sentry: check of {cand.name} against a baseline of {base_dir.name} exits {rc_pass} "
            f"({verdict['checked']} checked, {len(verdict['skipped'])} skipped); the copy with step_time_s x3 exits "
            f"{rc_breach} breaching {breached}")

        # /healthz of the checked run dir, resumed for one epoch
        port = _free_port()
        tc = TrainConfig(**{**flagship_train_base(cand.parent), "num_epochs": 5, "run_name": cand.name,
                            "trace": False, "resume": True}, metrics_port=port, metrics_host="127.0.0.1")
        expected1, _ = expected_es_launches(backend, suite, tc, tc.prompts_per_gen)
        seen = {}

        def scrape(epoch, _row):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                seen[epoch] = json.loads(r.read())

        torch.cuda.synchronize()
        _reset_counters()
        trainer.run_training(backend, suite, tc, on_epoch_end=scrape, device="cuda")
        torch.cuda.synchronize()
        launches = _counters()
        hz = seen.get(4, {}).get("sentry_verdict")
        if not hz or hz.get("pass") is not True or hz.get("checked") != verdict["checked"] or launches != expected1:
            raise AssertionError(f"/healthz of the resumed {cand.name}: sentry_verdict {hz}; launches {launches}, "
                                 f"expected {expected1}")
        out["healthz_sentry_verdict"] = hz
        out["launches"] = launches
        log(f"[run-tools] /healthz of {cand.name} resumed for epoch 4: sentry_verdict {hz}; launches {launches}")

        # the preflight children
        for proc, log_file in (nofit, modes):
            proc.wait(timeout=600)
            log_file.close()
        children_s = time.perf_counter() - t_children
        text_nofit = (root / "preflight_rungs" / "log.txt").read_text()
        text_modes = (root / "preflight_modes" / "log.txt").read_text()
        recs = {r["label"]: r for r in load_programs(root / "preflight_rungs")}
        flag = recs.get("flagship", {})
        peak_gib = (flag.get("peak_bytes") or 0) / 2**30
        # the plan's own memory in the epoch phase: its graph memory less what the
        # process's earlier phases still held when it started (the child starts empty)
        plan_gib = es["peak_mem_gib"] - es["allocated_before_gib"]
        ratio = peak_gib / plan_gib
        images = es["images_per_epoch"]
        want = {"int8_matmul": 329 * images, "lora_chain": 0, "fused_qlora": 164 * images, "decode_attention": 0}
        if nofit[0].returncode != 1 or "VERDICT: NO-FIT" not in text_nofit or "flagship (peak" not in text_nofit \
                or "tiny (peak" in text_nofit:
            raise AssertionError(f"preflight --rungs tiny,flagship --hbm-gb {RUN_TOOLS_HBM_GB} exited "
                                 f"{nofit[0].returncode}:\n{text_nofit[-3000:]}")
        if abs(ratio - 1) > PREFLIGHT_PEAK_TOL or flag.get("warmup_launches") != want:
            raise AssertionError(f"preflight's flagship: peak {peak_gib:.3f} GiB against phase_es_flagship's "
                                 f"{plan_gib:.3f} (ratio {ratio:.4f}); warm-up launches "
                                 f"{flag.get('warmup_launches')}, expected {want}")
        if modes[0].returncode != 0:
            raise AssertionError(f"preflight --serve / --fleet exited {modes[0].returncode}:\n{text_modes[-3000:]}")
        peak_f, bw = device_peak_flops(), device_hbm_bandwidth()
        predicted = {f"{u:.2f}": max(flag["flops"] / (peak_f * u), flag["bytes_accessed"] / bw) for u in PREFLIGHT_MFUS}
        modes_recs = load_programs(root / "preflight_modes")
        out["preflight"] = dict(
            children_s=children_s, nofit_rc=nofit[0].returncode, modes_rc=modes[0].returncode,
            flagship_peak_gib=peak_gib, es_peak_mem_gib=es["peak_mem_gib"], es_plan_gib=plan_gib, peak_ratio=ratio,
            flagship_base_gib=flag["base_bytes"] / 2**30, flagship_program_gib=flag["program_bytes"] / 2**30,
            tiny_peak_gib=recs["tiny"]["peak_bytes"] / 2**30, flagship_tflop=flag["flops"] / 1e12,
            flagship_gb_moved=flag["bytes_accessed"] / 1e9, warmup_s=flag["warmup_s"], capture_s=flag["capture_s"],
            predicted_step_s=predicted, measured_epoch_s=es["epoch_s"],
            modes={r["label"]: r["peak_bytes"] / 2**30 for r in modes_recs})
        out["preflight_launches"] = flag["warmup_launches"]
        log(f"[run-tools] preflight --rungs tiny,flagship --hbm-gb {RUN_TOOLS_HBM_GB}: exit 1, flagship a no-fit; "
            f"flagship peak {peak_gib:.3f} GiB (resident {flag['base_bytes'] / 2**30:.3f} + program "
            f"{flag['program_bytes'] / 2**30:.3f}) against phase_es_flagship's {plan_gib:.3f} GiB (its "
            f"{es['peak_mem_gib']:.3f} GiB less the {es['allocated_before_gib']:.3f} earlier phases held): ratio "
            f"{ratio:.4f}; counted {flag['flops'] / 1e12:.2f} TFLOP, {flag['bytes_accessed'] / 1e9:.1f} GB; warm-up "
            f"launches {flag['warmup_launches']}; predicted step "
            + ", ".join(f"{v:.4f} s at MFU {k}" for k, v in predicted.items())
            + f" against the measured epochs {', '.join(f'{t:.3f}' for t in es['epoch_s'])} s; --serve flagship:2 "
            f"and --fleet tiny:2 exit 0 ({ {k: round(v, 3) for k, v in out['preflight']['modes'].items()} } GiB); "
            f"children {children_s:.1f} s")
        for line in text_nofit.splitlines():
            if line.startswith(("VERDICT", "    flagship", "     tiny")):
                log(f"[run-tools]   {line.strip()}")
    finally:
        for proc, log_file in (nofit, modes):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The evaluation harness and the user tools around a trained adapter
# ---------------------------------------------------------------------------

EVAL_TSV = ROOT / "data" / "parti_prompts_sample.tsv"
EVAL_BATCH = 4  # prompts a generate_folder batch at the flagship
EVAL_TRIALS = 4  # blind A/B pairs of the demo
EVAL_TOL = 1e-4  # card against CPU at tiny, f32


def _q8_sites(*modules) -> int:
    """The int8 dense sites (K1's, where no factored adapter reaches them) of
    ``modules``."""
    return sum(1 for root in modules for m in root.modules() if hasattr(m, "q8"))


def _tiny_encoder(root, prompts):
    """A BERT-style Hugging Face encoder (2 layers, width 32, seeded) with a
    ``vocab.txt`` of the prompts' words, written to ``root``."""
    import torch
    from transformers import BertConfig, BertModel, BertTokenizer

    root.mkdir(parents=True)
    words = sorted({w for p in prompts for w in p.lower().replace(",", " ").replace(".", " ").split()})
    (root / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]) + "\n")
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=len(words) + 5, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=64, max_position_embeddings=64)).save_pretrained(root)
    BertTokenizer(str(root / "vocab.txt")).save_pretrained(root)
    return root


def phase_evaluate(torch, backend, suite):
    """The evaluation harness and the user tools on :func:`phase_es_flagship`'s
    flagship backend and reward suite (no second 1.6 B model):

    - ``evaluate.run_benchmark.generate_folder`` over the 8 prompts of
      ``data/parti_prompts_sample.tsv`` (encoded by ``tools.encode_prompts``'
      hash fallback at the DiT's caption width into a Sana cache the backend
      loads), ``EVAL_BATCH`` a batch, once with θ = 0 (``--mode base``) and
      once with a θ saved by ``save_checkpoint`` and read back by
      ``run_benchmark.load_theta`` (``--mode lora``): 16 PNGs from one CUDA
      graph (the first batch its warm-up and capture, the 3 others replays);
      a replayed batch bitwise equal to the same batch run eagerly, and K1 on
      the device in a profiled replay as derived;
    - ``evaluate.score_folder`` over both folders with the suite's towers
      (CLIP-B/32 and CLIP-H/14, int8), text tables for the TSV's prompts:
      the files read back (``read_png`` + ``resize_bicubic``) score bitwise
      the same uint8 arrays resized in memory; per-category means, base
      against LoRA;
    - ``tools.demo``: a ``DemoEngine`` on the backend runs ``EVAL_TRIALS``
      blind trials through ``run_cli_trials`` (scripted votes, a seeded
      ``random.Random``), each pair one flush and one dispatch, its base
      image bitwise ``generate_one("base")`` at the same seed; then
      ``tools.vote_report`` (``main --out_json --fitness_out``) over its
      ``votes.jsonl``;
    - at tiny, on the card against ``--device cpu``: ``run_benchmark`` and
      ``score_folder --tiny_towers`` (images and report means within
      ``EVAL_TOL``), ``encode_prompts.encode_hf`` on a tiny encoder
      directory written here (within ``EVAL_TOL``), and a two-config
      ``tools.sweep`` through the train CLI on the card;
    - ``python -m hyperscalees_t2i_tpu_torch.evaluate.run_benchmark`` at
      tiny in a child process (started first; 8 PNGs, exit 0).

    The K1-K4 counters are set to 0 before each flagship part and read after:
    K1 exactly its derived sites × the eager calls (the graph's warm-up, the
    eager batch, the text tables, the scoring batches, the demo engine's
    admission probe and warm-up), K2-K4 none (a plain adapter reaches an
    int8 site through K1 and the plain LoRA delta: K3 is the factored ES
    member's route). Returns the numbers; ``launches`` sums the counted
    launches and ``launches_by_path`` splits them."""
    import copy
    import dataclasses
    import random
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark, score_folder
    from hyperscalees_t2i_tpu_torch.lora import stack_adapters
    from hyperscalees_t2i_tpu_torch.tools import demo, encode_prompts, sweep, vote_report
    from hyperscalees_t2i_tpu_torch.train.checkpoints import save_checkpoint
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache
    from hyperscalees_t2i_tpu_torch.utils.images import to_uint8
    from hyperscalees_t2i_tpu_torch.utils.prompt_cache import save_sana_cache
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_map

    root = ROOT / "build" / "evaluate"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rows = score_folder.load_parti_tsv(str(EVAL_TSV))
    prompts = [r["Prompt"] for r in rows]
    (root / "prompts.txt").write_text("\n".join(prompts) + "\n")
    tiny = ["--backend", "sana_one_step", "--model_scale", "tiny", "--prompts_txt", str(root / "prompts.txt"),
            "--lora_r", "2", "--lora_alpha", "4", "--batch_size", "4"]
    child_log = open(root / "child.txt", "w")
    code = (child_prelude() + "from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark; "
            f"run_benchmark.main({tiny + ['--out_dir', str(root / 'child')]!r})")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=child_log, stderr=subprocess.STDOUT)
    out, counted = {}, {}
    nothing = {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0, "decode_attention": 0}
    quiet = lambda msg: None  # noqa: E731
    try:
        # the TSV's prompts through the encoder's hash fallback into a Sana cache the backend's copy loads
        t0 = time.perf_counter()
        cfg = backend.cfg
        embeds, mask = encode_prompts.encode_hash_fallback(prompts, cfg.model.caption_dim, cfg.prompt_embed_len,
                                                           device="cuda")
        save_sana_cache(str(root / "parti.npz"), prompts, embeds, mask)
        ev = copy.copy(backend)  # shares every module; its own catalog
        ev.cfg = dataclasses.replace(cfg, encoded_prompt_path=str(root / "parti.npz"))
        ev.prompt_embeds = None
        ev.setup()
        if ev.texts != prompts or ev.model is not backend.model:
            raise AssertionError("evaluate: the cache did not become the backend copy's catalog")
        gen_sites = _q8_sites(ev.model, ev.vae)
        # the adapter: θ₀ with every b drawn, saved as a slot and read back
        template = ev.init_theta(threefry.prng_key(0, "cpu"))
        theta = ev.init_theta(threefry.prng_key(1, "cpu"))
        for i, (k, leaf) in enumerate(sorted(theta.items())):
            leaf["b"] = 0.05 * threefry.normal(threefry.fold_in(threefry.prng_key(2, "cpu"), i), leaf["b"].shape)
        save_checkpoint(root / "adapter", theta, 7, 0.5, ev.name)
        lora = run_benchmark.load_theta(ev, "lora", str(root / "adapter"))
        if any(not torch.equal(lora[k][f], theta[k][f]) for k in theta for f in theta[k]):
            raise AssertionError("evaluate: the adapter read back differs from the one saved")
        base = run_benchmark.load_theta(ev, "base", None)
        setup_s = time.perf_counter() - t0

        # generation: one graph for both folders
        programs = GraphCache("cuda")
        sinks, walls = {"base": [], "lora": []}, {}
        _reset_counters()
        for mode, th in (("base", base), ("lora", lora)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_benchmark.generate_folder(ev, th, root / mode, EVAL_BATCH, programs=programs, sink=sinks[mode],
                                          log=quiet)
            walls[mode] = time.perf_counter() - t0
        stacked = tree_map(lambda t: t.to("cuda"), stack_adapters([lora]))
        ids0 = torch.tensor([list(range(EVAL_BATCH))], dtype=torch.long).to("cuda")
        key0 = threefry.prng_key(0, "cuda")[None]
        key = ("benchmark", EVAL_BATCH)
        with torch.inference_mode():
            eager = GraphCache("cuda", graph=False)("eager", ev.generate_p, stacked, ids0, key0).clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay = programs(key, ev.generate_p, stacked, ids0, key0).clone()
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
        counted["generate"] = _counters()
        graph_vs_eager = _max_abs(replay, eager)
        folder_vs_eager = float(np.abs(np.stack(sinks["lora"][:EVAL_BATCH]) - eager[0].float().cpu().numpy()).max())
        if graph_vs_eager != 0.0 or folder_vs_eager != 0.0:
            raise AssertionError(f"evaluate: a replayed batch differs from the eager batch by {graph_vs_eager} "
                                 f"(the folder's by {folder_vs_eager})")
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            programs(key, ev.generate_p, stacked, ids0, key0)
            torch.cuda.synchronize()
        kernels, busy_ms, _, _ = device_kernels(torch, prof)
        replay_launches = profiled_launches(kernels)
        gen_expected = dict(nothing, int8_matmul=gen_sites * 2)  # the graph's warm-up and the eager batch
        if counted["generate"] != gen_expected or replay_launches != dict(nothing, int8_matmul=gen_sites):
            raise AssertionError(f"evaluate: generation counted {counted['generate']} (expected {gen_expected}), "
                                 f"a profiled replay {replay_launches} (expected K1 {gen_sites})")
        stats = programs.stats()[str(key)]
        if stats["replays"] != 5 or len(programs.entries) != 1:  # 3 in the folders, the checked and the profiled
            raise AssertionError(f"evaluate: {len(programs.entries)} programs, {stats['replays']} replays")
        files = {m: sorted((root / m).glob("*.png")) for m in ("base", "lora")}
        names = [f"{i:04d}_{run_benchmark.slugify(p)}.png" for i, p in enumerate(prompts)]
        if any([f.name for f in files[m]] != names for m in files):
            raise AssertionError(f"evaluate: the folders hold {[[f.name for f in v] for v in files.values()]}")
        for m, imgs in sinks.items():
            if any(im.shape != (1024, 1024, 3) or not np.isfinite(im).all() for im in imgs):
                raise AssertionError(f"evaluate: a {m} image is not finite [1024, 1024, 3]")
        base_vs_lora = max(float(np.abs(a - b).max()) for a, b in zip(sinks["base"], sinks["lora"]))
        if not base_vs_lora > 0:
            raise AssertionError("evaluate: the adapter did not change the images")
        out["generate"] = dict(
            images=2 * len(prompts), batch=EVAL_BATCH, k1_sites_per_call=gen_sites,
            k1_per_image=gen_sites / EVAL_BATCH, folder_s=walls, images_per_s={m: len(prompts) / w for m, w in
                                                                                walls.items()},
            replayed_batch_s=replay_s, replayed_batch_busy_ms=busy_ms, warmup_s=stats["warmup_s"],
            capture_s=stats["capture_s"], pool_gib=stats["pool_bytes"] / 2**30, graph_vs_eager_max_abs=graph_vs_eager,
            base_vs_lora_max_abs=base_vs_lora, setup_s=setup_s, launches_profiled_replay=replay_launches)
        log(f"[evaluate] generate_folder at the flagship: 2 × {len(prompts)} images, batch {EVAL_BATCH}; base "
            f"{walls['base']:.3f} s (warm-up {stats['warmup_s']:.3f} s, capture {stats['capture_s']:.3f} s), lora "
            f"{walls['lora']:.3f} s ({len(prompts) / walls['lora']:.3f} images/s with PNG writes); a replayed batch "
            f"{replay_s:.3f} s, busy {busy_ms:.1f} ms on the device; graph vs eager max abs {graph_vs_eager}; K1 "
            f"{gen_sites} a call ({gen_sites / EVAL_BATCH:.2f} an image), counted {counted['generate']}, a profiled "
            f"replay {replay_launches}")

        # scoring: the TSV's text tables through the suite's towers, both folders, files against memory
        _reset_counters()
        t0 = time.perf_counter()
        reward = score_folder.reward_for_prompts(suite.clip_model, prompts, "openai/clip-vit-base-patch32",
                                                 suite.pick_model, "yuvalkirstain/PickScore_v1")
        table_s = time.perf_counter() - t0
        towers = [t for t in (suite.clip_model, suite.pick_model) if t is not None]
        image_sites = sum(_q8_sites(t.patch_embed, t.vision, t.visual_projection) for t in towers)
        text_sites = sum(_q8_sites(t) for t in towers) - image_sites
        reports, score_s = {}, {}
        for m in ("base", "lora"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per_file, order = score_folder.score_images(reward, score_folder.index_folder(root / m), len(prompts),
                                                        len(prompts), 224, torch.device("cuda"), log=quiet)
            score_s[m] = time.perf_counter() - t0
            arrays = [(i, to_uint8(im)) for i, im in enumerate(sinks[m])]
            per_mem, _ = score_folder.score_images(reward, arrays, len(prompts), len(prompts), 224,
                                                   torch.device("cuda"), load=score_folder.prepare_images, log=quiet)
            diff = max(float(np.abs(per_file[k] - per_mem[k]).max()) for k in per_file)
            if diff != 0.0 or order != list(range(len(prompts))):
                raise AssertionError(f"evaluate: {m} scores of the PNG files differ from the in-memory arrays' by "
                                     f"{diff}")
            reports[m] = score_folder.build_report(per_file, order, rows)
            if not all(np.isfinite(v).all() for v in per_file.values()):
                raise AssertionError(f"evaluate: {m} scores not finite")
        counted["score"] = _counters()
        score_expected = dict(nothing, int8_matmul=text_sites + image_sites * 4)  # 2 folders × (files, memory)
        if counted["score"] != score_expected:
            raise AssertionError(f"evaluate: scoring counted {counted['score']}, expected {score_expected}")
        cats = sorted(g for g in reports["base"] if g.startswith("category/"))
        out["score"] = dict(reports=reports, folder_s=score_s, s_per_image={m: s / len(prompts)
                                                                              for m, s in score_s.items()},
                            text_tables_s=table_s, k1_text_sites=text_sites, k1_image_sites_per_call=image_sites,
                            png_round_trip_max_abs=0.0)
        log(f"[evaluate] score_folder, {len(prompts)} images a folder in one batch: base {score_s['base']:.3f} s, lora "
            f"{score_s['lora']:.3f} s ({score_s['lora'] / len(prompts):.3f} s an image: read, bicubic, towers); PNG "
            f"round trip bitwise; K1 {text_sites} text + {image_sites} image sites a call, counted {counted['score']}; "
            f"combined base {reports['base']['overall']['combined']:.6f} against lora "
            f"{reports['lora']['overall']['combined']:.6f}; by category "
            + ", ".join(f"{c[9:]} {reports['base'][c]['combined']:.4f}/{reports['lora'][c]['combined']:.4f}"
                        for c in cats))

        # the demo: blind pairs through the serving engine, then the vote report
        _reset_counters()
        eng = demo.DemoEngine(ev, lora, theta_template=template)
        session = demo.BlindABSession(eng, rng=random.Random(0), record_dir=root / "demo")
        trials = []
        new_trial = session.new_trial
        session.new_trial = lambda g=None: trials.append(new_trial(g)) or trials[-1]
        votes = iter("ABBA")
        dispatches = eng.serve.registry.value("serve_dispatches", 0)
        t0 = time.perf_counter()
        scores = demo.run_cli_trials(session, EVAL_TRIALS, root / "demo" / "trials", input_fn=lambda _: next(votes))
        demo_s = time.perf_counter() - t0
        pairs = eng.serve.registry.value("serve_dispatches", 0) - dispatches
        (label,) = eng.serve.admission
        probes = len(eng.serve.admission[label].get("probe_bytes", {}))
        counted["demo"] = _counters()
        demo_expected = dict(nothing, int8_matmul=gen_sites * (1 + probes))  # the admission probes and the warm-up
        solo = []
        for t in trials:
            pair_base = t.img_a if t.mapping["A"] == "base" else t.img_b
            solo.append(int(np.abs(pair_base.astype(int) - eng.generate_one("base", t.prompt_index, t.seed)).max()))
        if pairs != EVAL_TRIALS or any(solo) or counted["demo"] != demo_expected or scores["n_trials"] != EVAL_TRIALS:
            raise AssertionError(f"demo: {pairs} dispatches for {EVAL_TRIALS} pairs, solo differences {solo}, "
                                 f"counted {counted['demo']} (expected {demo_expected}), scores {scores}")
        pair_s = eng.serve.dispatch_seconds[:EVAL_TRIALS]
        votes_path = root / "demo" / "votes.jsonl"
        vote_report.main([str(votes_path), "--out_json", str(root / "demo" / "report.json"),
                          "--fitness_out", str(root / "demo" / "fitness.jsonl")])
        rep = json.loads((root / "demo" / "report.json").read_text())
        fit = [json.loads(l) for l in (root / "demo" / "fitness.jsonl").read_text().splitlines()]
        if rep != vote_report.report(vote_report.load_votes(votes_path)) or rep["overall"]["n"] != EVAL_TRIALS or \
                [r["adapter"] for r in fit] != ["lora", "base"]:
            raise AssertionError(f"vote_report: {rep['overall']}, fitness {[r['adapter'] for r in fit]}")
        out["demo"] = dict(trials=EVAL_TRIALS, wall_s=demo_s, pair_dispatch_s=pair_s, admission_probes=probes,
                           scores=scores, report=rep["overall"], serve_compiles=eng.serve.registry.value(
                               "serve_compiles", 0),
                           draws=[(t.prompt_index, t.seed, t.mapping["A"]) for t in trials])
        log(f"[evaluate] demo: {EVAL_TRIALS} blind pairs in {demo_s:.3f} s, one dispatch each "
            f"({', '.join(f'{s:.3f}' for s in pair_s)} s), base image bitwise the solo generate_one; admission "
            f"probes {probes}; K1 counted {counted['demo']}; vote report {rep['overall']}")
        del eng, session, trials

        # card against CPU at tiny: run_benchmark + score_folder, the encoder, then a sweep on the card
        t0 = time.perf_counter()
        tiny_imgs, tiny_reports = {}, {}
        _reset_counters()
        for dev in ("cuda", "cpu"):
            args = run_benchmark.build_parser().parse_args([*tiny, "--out_dir", str(root / f"tiny_{dev}"),
                                                            "--device", dev])
            b = run_benchmark.make_backend(args)
            tiny_imgs[dev] = []
            run_benchmark.generate_folder(b, run_benchmark.load_theta(b, "base", None), args.out_dir, args.batch_size,
                                          sink=tiny_imgs[dev], log=quiet)
            tiny_reports[dev] = score_folder.main(["--folder", args.out_dir, "--parti_tsv", str(EVAL_TSV),
                                                   "--tiny_towers", "--image_size", "32", "--batch_size", "4",
                                                   "--device", dev])
        img_err = max(float(np.abs(a - b).max()) for a, b in zip(tiny_imgs["cuda"], tiny_imgs["cpu"]))
        mean_err = max(abs(tiny_reports["cuda"][g][k] - tiny_reports["cpu"][g][k])
                       for g in tiny_reports["cpu"] if g != "num_images" for k in tiny_reports["cpu"][g])
        enc = _tiny_encoder(root / "encoder", prompts)
        encoded = {dev: encode_prompts.encode_hf(prompts, str(enc), 16, 4, device=dev) for dev in ("cuda", "cpu")}
        enc_err = float(np.abs(encoded["cuda"][0] - encoded["cpu"][0]).max())
        if img_err > EVAL_TOL or mean_err > EVAL_TOL or enc_err > EVAL_TOL or \
                not np.array_equal(encoded["cuda"][1], encoded["cpu"][1]) or len(tiny_imgs["cuda"]) != len(prompts):
            raise AssertionError(f"evaluate at tiny: card against CPU images {img_err}, report means {mean_err}, "
                                 f"encoder {enc_err} (tolerance {EVAL_TOL})")
        ranked = sweep.run_sweep([{"sigma": 0.05, "num_epochs": 1}, {"sigma": 0.01, "num_epochs": 1}], root / "sweep",
                                 ["--backend", "sana_one_step", "--model_scale", "tiny", "--device", "cuda",
                                  "--prompts_txt", str(root / "prompts.txt"), "--lora_r", "2", "--pop_size", "4",
                                  "--prompts_per_gen", "2", "--save_every", "1", "--quality", "false"])
        if len(ranked) != 2 or any("error" in r or not math.isfinite(r["summary_mean_reward"]) for r in ranked):
            raise AssertionError(f"sweep: {ranked}")
        counted["tiny"] = _counters()
        if counted["tiny"] != nothing:
            raise AssertionError(f"evaluate at tiny launched {counted['tiny']} (a float base: none)")
        out["tiny"] = dict(image_max_abs=img_err, report_mean_max_abs=mean_err, encoder_max_abs=enc_err,
                           sweep=[{k: r[k] for k in ("run_name", "summary_mean_reward", "epoch")} for r in ranked],
                           wall_s=time.perf_counter() - t0)
        log(f"[evaluate] tiny, card against CPU: images {img_err:.3g}, report means {mean_err:.3g}, encode_hf "
            f"{enc_err:.3g} (tolerance {EVAL_TOL}); sweep on the card {out['tiny']['sweep']}; "
            f"{out['tiny']['wall_s']:.1f} s")
        rc = child.wait(timeout=300)
        child_pngs = sorted(p.name for p in (root / "child").glob("*.png"))
        if rc != 0 or child_pngs != names:
            raise AssertionError(f"run_benchmark's command line exited {rc} with {child_pngs} "
                                 f"({(root / 'child.txt').read_text()[-2000:]})")
        out["child"] = dict(rc=rc, images=len(child_pngs))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child_log.close()
    out["launches"] = {k: sum(c[k] for c in counted.values()) for k in nothing}
    out["launches_by_path"] = {"evaluate_generate": counted["generate"], "evaluate_score": counted["score"],
                               "demo_pairs": counted["demo"], "evaluate_generate_profiled_replay": replay_launches}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Released-layout checkpoints: the key inventories of the released files at a
# config's geometry, seeded numpy values, and the phases that train from them
# ---------------------------------------------------------------------------

WEIGHTS_POOL = 1 << 22  # normals drawn per checkpoint; each tensor copies random windows of them
RELEASED_BUFFERS = ("zero_k_bias", "lvl_1L", "attn_bias_for_masking", "ema_vocab_hit_SV")


def released_var_keys(cfg):
    """``[(name, torch shape)]`` of ``var_d*.pth`` at a ``VARConfig``'s
    geometry: the embeddings, the position tables and the registered
    buffers, per block the AdaLN linear, the fused qkv with its q/v biases,
    zero-k buffer and QK-l2 scales, the projection and the FFN, then the
    head's AdaLN and the head."""
    C, L, S = cfg.d_model, cfg.seq_len, len(cfg.patch_nums)
    hid, V, cv = int(round(C * cfg.ff_ratio)), cfg.vq.vocab_size, cfg.vq.c_vae
    keys = [("pos_start", (1, 1, C)), ("pos_1LC", (1, L, C)), ("lvl_1L", (1, L)),
            ("attn_bias_for_masking", (1, 1, L, L)), ("word_embed.weight", (C, cv)), ("word_embed.bias", (C,)),
            ("class_emb.weight", (cfg.num_classes + 1, C)), ("lvl_embed.weight", (S, C))]
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        keys += [(b + "attn.scale_mul_1H11", (1, cfg.n_heads, 1, 1)), (b + "attn.q_bias", (C,)),
                 (b + "attn.v_bias", (C,)), (b + "attn.zero_k_bias", (C,)), (b + "attn.mat_qkv.weight", (3 * C, C)),
                 (b + "attn.proj.weight", (C, C)), (b + "attn.proj.bias", (C,)), (b + "ffn.fc1.weight", (hid, C)),
                 (b + "ffn.fc1.bias", (hid,)), (b + "ffn.fc2.weight", (C, hid)), (b + "ffn.fc2.bias", (C,)),
                 (b + "ada_lin.1.weight", (6 * C, C)), (b + "ada_lin.1.bias", (6 * C,))]
    return keys + [("head_nm.ada_lin.1.weight", (2 * C, C)), ("head_nm.ada_lin.1.bias", (2 * C,)),
                   ("head.weight", (V, C)), ("head.bias", (V,))]


def _conv_keys(name, cout, cin, k):
    return [(f"{name}.weight", (cout, cin, k, k)), (f"{name}.bias", (cout,))]


def _res_keys(p, cin, cout):
    keys = [(p + "norm1.weight", (cin,)), (p + "norm1.bias", (cin,)), *_conv_keys(p + "conv1", cout, cin, 3),
            (p + "norm2.weight", (cout,)), (p + "norm2.bias", (cout,)), *_conv_keys(p + "conv2", cout, cout, 3)]
    return keys + (_conv_keys(p + "nin_shortcut", cout, cin, 1) if cin != cout else [])


def _attn_keys(p, c):
    return [(p + "norm.weight", (c,)), (p + "norm.bias", (c,)), *_conv_keys(p + "qkv", 3 * c, c, 1),
            *_conv_keys(p + "proj_out", c, c, 1)]


def _mid_keys(p, c, attn: bool):
    return _res_keys(p + "block_1.", c, c) + (_attn_keys(p + "attn_1.", c) if attn else []) + \
        _res_keys(p + "block_2.", c, c)


def _compvis_keys(z, ch, mult, nrb, using_sa: bool, using_mid_sa: bool):
    """The CompVis encoder's and decoder's ``[(name, torch shape)]`` for a
    ``z``-channel latent: ``nrb`` blocks a down level, ``nrb + 1`` an up
    level, attention at the deepest level where ``using_sa``."""
    n = len(mult)
    keys = _conv_keys("encoder.conv_in", ch, 3, 3)
    block_in = ch
    for i in range(n):
        block_in, block_out = ch * ((1,) + mult)[i], ch * mult[i]
        for j in range(nrb):
            keys += _res_keys(f"encoder.down.{i}.block.{j}.", block_in, block_out)
            block_in = block_out
            if i == n - 1 and using_sa:
                keys += _attn_keys(f"encoder.down.{i}.attn.{j}.", block_in)
        if i != n - 1:
            keys += _conv_keys(f"encoder.down.{i}.downsample.conv", block_in, block_in, 3)
    keys += _mid_keys("encoder.mid.", block_in, using_mid_sa)
    keys += [("encoder.norm_out.weight", (block_in,)), ("encoder.norm_out.bias", (block_in,)),
             *_conv_keys("encoder.conv_out", z, block_in, 3)]
    block_in = ch * mult[-1]
    keys += _conv_keys("decoder.conv_in", block_in, z, 3) + _mid_keys("decoder.mid.", block_in, using_mid_sa)
    for i in reversed(range(n)):
        for j in range(nrb + 1):
            keys += _res_keys(f"decoder.up.{i}.block.{j}.", block_in, ch * mult[i])
            block_in = ch * mult[i]
            if i == n - 1 and using_sa:
                keys += _attn_keys(f"decoder.up.{i}.attn.{j}.", block_in)
        if i != 0:
            keys += _conv_keys(f"decoder.up.{i}.upsample.conv", block_in, block_in, 3)
    return keys + [("decoder.norm_out.weight", (block_in,)), ("decoder.norm_out.bias", (block_in,)),
                   *_conv_keys("decoder.conv_out", 3, block_in, 3)]


def released_vqvae_keys(vq):
    """``[(name, torch shape)]`` of ``vae_ch160v4096z32.pth`` at an
    ``MSVQConfig``'s geometry: the codebook and its EMA buffer, the φ convs,
    ``quant_conv`` and ``post_quant_conv``, the CompVis encoder (which the
    converters ignore) and decoder."""
    z = vq.c_vae
    keys = [("quantize.embedding.weight", (vq.vocab_size, z)),
            ("quantize.ema_vocab_hit_SV", (len(vq.patch_nums), vq.vocab_size))]
    for k in range(vq.phi_partial):
        keys += _conv_keys(f"quantize.quant_resi.qresi_ls.{k}", z, z, 3)
    keys += _conv_keys("quant_conv", z, z, 3) + _conv_keys("post_quant_conv", z, z, 3)
    return keys + _compvis_keys(z, vq.ch, tuple(vq.ch_mult), vq.num_res_blocks, vq.using_sa, vq.using_mid_sa)


# the released Infinity transformer's scale table (lvl_embed) is longer than
# the 1M schedule's 14 scales: the converter keeps the schedule's first rows
RELEASED_INF_LEVELS = 15
# the released T5 null sequence (cfg_uncond) is a full text length of rows;
# the converter folds their mean into one null token
RELEASED_INF_TEXT_LEN = 512


def released_infinity_keys(cfg, shared_aln: bool = True):
    """``[(name, torch shape)]`` of an Infinity transformer ``.pth`` at an
    ``InfinityConfig``'s geometry, every tensor that ``weights/infinity.py``'s
    table reads: the bit-label embedding, the scale table
    (``RELEASED_INF_LEVELS`` rows), ``pos_start``, both text projections and
    the null text sequence; per block the fused qkv with its q/v biases and
    the zero-k buffer, the QK-l2 scales of self-attention (and of
    cross-attention where ``cross_attn_l2_norm``: ``infer_infinity_config``
    reads the heads off their ``(1, H, 1, 1)`` shape), the projections, the
    cross-attention's q and kv, the FFN, and the AdaLN: with
    ``shared_aln`` (the released Infinity-2B's, ≈ 2.2 B values at its
    geometry) one ``shared_ada_lin.1`` and a ``ada_gss`` table a block, else
    an ``ada_lin.1`` linear a block; the head's AdaLN and the head; and the
    registered buffers ``lvl_1L`` and ``attn_bias_for_masking`` (which the
    converter ignores by name)."""
    C, L, H, D = cfg.d_model, cfg.seq_len, cfg.n_heads, cfg.depth
    hid, bits, T = int(round(C * cfg.ff_ratio)), cfg.vq.bits, cfg.text_dim
    keys = [("word_embed.weight", (C, bits)), ("word_embed.bias", (C,)),
            ("lvl_embed.weight", (max(RELEASED_INF_LEVELS, len(cfg.patch_nums)), C)), ("pos_start", (1, 1, C)),
            ("text_proj_for_ca.weight", (C, T)), ("text_proj_for_ca.bias", (C,)),
            ("text_proj_for_sos.weight", (C, C)), ("text_proj_for_sos.bias", (C,)),
            ("cfg_uncond", (RELEASED_INF_TEXT_LEN, T)), ("lvl_1L", (1, L)), ("attn_bias_for_masking", (1, 1, L, L))]
    if shared_aln:
        keys += [("shared_ada_lin.1.weight", (6 * C, C)), ("shared_ada_lin.1.bias", (6 * C,))]
    for i in range(D):
        b = f"blocks.{i}."
        keys += [(b + "sa.mat_qkv.weight", (3 * C, C)), (b + "sa.q_bias", (C,)), (b + "sa.v_bias", (C,)),
                 (b + "sa.zero_k_bias", (C,)), (b + "sa.proj.weight", (C, C)), (b + "sa.proj.bias", (C,))]
        if cfg.attn_l2_norm:
            keys.append((b + "sa.scale_mul_1H11", (1, H, 1, 1)))
        keys += [(b + "ca.mat_q.weight", (C, C)), (b + "ca.mat_q.bias", (C,)), (b + "ca.mat_kv.weight", (2 * C, C)),
                 (b + "ca.mat_kv.bias", (2 * C,)), (b + "ca.proj.weight", (C, C)), (b + "ca.proj.bias", (C,))]
        if cfg.cross_attn_l2_norm:
            keys.append((b + "ca.scale_mul_1H11", (1, H, 1, 1)))
        keys += [(b + "ffn.fc1.weight", (hid, C)), (b + "ffn.fc1.bias", (hid,)), (b + "ffn.fc2.weight", (C, hid)),
                 (b + "ffn.fc2.bias", (C,))]
        keys += [(b + "ada_gss", (1, 1, 6, C))] if shared_aln else \
            [(b + "ada_lin.1.weight", (6 * C, C)), (b + "ada_lin.1.bias", (6 * C,))]
    return keys + [("head_nm.ada_lin.1.weight", (2 * C, C)), ("head_nm.ada_lin.1.bias", (2 * C,)),
                   ("head.weight", (2 * bits, C)), ("head.bias", (2 * bits,))]


def released_bsq_keys(vq):
    """``[(name, torch shape)]`` of a BSQ tokenizer ``.pth`` at a
    ``BSQConfig``'s geometry: its ``phi_partial`` φ convs
    (``quantize.quant_resi.qresi_ls.*``), ``quant_conv`` and
    ``post_quant_conv``, and a CompVis encoder (which the converter ignores)
    and decoder at the config's decoder widths: ``ch`` the shallowest of
    ``dec_ch``, one level per width, ``dec_blocks`` + 1 blocks an up level,
    mid attention, so the decoder upsamples the grid as the native one does
    (the released tokenizer's own widths are not in this repository)."""
    z, ch = vq.bits, vq.dec_ch[-1]
    mult = tuple(c // ch for c in reversed(vq.dec_ch))
    keys = []
    for k in range(vq.phi_partial):
        keys += _conv_keys(f"quantize.quant_resi.qresi_ls.{k}", z, z, 3)
    keys += _conv_keys("quant_conv", z, z, 3) + _conv_keys("post_quant_conv", z, z, 3)
    return keys + _compvis_keys(z, ch, mult, vq.dec_blocks, False, True)


def released_sana_keys(cfg):
    """``[(name, torch shape)]`` of a diffusers ``SanaTransformer2DModel``
    (the Sprint layout: the timestep and guidance embedders under
    ``time_embed``) at a ``SanaConfig``'s geometry: q/k/v without bias, the
    GLUMBConv's 1×1, depthwise 3×3 and bias-free 1×1 convs, the per-block
    and final scale-shift tables."""
    d, cap, p, hid = cfg.d_model, cfg.caption_dim, cfg.patch_size, int(round(cfg.d_model * cfg.ff_ratio))
    out = p * p * cfg.out_channels
    keys = _conv_keys("patch_embed.proj", d, cfg.in_channels, p)
    for emb in ("timestep_embedder", "guidance_embedder")[:2 if cfg.guidance_embeds else 1]:
        keys += [(f"time_embed.{emb}.linear_1.weight", (d, cfg.time_freq_dim)), (f"time_embed.{emb}.linear_1.bias", (d,)),
                 (f"time_embed.{emb}.linear_2.weight", (d, d)), (f"time_embed.{emb}.linear_2.bias", (d,))]
    keys += [("time_embed.linear.weight", (6 * d, d)), ("time_embed.linear.bias", (6 * d,)),
             ("caption_norm.weight", (cap,)), ("caption_projection.linear_1.weight", (d, cap)),
             ("caption_projection.linear_1.bias", (d,)), ("caption_projection.linear_2.weight", (d, d)),
             ("caption_projection.linear_2.bias", (d,))]
    for i in range(cfg.n_layers):
        b = f"transformer_blocks.{i}."
        keys.append((b + "scale_shift_table", (6, d)))
        for a in ("attn1", "attn2"):
            keys += [(f"{b}{a}.{w}.weight", (d, d)) for w in ("to_q", "to_k", "to_v")]
            keys += [(f"{b}{a}.to_out.0.weight", (d, d)), (f"{b}{a}.to_out.0.bias", (d,))]
        keys += [(b + "ff.conv_inverted.weight", (2 * hid, d, 1, 1)), (b + "ff.conv_inverted.bias", (2 * hid,)),
                 (b + "ff.conv_depth.weight", (2 * hid, 1, 3, 3)), (b + "ff.conv_depth.bias", (2 * hid,)),
                 (b + "ff.conv_point.weight", (d, hid, 1, 1))]
    return keys + [("scale_shift_table", (2, d)), ("proj_out.weight", (out, d)), ("proj_out.bias", (out,))]


class ReleasedValues:
    """Seeded numpy values for a released-layout state dict: one pool of
    ``WEIGHTS_POOL`` standard normals from ``default_rng(seed)``, each tensor
    filled from random windows of it (so a multi-GB checkpoint is made at
    copy speed) and scaled as a trained model's would be: ``1/√fan_in`` for
    matrices and kernels, 0.02 for biases and position tables, 1 + 0.02·n
    for norm weights, log 4 + 0.1·n for the QK-l2 scales, zeros for the
    registered buffers."""

    def __init__(self, seed: int):
        import numpy as np

        self.np = np
        self.rng = np.random.default_rng(seed)
        self.pool = self.rng.standard_normal(WEIGHTS_POOL, dtype=np.float32)

    def __call__(self, name: str, shape) -> "object":
        np = self.np
        n = int(np.prod(shape, dtype=np.int64))
        if name.split(".")[-1] in RELEASED_BUFFERS:
            return np.zeros(shape, np.float32)
        out = np.empty(n, np.float32)
        done = 0
        while done < n:
            k = min(n - done, WEIGHTS_POOL // 2)
            off = int(self.rng.integers(0, WEIGHTS_POOL - k + 1))
            out[done:done + k] = self.pool[off:off + k]
            done += k
        out = out.reshape(shape)
        last = name.split(".")[-1]
        if last == "scale_mul_1H11":
            out = out * np.float32(0.1) + np.float32(math.log(4.0))
        elif len(shape) == 1 and "norm" in name and last == "weight":
            out = out * np.float32(0.02) + np.float32(1.0)
        elif len(shape) == 1 or last in ("pos_start", "pos_1LC"):
            out *= np.float32(0.02)
        else:
            out *= np.float32(1.0 / math.sqrt(int(np.prod(shape[1:]))))
        return out


def released_state_dict(keys, seed: int):
    """``{name: f32 ndarray}`` for ``keys`` from :class:`ReleasedValues`."""
    values = ReleasedValues(seed)
    return {name: values(name, shape) for name, shape in keys}


def write_released_safetensors(path, keys, seed: int) -> int:
    """``keys`` as a bf16 ``.safetensors`` file (the released dtype), each
    tensor made when its bytes are written and cut to bf16 by truncation;
    returns the bytes written."""
    import numpy as np

    from hyperscalees_t2i_tpu_torch.weights.io import save_safetensors

    values = ReleasedValues(seed)
    bf16 = lambda name, shape: (values(name, shape).view(np.uint32) >> 16).astype(np.uint16)  # noqa: E731
    return save_safetensors(path, {name: ("BF16", shape, lambda n=name, s=shape: bf16(n, s)) for name, shape in keys},
                            metadata={"format": "pt"})


def write_released_pth(path, keys, seed: int) -> int:
    """``keys`` as a bf16 torch pickle (the released dtype of a ``.pth``),
    each tensor made from :class:`ReleasedValues` and rounded to bf16 as it
    is added, so the host holds the f32 values of one tensor at a time;
    returns the file's bytes."""
    import torch

    values = ReleasedValues(seed)
    torch.save({name: torch.from_numpy(values(name, shape)).to(torch.bfloat16) for name, shape in keys}, path)
    return Path(path).stat().st_size


class HostPeak:
    """The process's peak resident set over a block, the largest ``VmRSS``
    a 20 ms sampler thread saw (``gib`` after the block), beside its
    resident set when the block began (``start_gib``: what earlier phases
    left resident)."""

    def __enter__(self):
        import threading

        self.seen, self.stop = self._rss(), threading.Event()
        self.start_gib = self.seen / 2**30

        def sample():
            while not self.stop.wait(0.02):
                self.seen = max(self.seen, self._rss())

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        return 0

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.gib = max(self.seen, self._rss()) / 2**30


def expected_var_launches(backend, reward, tc, batch: int):
    """K4's launches of one VAR ES step over a float base (one a layer a
    scale a generate call), the form of :func:`expected_es_launches`; a
    base or tower with int8 nodes, or ``pop_fuse``, is not this phase's
    path and raises."""
    towers = [t for t in (reward.clip_model, reward.pick_model) if t is not None]
    if tc.pop_fuse or any(hasattr(m, "q8") for part in [backend.model, *towers] for m in part.modules()):
        raise AssertionError("the VAR checkpoint phase runs a float base without pop_fuse")
    cfg = backend.cfg.model
    k4, calls = len(cfg.patch_nums) * cfg.depth, reward_calls(tc, batch)
    return ({"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0, "decode_attention": k4 * calls},
            {"k1_per_call": 0, "k2_per_call": 0, "k3_per_call": 0, "k4_per_call": k4, "calls": calls})


def _cli_graph_run(torch, argv, what: str, expected, against_eager: bool = True):
    """The train CLI's ``main(argv)`` on the card, its ``run_training``
    taken by :func:`_graph_run` (a CUDA graph, its warm-up counted, a
    profiled replayed epoch, and with ``against_eager`` one epoch against
    eager, bitwise). Times each stage of the checkpoint's way in:
    ``read_s`` (``weights.io.load_state_dict``, a tokenizer read inside the
    backend's ``setup`` included), ``convert_s`` (the converters), ``to_device_s``
    (``tree_from_numpy``), ``rewards_s`` (``build_reward_fn``: the towers,
    their text tables, the tokenizer), ``build_s`` (the rest from
    ``build_backend`` to the loop: quantization, the random decoder, the
    modules), with the host's peak resident set over the CLI's run and the
    device's peak allocation over it (``device_peak_gib``; the graph's
    pool apart, in ``memory``) and up to the loop (``build_peak_gib``: the
    converted tree's transient), and whether the run's θ is finite. Returns
    ``(numbers, backend, reward)``: the CLI's backend and reward suite,
    still built."""
    from hyperscalees_t2i_tpu_torch.train import cli, trainer
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves
    from hyperscalees_t2i_tpu_torch.weights import from_jax, infinity as winf, io as wio, sana as wsana, var as wvar

    stages = {"read_s": 0.0, "convert_s": 0.0, "to_device_s": 0.0, "rewards_s": 0.0}
    rec = {}

    def timed(fn, stage):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stages[stage] += time.perf_counter() - t0
        return call

    patched = [(wio, "load_state_dict", "read_s"), (wvar, "convert_var_transformer", "convert_s"),
               (wvar, "convert_vqvae", "convert_s"), (wsana, "convert_sana_transformer", "convert_s"),
               (winf, "convert_infinity_transformer", "convert_s"), (winf, "convert_bsq_vae", "convert_s"),
               (from_jax, "tree_from_numpy", "to_device_s"), (cli, "build_reward_fn", "rewards_s")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    real_build, real_run = cli.build_backend, trainer.run_training

    def build(args, device):
        rec["t_build"] = time.perf_counter()
        rec["backend"] = real_build(args, device)
        return rec["backend"]

    def run(backend, reward, tc, device=None, **kw):
        trainer.run_training = real_run
        rec["t_run"] = time.perf_counter()
        rec["build_peak"] = torch.cuda.max_memory_allocated()
        state, rec["stats"] = _graph_run(torch, backend, reward, tc, torch.cuda.memory_allocated(), what,
                                         against_eager=against_eager, bitwise=True, expected=expected)
        rec["reward"] = reward
        rec["theta_finite"] = all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.theta))
        return state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for mod, name, stage in patched:
            setattr(mod, name, timed(getattr(mod, name), stage))
        cli.build_backend, trainer.run_training = build, run
        with HostPeak() as host:
            cli.main(argv)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        cli.build_backend, trainer.run_training = real_build, real_run
    stats = rec["stats"]
    graph = stats["graph"]
    stages["build_s"] = rec["t_run"] - rec["t_build"] - sum(stages.values())
    stages["capture_s"] = graph["warmup_s"] + graph["capture_s"] + graph["instantiate_s"]
    stages["epoch_s"] = stats["epoch_s"]
    mem = stats["memory"]
    device_peak = max(rec["build_peak"] / 2**30, mem["run_peak_allocated_gib"], mem["peak_allocated_gib"])
    numbers = dict(stages=stages, host_peak_rss_gib=host.gib, host_rss_start_gib=host.start_gib,
                   device_peak_gib=device_peak, build_peak_gib=rec["build_peak"] / 2**30,
                   theta_finite=rec["theta_finite"], **stats)
    return numbers, rec["backend"], rec["reward"]


def _has(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


def _checkpoint_dir():
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))


def phase_weights_var(torch):
    """VAR-d16 trained from a ``.pth`` pair in the released layout: a
    ``var_d16.pth`` at the ``ar_d16`` rung's geometry (f32) and a
    ``vae_ch160v4096z32.pth`` with its encoder, ``quant_conv`` and codebook
    EMA buffer (which the converter must ignore), seeded numpy values
    (:class:`ReleasedValues`), written into a temporary directory deleted
    afterwards. The train CLI's ``main`` with ``--backend var --weights
    --vae_weights`` at the rung's plan (pop 16, 4 classes of its 16,
    member_batch 4, its knobs; the CLI's CLIP-B/32 random tower, PickScore
    dropped): one run_training epoch, the warm-up and capture, then
    :func:`_cli_graph_run`'s profiled replayed epoch (K4 160 a generate
    call, counted at the warm-up and on the device, the graph against an
    eager epoch bitwise). Checks:
    ``infer_var_config`` gives the rung's ``VARConfig`` field by field; the
    converted tree's structure, shapes and dtypes after the rung's bf16 cast
    are ``init_var``'s; θ finite."""
    import shutil

    from hyperscalees_t2i_tpu_torch.models import var as var_mod
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, rung_opt, var_rung_model
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.pytree import cast_floating, tree_map

    scale, pop, m, mb = RUNG_PLAN["ar_d16"]
    opt = rung_opt("ar_d16")
    model = var_rung_model(scale, tower_dtype=opt["tower_dtype"])["bcfg"].model
    tmp = _checkpoint_dir()
    try:
        t0 = time.perf_counter()
        sd = released_state_dict(released_var_keys(model), seed=16)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp / "var_d16.pth")
        vsd = released_state_dict(released_vqvae_keys(model.vq), seed=17)
        torch.save({k: torch.from_numpy(v) for k, v in vsd.items()}, tmp / "vae_ch160v4096z32.pth")
        write_s = time.perf_counter() - t0
        sizes = {n: (tmp / n).stat().st_size for n in ("var_d16.pth", "vae_ch160v4096z32.pth")}
        ignored = sum(1 for k in vsd if k.startswith(("encoder.", "quant_conv.", "quantize.ema")))
        del sd, vsd
        argv = ["--backend", "var", "--weights", str(tmp / "var_d16.pth"), "--vae_weights",
                str(tmp / "vae_ch160v4096z32.pth"), "--var_classes", ",".join(str(c) for c in range(16)),
                "--pop_size", str(pop), "--prompts_per_gen", str(m), "--member_batch", str(mb), "--num_epochs", "1",
                "--reward_tile", str(opt["reward_tile"]), "--noise_dtype", opt["noise_dtype"],
                "--tower_dtype", opt["tower_dtype"], "--pop_fuse", str(opt["pop_fuse"]).lower(),
                "--base_quant", opt["base_quant"], "--allow_random_rewards", "true", "--run_dir", str(tmp),
                "--run_name", "var_d16", "--resume", "false"]
        run, backend, reward = _cli_graph_run(torch, argv, "weights_var", expected_var_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = backend.cfg.model
    if got != model:
        diff = {f: (getattr(got, f), getattr(model, f)) for f in model.__dataclass_fields__
                if getattr(got, f) != getattr(model, f)}
        raise AssertionError(f"infer_var_config gave {diff} against the ar_d16 rung's VARConfig")
    dt = model.compute_dtype
    converted = tree_map(lambda t: (tuple(t.shape), dt if t.dtype.is_floating_point else t.dtype), backend.param_shapes)
    init = tree_map(lambda t: (tuple(t.shape), t.dtype),
                    cast_floating(var_mod.init_var(model, threefry.prng_key(0, "cuda")), dt))
    if converted != init:
        raise AssertionError("the converted VAR-d16 tree's structure, shapes or dtypes are not init_var's")
    if run["per_call"]["k4_per_call"] != 160:
        raise AssertionError(f"VAR-d16 from the checkpoint launched K4 {run['per_call']} a call, not 160")
    del init
    st = run["stages"]
    log(f"[weights-var] var_d16.pth {sizes['var_d16.pth'] / 2**30:.3f} GiB + vae {sizes['vae_ch160v4096z32.pth'] / 2**30:.3f} "
        f"GiB ({ignored} encoder/quant_conv/EMA tensors the converter ignores): write {write_s:.2f} s, read "
        f"{st['read_s']:.2f} s, convert {st['convert_s']:.2f} s, to the card {st['to_device_s']:.2f} s, rewards "
        f"{st['rewards_s']:.2f} s (transformers {'installed' if _has('transformers') else 'absent'}), build "
        f"{st['build_s']:.2f} s, warm-up + capture {st['capture_s']:.2f} s, replayed epoch "
        f"{', '.join(f'{t:.3f}' for t in st['epoch_s'])} s; host peak RSS {run['host_peak_rss_gib']:.2f} GiB (from "
        f"{run['host_rss_start_gib']:.2f} at the start), device peak {run['device_peak_gib']:.2f} GiB + pool "
        f"{run['memory']['pool_gib']:.2f}; K4 {run['per_call']['k4_per_call']} "
        f"a call; graph against eager bitwise {run['graph_vs_eager_bitwise']}; VARConfig = the rung's, converted tree "
        f"= init_var's after the bf16 cast")
    stats = dict(files_bytes=sizes, write_s=write_s, ignored_tensors=ignored, **run)
    del backend, reward
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_weights_sana(torch):
    """Sana-Sprint 1.6B's widths trained from a bf16 safetensors checkpoint in
    the released diffusers layout (:func:`released_sana_keys` at the flagship
    rung's ``SanaConfig`` cut to ``WEIGHTS_SANA_LAYERS`` of its 20 blocks, d
    2240 and every key name kept, written by the port's own writer, which
    needs no ``safetensors`` package) on the int8 base: the train
    CLI's ``main`` with ``--backend sana_one_step --weights --base_quant
    int8`` at the flagship plan (pop 4, 4 prompts of ``BENCH_PROMPT_SET``,
    member_batch 1, the rung's knobs; the CLI's random DC-AE and CLIP-B/32
    tower, PickScore dropped): a warm-up and capture epoch, then one
    replayed epoch (:func:`_cli_graph_run`: K3 8 a block + 4 an image and K1 as the
    module trees give them, counted at the warm-up and on the device in
    the replay; the graph against eager bitwise). Then ``weights.validate
    --family sana`` on the same file: its stats line, finite. The host's
    peak resident set is read over the CLI's run (the f32 conversion)."""
    import contextlib
    import dataclasses
    import io as _io
    import shutil

    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_PLAN, rung_opt, sana_rung_model
    from hyperscalees_t2i_tpu_torch.weights import validate

    scale, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    model = dataclasses.replace(sana_rung_model(scale, tower_dtype=opt["tower_dtype"])["bcfg"].model,
                                n_layers=WEIGHTS_SANA_LAYERS)
    keys = released_sana_keys(model)
    tmp = _checkpoint_dir()
    try:
        ckpt = tmp / "diffusion_pytorch_model.safetensors"
        t0 = time.perf_counter()
        size = write_released_safetensors(ckpt, keys, seed=20)
        write_s = time.perf_counter() - t0
        (tmp / "prompts.txt").write_text("\n".join(BENCH_PROMPT_SET) + "\n")
        argv = ["--backend", "sana_one_step", "--weights", str(ckpt), "--base_quant", "int8",
                "--prompts_txt", str(tmp / "prompts.txt"), "--pop_size", str(pop), "--prompts_per_gen", str(m),
                "--member_batch", str(mb), "--num_epochs", "2", "--reward_tile", str(opt["reward_tile"]),
                "--noise_dtype", opt["noise_dtype"], "--tower_dtype", opt["tower_dtype"],
                "--pop_fuse", str(opt["pop_fuse"]).lower(), "--allow_random_rewards", "true",
                "--run_dir", str(tmp), "--run_name", f"sana_d2240_l{WEIGHTS_SANA_LAYERS}", "--resume", "false"]
        run, backend, reward = _cli_graph_run(torch, argv, "weights_sana", expected_es_launches)
        got = backend.cfg.model
        if got != model:
            raise AssertionError(f"infer_sana_config gave {got}, not the flagship's cut to {WEIGHTS_SANA_LAYERS} "
                                 f"blocks: {model}")
        per = run["per_call"]
        # 8 adapted sites a block and 4 outside them (164 at the full 20 blocks)
        k3_image = 8 * WEIGHTS_SANA_LAYERS + 4
        if per["k3_per_call"] != k3_image or not per["k1_per_call"]:
            raise AssertionError(f"Sana from the checkpoint launched {per} an image, not K3 {k3_image} and K1")
        del backend, reward
        gc.collect()
        torch.cuda.empty_cache()
        out = _io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = validate.main(["--family", "sana", "--weights", str(ckpt), "--device", "cuda"])
        validate_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = next(l for l in out.getvalue().splitlines() if l.startswith("{"))
    vstats = json.loads(line)
    if rc != 0 or not all(math.isfinite(x) for k in ("mean", "std") for x in vstats[k]) or \
            not all(math.isfinite(vstats[k]) for k in ("min", "max")):
        raise AssertionError(f"weights.validate --family sana: rc {rc}, stats {line[:200]}")
    log(f"[weights-sana] validate --family sana: {line}")
    st = run["stages"]
    log(f"[weights-sana] d 2240, {WEIGHTS_SANA_LAYERS} blocks: {len(keys)} tensors, {size / 2**30:.3f} GiB bf16: write {write_s:.2f} s, read "
        f"{st['read_s']:.2f} s (bf16 → f32), convert {st['convert_s']:.2f} s, to the card {st['to_device_s']:.2f} s, "
        f"rewards {st['rewards_s']:.2f} s, build {st['build_s']:.2f} s (int8 base, random DC-AE), warm-up + capture "
        f"{st['capture_s']:.2f} s, replayed epoch {', '.join(f'{t:.3f}' for t in st['epoch_s'])} s; host peak RSS "
        f"{run['host_peak_rss_gib']:.2f} GiB (from {run['host_rss_start_gib']:.2f} at the start), device peak "
        f"{run['device_peak_gib']:.2f} GiB + "
        f"pool {run['memory']['pool_gib']:.2f}; "
        f"an image: K3 {per['k3_per_call']}, K1 {per['k1_per_call']}; graph against eager bitwise "
        f"{run['graph_vs_eager_bitwise']}; validate {validate_s:.1f} s")
    return dict(file_bytes=size, tensors=len(keys), layers=WEIGHTS_SANA_LAYERS, write_s=write_s, validate=vstats,
                validate_s=validate_s, **run)


def _mem_total_gib() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024 / 2**30
    return float("nan")


def phase_weights_infinity(torch):
    """Infinity-2B at its full width and depth trained from a ``.pth`` pair
    in the released layout: the transformer (:func:`released_infinity_keys`
    at the ``inf_2b`` rung's ``InfinityConfig``, 32 blocks, QK-l2 scales of
    both attentions, ≈ 2.0 B values) and the BSQ tokenizer
    (:func:`released_bsq_keys`: φ convs, a CompVis decoder and an encoder
    the converter ignores), each written as a bf16 torch pickle
    (:func:`write_released_pth`) into a temporary directory deleted
    afterwards. The train CLI's ``main`` with ``--backend infinity
    --infinity_variant 2b --pn 1M --weights --vae_weights --base_quant int8
    --pop_fuse true`` at the ``inf_2b`` plan (pop 4, 4 prompts of
    ``BENCH_PROMPT_SET``, member_batch 1, the rung's tower dtype; the CLI's
    random CLIP-B/32 tower alone, PickScore dropped): one run_training
    epoch, the warm-up and capture, then :func:`_cli_graph_run`'s profiled
    replayed epoch (K3 6 × 14 × 32 + 32 = 2,720, K4 896 and K1 as the
    module tree gives them a generate call, counted at the warm-up and on
    the device; no eager epoch: ``phase_inf_q8_es`` holds this program's
    graph against eager). Checks: the inferred ``InfinityConfig`` is the
    rung's field by field; the converters consumed every tensor of both
    files but the ignored buffers and encoder (they are strict); θ and the
    reward rows finite. Logs the files' sizes, each stage's seconds, the
    host's peak RSS beside its start and ``MemTotal``, the device's peak
    over the build (the f32 tree beside its bf16 cast and int8) and the
    memory as weights + KV workspace + pool."""
    import shutil

    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_PLAN, infinity_rung_model, rung_opt

    scale, pop, m, mb = RUNG_PLAN["inf_2b"]
    opt = rung_opt("inf_2b")
    model = infinity_rung_model(scale)["bcfg"].model
    keys, vkeys = released_infinity_keys(model), released_bsq_keys(model.vq)
    names = {"transformer": "infinity_2b_reg.pth", "tokenizer": "infinity_vae_d32reg.pth"}
    ignored = sum(1 for k, _ in keys if k.split(".")[-1] in RELEASED_BUFFERS) + \
        sum(1 for k, _ in vkeys if k.startswith(("encoder.", "quant_conv.")))
    values = sum(math.prod(s) for _, s in keys)
    gc.collect()  # the previous phase's step closures hold its backend in cycles
    torch.cuda.empty_cache()
    mem_total = _mem_total_gib()
    tmp = _checkpoint_dir()
    try:
        t0 = time.perf_counter()
        sizes = {"transformer": write_released_pth(tmp / names["transformer"], keys, seed=24),
                 "tokenizer": write_released_pth(tmp / names["tokenizer"], vkeys, seed=25)}
        write_s = time.perf_counter() - t0
        (tmp / "prompts.txt").write_text("\n".join(BENCH_PROMPT_SET) + "\n")
        argv = ["--backend", "infinity", "--infinity_variant", scale, "--pn", "1M",
                "--weights", str(tmp / names["transformer"]), "--vae_weights", str(tmp / names["tokenizer"]),
                "--base_quant", "int8", "--pop_fuse", "true", "--prompts_txt", str(tmp / "prompts.txt"),
                "--pop_size", str(pop), "--prompts_per_gen", str(m), "--member_batch", str(mb), "--num_epochs", "1",
                "--tower_dtype", opt["tower_dtype"], "--allow_random_rewards", "true", "--run_dir", str(tmp),
                "--run_name", "inf_2b_ckpt", "--resume", "false"]
        log(f"[weights-inf] {len(keys)} + {len(vkeys)} tensors written in {write_s:.2f} s ({values} transformer "
            f"values); host MemTotal {mem_total:.2f} GiB before the read")
        run, backend, reward = _cli_graph_run(torch, argv, "weights_inf_2b", expected_inf_launches,
                                              against_eager=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = backend.cfg.model
    if got != model:
        diff = {f: (getattr(got, f), getattr(model, f)) for f in model.__dataclass_fields__
                if getattr(got, f) != getattr(model, f)}
        raise AssertionError(f"infer_infinity_config + --infinity_variant 2b --pn 1M gave {diff} against the inf_2b "
                             f"rung's InfinityConfig")
    if reward.pick_model is not None:
        raise AssertionError("the CLI's reward has a PickScore tower: the phase expects CLIP-B/32 alone")
    per = run["per_call"]
    if (per["k2_per_call"], per["k3_per_call"], per["k4_per_call"]) != (0, 2720, 896) or not per["k1_per_call"]:
        raise AssertionError(f"Infinity-2B from the checkpoint launched {per} a call, not K3 2720, K4 896 and K1")
    if not (run["theta_finite"] and all(math.isfinite(x) for x in run["theta_norm"] + run["delta_norm"])):
        raise AssertionError(f"Infinity-2B from the checkpoint: θ norms {run['theta_norm']}, ‖Δθ‖ {run['delta_norm']}")
    st, mem = run["stages"], run["memory"]
    startup_s = sum(st[k] for k in ("read_s", "convert_s", "to_device_s", "rewards_s", "build_s"))
    log(f"[weights-inf] Infinity-2B ({model.depth} blocks, d {model.d_model}, {len(model.patch_nums)} scales to "
        f"{model.vq.grid}², {model.vq.bits}-bit BSQ): {names['transformer']} {sizes['transformer'] / 2**30:.3f} GiB + "
        f"{names['tokenizer']} {sizes['tokenizer'] / 2**30:.3f} GiB bf16 ({ignored} buffers and encoder tensors "
        f"the converters ignore): write {write_s:.2f} s, read {st['read_s']:.2f} s (bf16 → f32), convert "
        f"{st['convert_s']:.2f} s, to the card {st['to_device_s']:.2f} s, rewards {st['rewards_s']:.2f} s, build "
        f"{st['build_s']:.2f} s (bf16 cast, int8), start-up {startup_s:.2f} s; warm-up + capture "
        f"{st['capture_s']:.2f} s, replayed epoch {', '.join(f'{t:.3f}' for t in st['epoch_s'])} s, busy "
        f"{run['profile']['busy_ms']:.1f} ms, idle share {run['profile']['idle_share']:.4f}; K3 "
        f"{run['profile']['in_situ_ms']['fused_qlora'] / per['calls']:.1f} ms and K4 "
        f"{run['profile']['in_situ_ms']['decode_attention'] / per['calls']:.1f} ms in situ a call; memory weights "
        f"{mem['weights_gib']:.2f} + KV workspace {mem['workspace_gib']:.2f} + pool {mem['pool_gib']:.2f} GiB "
        f"(peak allocated + pool {mem['total_gib']:.2f}); device peak over the build {run['build_peak_gib']:.2f} "
        f"GiB; host peak RSS {run['host_peak_rss_gib']:.2f} GiB (from {run['host_rss_start_gib']:.2f} at the start, "
        f"MemTotal {mem_total:.2f}); a call K3 {per['k3_per_call']}, K4 {per['k4_per_call']}, K1 "
        f"{per['k1_per_call']}; InfinityConfig = the rung's")
    stats = dict(files_bytes=sizes, tensors=len(keys) + len(vkeys), transformer_values=values, write_s=write_s,
                 ignored_tensors=ignored, mem_total_gib=mem_total, startup_s=startup_s, **run)
    del backend, reward
    gc.collect()
    torch.cuda.empty_cache()
    return stats


MULTIPROC_N = 2  # processes of the multi-process phase, all on the one card
MULTIPROC_EPOCHS = 2  # run_training epochs: the first warms up and captures, the second replays
MULTIPROC_TOL = 3e-4  # θ′ of the two-process run against the one-process run
# the transformer blocks, of Sana-Sprint 1.6B's 20, of phase_multiproc_es's
# runs and phase_pod_es's launch (whose rows are held against them): the
# launch counts depend on depth only through the block count
MULTIPROC_LAYERS = 4
# the chaos launch (phase_chaos_es): its epochs, each fault's place, and the
# store deadlines that make a death cost seconds (the compile grace still
# covers the warm-up and capture epoch)
CHAOS_EPOCHS = 6
CHAOS_LAYERS = 4  # of Sana-Sprint 1.6B's 20 blocks: the recovery logic does not depend on depth
CHAOS_FAULTS = "desync@1:host1;torn_write@3:host1;die@4:host1"
CHAOS_KV_ENV = {"HYPERSCALEES_KV_TIMEOUT_MS": "3000", "HYPERSCALEES_KV_PROBE_MS": "500",
                "HYPERSCALEES_ELASTIC_ROLLCALL_MS": "1000"}
# the epochs whose θ′ the chaos launch computes, in order: epoch 2's first
# pass runs on host 1's forked θ and is rolled back, epochs 1-2 replay (the
# torn slot is the replay's last, slot 3), host 1 dies after epoch 4, and
# the one-process relaunch runs epoch 5
CHAOS_POD_STEPS = [0, 1, 2, 1, 2, 3, 4]
CHAOS_FORKED_STEP = 2  # the index in CHAOS_POD_STEPS of the rolled-back pass


def _multiproc_argv(root):
    """The train CLI's command line of :func:`phase_multiproc_es`: the Sana
    one-step backend at ``--model_scale full`` (Sana-Sprint 1.6B's widths,
    DC-AE to 1024×1024, random weights from the seed) on the int8 base with
    the flagship rung's knobs (``pop_fuse``, ``reward_tile`` 1, bf16 noise and
    towers: the settings under which :func:`phase_es_flagship` runs K3 and
    K1), the rung's plan (pop 4, 4 prompts, member_batch 1), the population
    host-sharded in every run (one process: the gather is the identity)."""
    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET, RUNG_PLAN, rung_opt

    _, pop, m, mb = RUNG_PLAN["flagship"]
    opt = rung_opt("flagship")
    (root / "prompts.txt").write_text("\n".join(BENCH_PROMPT_SET) + "\n")
    return ["--backend", "sana_one_step", "--model_scale", "full", "--base_quant", opt["base_quant"],
            "--prompts_txt", str(root / "prompts.txt"), "--pop_size", str(pop), "--prompts_per_gen", str(m),
            "--member_batch", str(mb), "--num_epochs", str(MULTIPROC_EPOCHS), "--reward_tile",
            str(opt["reward_tile"]), "--noise_dtype", opt["noise_dtype"], "--tower_dtype", opt["tower_dtype"],
            "--pop_fuse", str(opt["pop_fuse"]).lower(), "--allow_random_rewards", "true", "--save_every", "0",
            "--resume", "false", "--pop_host_shard", "on", "--run_dir", str(root)]


def multiproc_cli_run(argv, theta1=None, on_epoch=None, before_training=None, layers=None):
    """The train CLI's ``main(argv)`` in this process, recorded: the kernel
    wrappers' counters from 0 just before its ``run_training`` (the eager
    warm-up epoch of each program; replays are not counted) read just after,
    the launches :func:`expected_es_launches` derives for this process's
    member slice (with a host mesh: its pop shard's members on its data
    shard's images), every gathered ``[pop, B]`` reward-row dict
    (``train.trainer.host_allgather_rows``), each logged epoch's row
    ``step_time_s``, each step's θ′ (in call order: a rolled-back epoch's
    too) and the final θ flat, the process's rank and device, the CLI's exit
    code (``exit``: an elastic exit is ``sys.exit(0)``), and the seconds of
    each roll-call, survivors' commit and slot restore (``timings``).
    ``theta1`` (a flat f32 θ in the same leaf order), where given, replaces
    θ′ after the first epoch (copied into its leaves in place, after it was
    recorded): the later epochs run from it. ``on_epoch(rec)`` is called
    after every logged epoch; ``before_training()`` once the CLI has built
    the backend and the rewards, just before ``run_training``; ``wall``
    holds the wall clock when the CLI had built (``built``), started and
    ended ``run_training`` (``train``, ``trained``). ``layers``
    cuts the Sana transformer the CLI builds to that many blocks (its
    ``SanaConfig`` default), the widths unchanged."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from hyperscalees_t2i_tpu_torch.models import sana
    from hyperscalees_t2i_tpu_torch.parallel.collectives import process_count, process_rank
    from hyperscalees_t2i_tpu_torch.resilience import elastic
    from hyperscalees_t2i_tpu_torch.resilience.checkpoints import CheckpointStore
    from hyperscalees_t2i_tpu_torch.train import cli, trainer

    rec = {"rows": [], "step_time_s": [], "thetas": [], "exit": 0, "wall": {},
           "timings": {"roll_call": [], "survivor_commit": [], "restore": []}}
    real_gather, real_run, real_step = trainer.host_allgather_rows, trainer.run_training, trainer._host_step
    real_roll, real_commit, real_restore = elastic.roll_call, elastic.survivor_commit, CheckpointStore.restore
    real_cfg = sana.SanaConfig
    flat = lambda tree: torch.cat([t.float().reshape(-1) for t in trainer.tree_leaves(tree)]).cpu().numpy()  # noqa: E731

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                rec["timings"][name].append(time.perf_counter() - t)

        return call

    def gather(rows):
        full = real_gather(rows)
        rec["rows"].append({k: np.array(v) for k, v in full.items()})
        return full

    def host_step(eval_slice, update, *args):
        step = real_step(eval_slice, update, *args)

        def recorded(*args):
            out = step(*args)
            rec["thetas"].append(flat(out[0]))  # each epoch's θ′
            if theta1 is not None and len(rec["thetas"]) == 1:
                src, at = torch.from_numpy(theta1), 0
                with torch.inference_mode():  # the step's outputs are inference tensors
                    for leaf in trainer.tree_leaves(out[0]):
                        leaf.copy_(src[at:at + leaf.numel()].reshape(leaf.shape))
                        at += leaf.numel()
                if at != src.numel():
                    raise ValueError(f"theta1 holds {src.numel()} values, θ {at}")
            return out

        return recorded

    def epoch_end(e, sc):
        rec["step_time_s"].append(float(sc["step_time_s"]))
        rec["launches"] = _counters()
        if on_epoch is not None:
            on_epoch(rec)

    def run(backend, reward, tc, device=None, **kw):
        info = backend.step_info(0, tc.prompts_per_gen, tc.batches_per_gen)
        members, images = tc.pop_size // process_count(), len(info.flat_ids)
        mesh = kw.get("mesh")
        if mesh is not None and mesh.size > 1:
            # a host of mesh.size processes: its slice over the pop axis, its images over the data axis
            hosts = process_count() // mesh.size
            members = -(-tc.pop_size // hosts // mesh.shape["pop"])
            images = -(-images // mesh.shape["data"])
        mine = dataclasses.replace(tc, pop_size=members)
        rec["expected"], rec["per_call"] = expected_es_launches(backend, reward, mine, images)
        rec["rank"], rec["processes"], rec["device"] = process_rank(), process_count(), str(backend.device)
        rec["wall"]["built"] = time.time()
        if before_training is not None:
            before_training()
        rec["wall"]["train"] = time.time()
        _reset_counters()
        state = real_run(backend, reward, tc, device=device, on_epoch_end=epoch_end, **kw)
        rec["wall"]["trained"] = time.time()
        rec["launches"] = _counters()
        rec["theta"] = flat(state.theta)
        return state

    trainer.host_allgather_rows, trainer.run_training, trainer._host_step = gather, run, host_step
    elastic.roll_call, elastic.survivor_commit = timed("roll_call", real_roll), timed("survivor_commit", real_commit)
    CheckpointStore.restore = timed("restore", real_restore)
    if layers is not None:
        sana.SanaConfig = functools.partial(real_cfg, n_layers=layers)
    try:
        cli.main(argv)
    except SystemExit as e:
        rec["exit"] = e.code if isinstance(e.code, int) else 1
    finally:
        trainer.host_allgather_rows, trainer.run_training, trainer._host_step = real_gather, real_run, real_step
        elastic.roll_call, elastic.survivor_commit, CheckpointStore.restore = real_roll, real_commit, real_restore
        sana.SanaConfig = real_cfg
    return rec


_REC_KEYS = ("rank", "processes", "device", "launches", "expected", "per_call", "step_time_s", "exit", "timings",
             "wall")


def _wait_word(go, what):
    """Wait for the file ``go`` (written whole, by a rename) and leave unless
    it says ``go``; no word in 400 s also leaves."""
    deadline = time.monotonic() + 400
    while not go.exists():
        if time.monotonic() > deadline:
            sys.exit(f"no word {what} in 400 s")
        time.sleep(0.05)
    if go.read_text() != "go":
        sys.exit(f"an earlier run failed: stopping {what}")


def multiproc_child(out_dir, go=None, train_go=None, layers=None):
    """One process of a launch of :func:`phase_multiproc_es` or
    :func:`start_chaos_launches`: its host start (the imports, the first
    ``transformers`` import) while another run has the card, then, once
    ``go`` (default ``out_dir/go``) says ``go``, the CLI on this process's
    arguments (``tools.launch_local`` gives the launch's flags), its record
    written to ``out_dir/rank<i>.npz`` and ``.json`` (the ``.json`` after
    every epoch too, so a process that dies leaves its counts). With
    ``train_go`` the CLI builds the backend and the rewards and then waits
    for that file's word before it trains; ``layers`` is
    :func:`multiproc_cli_run`'s. ``stop`` in either file (an earlier run
    failed), or no word in 400 s, exits before the card's work. The process
    exits with the CLI's code."""
    import numpy as np
    import torch

    from hyperscalees_t2i_tpu_torch.rewards.suite import tokenize_with_hf

    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the first tokenizer lookup imports transformers (≈ 15 s): beside the
    # CUDA context and the backend's build, as main() runs it beside the build
    threading.Thread(target=tokenize_with_hf, args=(["a photo"],), daemon=True).start()
    out = Path(out_dir)
    _wait_word(Path(go) if go else out / "go", "to start")
    started = time.time()

    def write_json(rec):
        (out / f"rank{rec['rank']}.json").write_text(json.dumps({k: rec[k] for k in _REC_KEYS if k in rec}))

    rec = multiproc_cli_run(sys.argv[1:], on_epoch=write_json, layers=layers,
                            before_training=None if train_go is None else lambda: _wait_word(Path(train_go), "to train"))
    rec["wall"]["go"] = started
    np.savez(out / f"rank{rec['rank']}.npz", theta=rec["theta"],
             **{f"theta{e}": t for e, t in enumerate(rec["thetas"])},
             **{f"rows{e}_{k}": v for e, rows in enumerate(rec["rows"]) for k, v in rows.items()})
    write_json(rec)
    if rec["exit"]:
        sys.exit(rec["exit"])


def _tell(root, word):
    (root / "go.tmp").write_text(word)
    (root / "go.tmp").replace(root / "go")


def _child_code(root, go=None, train_go=None, layers=None):
    return (child_prelude() + f"chip_smoke.multiproc_child({str(root)!r}, {str(go) if go else None!r}, "
            f"{str(train_go) if train_go else None!r}, {layers!r})")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def start_multiproc_launches():
    """The launches of :func:`phase_multiproc_es` and :func:`phase_chaos_es`,
    started on threads: their children do their host start (the imports,
    the first ``transformers`` import) now, while earlier phases have the
    card, and wait on their ``go`` files. The first is
    :func:`_multiproc_argv`'s command line as ``MULTIPROC_N`` processes with
    ``--pop_shard_update on``, a slot and a desync check every epoch; the
    others are :func:`start_chaos_launches`'."""
    import shutil

    from hyperscalees_t2i_tpu_torch.tools import launch_local

    root = ROOT / "build" / "multiproc_es"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    argv = _multiproc_argv(root)
    pod = {}

    def launch():
        pod["rc"] = launch_local.run_pod(MULTIPROC_N, argv + ["--run_name", "pod", "--pop_shard_update", "on",
                                                              "--save_every", "1", "--desync_check_every", "1"],
                                         timeout_s=400, entry=["-c", _child_code(root, layers=MULTIPROC_LAYERS)])
        pod["end"] = time.perf_counter()

    launcher = threading.Thread(target=launch)
    launcher.start()
    return {"root": root, "argv": argv, "pod": pod, "launcher": launcher, "chaos": start_chaos_launches(argv)}


def stop_multiproc_launches(launches):
    """Tell every child of :func:`start_multiproc_launches` to leave without
    touching the card (a child that has its word already runs on)."""
    _tell(launches["root"], "stop")
    launches["launcher"].join()
    stop_chaos_launches(launches["chaos"])


def phase_multiproc_es(torch, launches):
    """Two processes train on the one card through ``tools.launch_local``
    (``run_pod``, started by :func:`start_multiproc_launches`), each with its
    own CUDA context on ``cuda:0`` and the command line of
    :func:`_multiproc_argv`, the transformer cut to ``MULTIPROC_LAYERS``
    blocks, with ``--pop_shard_update on``,
    ``--save_every 1`` and ``--desync_check_every 1``: each evaluates its 2
    of the 4 members (K3 and K1), the reward rows cross through the launch's
    store, the update is split over the two processes (``update_partial``,
    one all-reduce of the partial sums on gloo through the host,
    ``update_apply``; from the second epoch on, replayed graphs), each
    boundary's slot goes through the two-phase commit and θ's fingerprint
    through every epoch's gather. Three runs, one at a time on the card: the
    same command line as one process in this process (``--pop_shard_update
    auto``: alone, the replicated update), while the launch's children wait
    for it; the launch; then one process again, its θ′ after the first epoch
    replaced by the launch's (the witness).

    Checks: each child exits 0 (a child that fails fails the phase); each
    child's counted K3 and K1 launches are exactly what its member slice
    derives (its eval program's warm-up epoch); both ranks' θ′ after every
    epoch bitwise equal; every boundary committed by a unanimous vote
    (``resilience/ckpt_commits`` ``MULTIPROC_EPOCHS`` on both processes, no
    ``ckpt_commit_failed``, both stores' slots with the same sha256s) and
    ``resilience/desync`` 0 on both; the first epoch's gathered ``[4, 4]``
    reward rows bitwise those of the one-process run, and that first
    update's θ′ within ``MULTIPROC_TOL`` of the one-process θ′ (the partial
    sums' order). The second epoch starts from θ′ that differ in their last
    bits, so it is held against the witness, which starts from the launch's
    own θ′: its second epoch's gathered rows bitwise the launch's, and the
    launch's replayed split update within ``MULTIPROC_TOL`` of the witness's
    replicated one. How far the witness's second epoch lies from the first
    one-process run's (θ′, rows) measures what those last bits alone do.
    Prints each run's replayed epoch (its second row's ``step_time_s``; the
    launch's is the mean over its processes) with the card's name and power
    limit (the launch's seconds from its word). Returns its record."""
    import numpy as np

    root, argv, pod = launches["root"], launches["argv"], launches["pod"]
    smi = _card()
    word = "stop"
    try:
        t0 = time.perf_counter()
        one = multiproc_cli_run(argv + ["--run_name", "one", "--pop_shard_update", "auto"], layers=MULTIPROC_LAYERS)
        one_s = time.perf_counter() - t0
        word = "go"
    finally:
        pod["go"] = time.perf_counter()
        _tell(root, word)
        launches["launcher"].join()
    gc.collect()
    torch.cuda.empty_cache()
    rc, pod_s = pod.get("rc"), pod.get("end", pod["go"]) - pod["go"]
    if rc != 0:
        raise AssertionError(f"the {MULTIPROC_N}-process launch exited {rc} (a child failed; its lines are above, "
                             "prefixed [p<i>])")
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(MULTIPROC_N)]
    arrays = [np.load(root / f"rank{r}.npz") for r in range(MULTIPROC_N)]
    for r, rec in enumerate(ranks):
        got, want = rec["launches"], rec["expected"]
        if rec["processes"] != MULTIPROC_N or got != want or not (got["fused_qlora"] and got["int8_matmul"]):
            raise AssertionError(f"rank {r} of {rec['processes']} on {rec['device']}: launched {got}, expected {want} "
                                 "(K3 and K1 in its eval slice's warm-up)")
    for name in ["theta"] + [f"theta{e}" for e in range(MULTIPROC_EPOCHS)]:
        if any(a[name].tobytes() != arrays[0][name].tobytes() for a in arrays[1:]):
            raise AssertionError(f"the ranks left with different {name}")
    if one["launches"] != one["expected"]:
        raise AssertionError(f"the one-process run launched {one['launches']}, expected {one['expected']}")
    if not all(np.isfinite(a["theta"]).all() for a in arrays):
        raise AssertionError("θ′ is not finite")
    commit = _check_commits(root / "pod", MULTIPROC_EPOCHS)

    def rows_apart(e, ref, exact):
        worst = 0.0
        for k, want in ref["rows"][e].items():
            for r, a in enumerate(arrays):
                got = a[f"rows{e}_{k}"]
                if got.shape != want.shape:
                    raise AssertionError(f"epoch {e} rows {k}: {got.shape} on rank {r}, {want.shape} in one process")
                if exact and got.tobytes() != want.tobytes():
                    raise AssertionError(f"epoch {e} gathered rows {k} on rank {r} differ from the one-process run's "
                                         f"(max abs {float(np.abs(got - want).max()):.3g})")
                worst = max(worst, float(np.abs(got - want).max()))
        return worst

    def theta_apart(e, ref):
        return max(float(np.abs(a[f"theta{e}"] - ref["thetas"][e]).max()) for a in arrays)

    # the first update takes bitwise-equal rows in both runs: split over the
    # processes it is the replicated update up to the partial sums' order
    rows_apart(0, one, exact=True)
    np.savez(root / "one_rows0.npz", **one["rows"][0])  # phase_pod_es's reference
    theta_err = [theta_apart(e, one) for e in range(MULTIPROC_EPOCHS)]
    if theta_err[0] > MULTIPROC_TOL:
        raise AssertionError(f"two-process θ′ after epoch 0 is {theta_err[0]:.3g} from the one-process θ′ (bound "
                             f"{MULTIPROC_TOL})")
    return _multiproc_witness(torch, argv, smi, ranks, arrays, one, one_s, pod_s, theta_err, commit, rows_apart,
                              theta_apart)


def _multiproc_witness(torch, argv, smi, ranks, arrays, one, one_s, pod_s, theta_err, commit, rows_apart,
                       theta_apart):
    """:func:`phase_multiproc_es` from the witness on."""
    import numpy as np

    # the witness: one process from the launch's θ′ after epoch 0, so every
    # later epoch of the launch (replayed eval slices, the gather, the
    # replayed split update) is held against one process on the same input
    t0 = time.perf_counter()
    wit = multiproc_cli_run(argv + ["--run_name", "witness", "--pop_shard_update", "auto"],
                            theta1=arrays[0]["theta0"], layers=MULTIPROC_LAYERS)
    wit_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if wit["launches"] != wit["expected"]:
        raise AssertionError(f"the witness launched {wit['launches']}, expected {wit['expected']}")
    wit_theta_err = [theta_apart(e, wit) for e in range(1, MULTIPROC_EPOCHS)]
    for e in range(1, MULTIPROC_EPOCHS):
        rows_apart(e, wit, exact=True)
    if max(wit_theta_err) > MULTIPROC_TOL:
        raise AssertionError(f"the launch's replayed split update is {max(wit_theta_err):.3g} from the replicated "
                             f"update of one process on the same θ and rows (bound {MULTIPROC_TOL})")
    # what θ′'s last bits after epoch 0 alone do to the next epoch, in one process
    alone = dict(
        theta0_start=float(np.abs(arrays[0]["theta0"] - one["thetas"][0]).max()),
        witness_theta0_vs_one=float(np.abs(wit["thetas"][0] - one["thetas"][0]).max()),
        theta=[float(np.abs(wit["thetas"][e] - one["thetas"][e]).max()) for e in range(1, MULTIPROC_EPOCHS)],
        rows=[max(float(np.abs(wit["rows"][e][k] - v).max()) for k, v in one["rows"][e].items())
              for e in range(1, MULTIPROC_EPOCHS)])
    pod_epoch = [rec["step_time_s"] for rec in ranks]
    pod_replayed = float(np.mean([t[-1] for t in pod_epoch]))
    log(f"[multiproc] {smi}: {MULTIPROC_N} processes on one card at {MULTIPROC_LAYERS} of Sana-Sprint 1.6B's 20 "
        f"blocks (K3 {ranks[0]['launches']['fused_qlora']}, K1 "
        f"{ranks[0]['launches']['int8_matmul']} counted in each process's warm-up, as derived); θ′ after every "
        f"epoch bitwise equal on every rank; against one process: epoch-0 rows bitwise, θ′ after epoch 0 max abs "
        f"{theta_err[0]:.3g}, after the last {theta_err[-1]:.3g}; against the witness (one process from the "
        f"launch's θ′ after epoch 0): later rows bitwise, the replayed split update's θ′ max abs "
        f"{max(wit_theta_err):.3g}; the witness against the first one-process run (θ′ after epoch 0 "
        f"{alone['theta0_start']:.3g} apart): θ′ after the last epoch {alone['theta'][-1]:.3g}, later rows "
        f"{max(alone['rows']):.3g}; replayed epoch: one process {one['step_time_s'][1]:.3f} s, witness "
        f"{wit['step_time_s'][-1]:.3f} s, {MULTIPROC_N} processes {pod_replayed:.3f} s (mean of the processes); "
        f"every slot committed unanimously ({commit['commits']} a process, sha256s equal in ckpt/ and "
        f"ckpt.host1/), resilience/desync 0 with the check every epoch, commit {commit['save_s']} s a boundary "
        f"(the checkpoint span, process 0); runs {one_s:.1f} s alone, {pod_s:.1f} s "
        f"launched (from its word), {wit_s:.1f} s the witness")
    record = dict(card=smi, processes=MULTIPROC_N, layers=MULTIPROC_LAYERS, launches=[rec["launches"] for rec in ranks],
                  expected=[rec["expected"] for rec in ranks], one_launches=one["launches"], theta_err=theta_err,
                  witness_theta_err=wit_theta_err, last_bits_alone=alone, one_step_time_s=one["step_time_s"],
                  witness_step_time_s=wit["step_time_s"], pod_step_time_s=pod_epoch, one_run_s=one_s,
                  pod_run_s=pod_s, witness_run_s=wit_s, commit=commit)
    return record


def _check_commits(run, boundaries):
    """A launch's run dir after every boundary committed: each process's
    ``resilience/ckpt_commits`` is ``boundaries`` with no failed vote and
    ``resilience/desync`` 0, and both stores hold every slot with the same
    sha256s. Returns the counts and the checkpoint spans' seconds."""
    snaps = [json.loads((run / f"resilience.host{r}.json").read_text()) for r in range(MULTIPROC_N)]
    for r, snap in enumerate(snaps):
        if snap.get("resilience/ckpt_commits") != boundaries or snap.get("resilience/ckpt_commit_failed") or \
                snap.get("resilience/desync", 0) != 0:
            raise AssertionError(f"process {r}'s commits: {snap}")
    for e in range(1, boundaries + 1):
        sums = [{k: v["sha256"] for k, v in json.loads((run / store / f"step_{e:08d}/manifest.json").read_text())[
            "arrays"].items()} for store in ("ckpt", "ckpt.host1")]
        if sums[0] != sums[1]:
            raise AssertionError(f"slot {e} differs between ckpt/ and ckpt.host1/")
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    if any(row.get("resilience/desync", 0) for row in rows):
        raise AssertionError("a desync was reported on an undisturbed launch")
    save = rows[-1].get("obs/phase_checkpoint_seconds") or {}
    return dict(commits=boundaries, desync=0, slots_equal=True,
                save_s=round(save.get("sum", float("nan")) / max(save.get("count", 1), 1), 4))


def _chaos_argv(argv, root):
    """The chaos launch's command line: :func:`_multiproc_argv`'s run in
    ``root``, ``CHAOS_EPOCHS`` epochs, a slot and a desync check every
    epoch, the replicated update (two processes bitwise one). Its processes
    cut the transformer to ``CHAOS_LAYERS`` blocks."""
    return argv + ["--run_dir", str(root), "--num_epochs", str(CHAOS_EPOCHS), "--save_every", "1",
                   "--desync_check_every", "1", "--pop_shard_update", "off", "--run_name", "chaos"]


def start_chaos_launches(argv):
    """The two launches of :func:`phase_chaos_es`, started on threads: the
    children do their host start now and wait on their ``go`` file. The
    two-process launch carries ``--faults CHAOS_FAULTS`` and the store
    deadlines ``CHAOS_KV_ENV``; the one-process relaunch resumes its run dir
    with ``--on_topology_mismatch reshard``: it starts with the launch and
    builds its backend beside it, then waits on ``relaunch/go`` to train."""
    import shutil

    from hyperscalees_t2i_tpu_torch.tools import launch_local

    root = ROOT / "build" / "chaos_es"
    shutil.rmtree(root, ignore_errors=True)
    (root / "relaunch").mkdir(parents=True)
    pod_argv = _chaos_argv(argv, root) + ["--faults", CHAOS_FAULTS]
    re_argv = _chaos_argv(argv, root) + ["--resume", "true", "--on_topology_mismatch", "reshard"]
    out = {"root": root, "argv": _chaos_argv(argv, root)}

    def pod():
        t = time.perf_counter()
        out["pod_rc"] = launch_local.run_pod(MULTIPROC_N, pod_argv, timeout_s=600, grace_s=120,
                                             entry=["-c", _child_code(root, layers=CHAOS_LAYERS)], env=CHAOS_KV_ENV)
        out["pod_s"] = time.perf_counter() - t

    def relaunch():
        t = time.perf_counter()
        out["relaunch_rc"] = launch_local.run_pod(1, re_argv, timeout_s=600, entry=["-c", _child_code(
            root / "relaunch", go=root / "go", train_go=root / "relaunch" / "go", layers=CHAOS_LAYERS)])
        out["relaunch_s"] = time.perf_counter() - t

    out["threads"] = [threading.Thread(target=pod), threading.Thread(target=relaunch)]
    for t in out["threads"]:
        t.start()
    return out


def stop_chaos_launches(chaos):
    """Tell both launches' children to leave without touching the card."""
    _tell(chaos["root"], "stop")
    _tell(chaos["root"] / "relaunch", "stop")
    for t in chaos["threads"]:
        t.join()


def phase_chaos_es(torch, chaos):
    """Chaos at Sana-Sprint 1.6B's widths (``CHAOS_LAYERS`` of its 20
    blocks), int8, the flagship knobs (:func:`_multiproc_argv`), on the one
    card: two processes with
    ``--pop_shard_update off`` (two processes bitwise one), ``CHAOS_EPOCHS``
    epochs, a slot and a desync check every epoch, and host-scoped faults
    (``CHAOS_FAULTS``) placed so that each recovery ends before the next
    fires: ``desync@1:host1`` (host 1's θ × 1.001 after epoch 1's gather),
    ``torn_write@3:host1`` (host 1's slot 3, the replay's last, truncated
    before its vote) and ``die@4:host1`` (host 1 exits hard after epoch 4).
    Then one process resumes the run dir with ``--on_topology_mismatch
    reshard`` and runs epoch 5; it builds its backend beside the launch and
    waits to train until the launch has ended. The reference is one process
    on the same command line without faults or slots, run in this process
    first (the launches' children wait on the host meanwhile).

    Checks: the commit at boundary 2 refuses the fork and the fingerprint
    at epoch 2 disagrees on both processes (one check interval;
    ``resilience/desync`` 1), both restore slot 1 and replay epochs 1-2,
    whose θ′ and gathered rows are bitwise the reference's (so is every
    other step but the forked pass); slot 3 is refused on both processes
    and invalidated in both stores; host 0's commit at boundary 5 times out
    (the store deadline ``CHAOS_KV_ENV``), the roll-call's verdict is
    ``[0]`` (``elastic.json``'s ``rollcall`` transition), host 0 commits
    slot 5 alone and exits 0; the relaunch restores it (a
    ``reshard_restore`` transition) and its epoch 5's rows and θ′, and its
    final θ, are bitwise the reference's; K3 and K1 counted in each process
    (the reference's, each chaos child's and the relaunch's warm-up) as
    derived. Prints each
    recovery's cost with the card's name and power limit: the detection to
    the verdict (the deadline and the roll-call), the survivors' commit, the
    reshard restore, and the replayed epochs against the undisturbed ones."""
    import numpy as np

    root = chaos["root"]
    smi = _card()
    try:
        t0 = time.perf_counter()
        one = multiproc_cli_run(chaos["argv"] + ["--run_name", "reference", "--save_every", "0"],
                                layers=CHAOS_LAYERS)
        ref_s = time.perf_counter() - t0
    except BaseException:
        stop_chaos_launches(chaos)
        raise
    gc.collect()
    torch.cuda.empty_cache()
    wall = {"go": time.time()}
    _tell(root, "go")
    pod_thread, re_thread = chaos["threads"]
    pod_thread.join()
    wall["pod_end"] = time.time()
    # the relaunch trains once the launch is over: the survivor's slot is its input
    pod_ok = chaos.get("pod_rc") == 1 and (root / "rank0.npz").exists()
    _tell(root / "relaunch", "go" if pod_ok else "stop")
    re_thread.join()
    wall["relaunch_end"] = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    if not pod_ok:
        raise AssertionError(f"the chaos launch exited {chaos.get('pod_rc')} (want 1, host 1's death) or process 0 "
                             "left no record; its lines are above, prefixed [p<i>]")
    if chaos.get("relaunch_rc") != 0:
        raise AssertionError(f"the reshard relaunch exited {chaos.get('relaunch_rc')}")
    run = root / "chaos"
    r0, r1 = (json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1))
    re = json.loads((root / "relaunch" / "rank0.json").read_text())
    a0, are = np.load(root / "rank0.npz"), np.load(root / "relaunch" / "rank0.npz")
    if r0["exit"] != 0:
        raise AssertionError(f"process 0 exited {r0['exit']} after the roll-call")
    for name, rec in (("the reference", one), ("process 0", r0), ("process 1", r1), ("the relaunch", re)):
        got, want = rec["launches"], rec["expected"]
        if got != want or not (got["fused_qlora"] and got["int8_matmul"]):
            raise AssertionError(f"{name} launched {got}, expected {want} (K3 and K1 in its warm-up)")
    ref_theta, ref_rows = one["thetas"], one["rows"]
    if len(ref_theta) != CHAOS_EPOCHS:
        raise AssertionError(f"the reference ran {len(ref_theta)} epochs, want {CHAOS_EPOCHS}")
    n_steps = len([k for k in a0.files if k.startswith("theta") and k[5:].isdigit()])
    if n_steps != len(CHAOS_POD_STEPS):
        raise AssertionError(f"process 0 ran {n_steps} steps, want {len(CHAOS_POD_STEPS)} ({CHAOS_POD_STEPS})")

    def same(got, want):
        return got.tobytes() == want.tobytes()

    forked = []
    for i, e in enumerate(CHAOS_POD_STEPS):
        th = same(a0[f"theta{i}"], ref_theta[e])
        rows = all(same(a0[f"rows{i}_{k}"], v) for k, v in ref_rows[e].items())
        if i == CHAOS_FORKED_STEP:
            forked.append((th, rows))
            continue
        if not (th and rows):
            raise AssertionError(f"chaos step {i} (epoch {e}): θ′ bitwise {th}, rows bitwise {rows} against the "
                                 "one-process run")
    if any(forked[0]):
        raise AssertionError("the forked pass of epoch 2 equals the undisturbed epoch: no fork was injected")
    last = CHAOS_EPOCHS - 1
    if not (same(are["theta0"], ref_theta[last]) and same(are["theta"], ref_theta[last])
            and all(same(are[f"rows0_{k}"], v) for k, v in ref_rows[last].items())):
        raise AssertionError(f"the relaunch's epoch {last} is not bitwise the one-process run's")
    # the markers and counters of each recovery
    snap0 = json.loads((run / "resilience.host0.json").read_text())  # the relaunch's, written last
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    pod_rows = [r for r in rows if r["incarnation"] == 0]
    if [r["epoch"] for r in pod_rows] != CHAOS_POD_STEPS or \
            [r.get("resilience/desync", 0) for r in pod_rows] != [0, 0] + [1] * (len(CHAOS_POD_STEPS) - 2):
        raise AssertionError(f"the launch's rows: epochs {[r['epoch'] for r in pod_rows]}, desync "
                             f"{[r.get('resilience/desync', 0) for r in pod_rows]}")
    end = pod_rows[-1]
    if (end.get("resilience/ckpt_commit_failed"), end.get("resilience/rollbacks")) != (2, 1):
        raise AssertionError(f"commit refusals {end.get('resilience/ckpt_commit_failed')} (want 2: the fork at 2, "
                             f"the torn slot at 3), rollbacks {end.get('resilience/rollbacks')} (want 1)")
    invalid = {s: sorted(p.name.rsplit("-", 1)[0] for p in (run / s).iterdir() if p.name.startswith(".invalid-"))
               for s in ("ckpt", "ckpt.host1")}
    want_invalid = [".invalid-step_00000002", ".invalid-step_00000003"]
    if invalid != {"ckpt": want_invalid, "ckpt.host1": want_invalid}:
        raise AssertionError(f"invalidated slots {invalid}, want {want_invalid} in both stores")
    rollcall, reshard = json.loads((run / "elastic.json").read_text())
    if (rollcall["kind"], rollcall["survivors"], rollcall["dead"], rollcall["action"], rollcall["epoch"]) != \
            ("rollcall", [0], [1], "checkpoint_exit", CHAOS_EPOCHS - 1):
        raise AssertionError(f"the roll-call transition: {rollcall}")
    if (reshard["kind"], reshard["epoch"], reshard["slot"]) != ("reshard_restore", last, f"step_{last:08d}") or \
            snap0.get("resilience/elastic_reshard_restores") != 1:
        raise AssertionError(f"the reshard transition: {reshard}, counters {snap0}")
    detect_s, rollcall_s = rollcall["detect_s"], r0["timings"]["roll_call"][0]
    commit_s, restore_s = r0["timings"]["survivor_commit"][0], re["timings"]["restore"][0]
    # the logged epochs of process 0 in order: 0, 1, [2 rolled back: no row end], 1, 2, 3, 4
    t0 = r0["step_time_s"]
    undisturbed, replayed = t0[1], t0[2]
    # where the launches' time went, s: process 0 from the word to its CLI's
    # build, its run_training, then its exit and the launch's end; the
    # relaunch's run_training (it built beside the launch) and its end
    w0, wr = r0["wall"], re["wall"]
    spans = dict(pod_build=w0["built"] - wall["go"], pod_train=w0["trained"] - w0["train"],
                 pod_exit=wall["pod_end"] - w0["trained"], relaunch_train=wr["trained"] - wr["train"],
                 relaunch_exit=wall["relaunch_end"] - wr["trained"])
    log(f"[chaos] {smi}: two processes, Sana-Sprint 1.6B's widths at {CHAOS_LAYERS} of its 20 blocks, int8, "
        f"{CHAOS_EPOCHS} epochs, faults "
        f"{CHAOS_FAULTS}; every step's θ′ and gathered rows but the forked pass bitwise the one-process run's; the "
        f"fork caught at epoch 2 (one interval) by the fingerprint and the commit digest, rolled back to slot 1 and "
        f"replayed bitwise; slots 2 and 3 refused and invalidated in ckpt/ and ckpt.host1/; the roll-call verdict "
        f"[0], survivor slot {last} committed; the relaunch's epoch {last} and θ bitwise; K3 "
        f"{r0['launches']['fused_qlora']} "
        f"and K1 {r0['launches']['int8_matmul']} counted in each process, {re['launches']['fused_qlora']} and "
        f"{re['launches']['int8_matmul']} in the relaunch, as derived. Costs: detection to verdict {detect_s:.3f} s "
        f"(the {int(CHAOS_KV_ENV['HYPERSCALEES_KV_TIMEOUT_MS']) / 1e3:g} s deadline + roll-call "
        f"{rollcall_s:.3f} s), survivors' commit {commit_s:.3f} s, reshard restore {restore_s:.3f} s; a replayed "
        f"epoch after the rollback {replayed:.3f} s against the undisturbed epoch 1's {undisturbed:.3f} s "
        f"(process 0); the reference {ref_s:.1f} s; the launch from the word: process 0's build "
        f"{spans['pod_build']:.1f} s, its run_training {spans['pod_train']:.1f} s, its exit and the launch's end "
        f"{spans['pod_exit']:.1f} s; the relaunch's run_training {spans['relaunch_train']:.1f} s, its end "
        f"{spans['relaunch_exit']:.1f} s")
    return dict(card=smi, faults=CHAOS_FAULTS, epochs=CHAOS_EPOCHS, layers=CHAOS_LAYERS, reference_s=ref_s,
                reference_launches=one["launches"], launches=[r0["launches"], r1["launches"]],
                relaunch_launches=re["launches"], detect_s=detect_s, rollcall_s=rollcall_s,
                survivor_commit_s=commit_s, reshard_restore_s=restore_s, replayed_epoch_s=replayed,
                undisturbed_epoch_s=undisturbed, step_time_s=t0, relaunch_step_time_s=re["step_time_s"],
                pod_s=chaos.get("pod_s"), relaunch_s=chaos.get("relaunch_s"), spans_s=spans, invalid=invalid,
                transitions=[rollcall, reshard])


# pod parallelism (phase_pod_es, phase_tp_sp): one host of two processes on
# the one card, each a "device" of a JAX host
POD_TOL = 3e-4  # the data axis's first-epoch rows against one process's, where a site breaks bitwise
POD_LINGER_S = 3  # the pod launch's exporter after the merge: the pod/* gauges are scraped in it
TP_N = 2  # processes of phase_tp_sp's launch: tp 2 and sp 2
TP_DIT_LAYERS = 4  # of Sana-Sprint 1.6B's 20 blocks in the f32 DiT check (the rules do not depend on depth)
TP_TOL = 1e-4  # the f32 DiT output (of its max) and the ring attention against one process
TP_PROMPTS = 2  # run_benchmark --tp 2's images (one batch)


def start_pod_launches():
    """The launches of :func:`phase_pod_es` and :func:`phase_tp_sp`, started on
    threads: their children do their host start now and wait on their
    ``go`` files. The pod launch is one host of two processes
    (``launch_local`` ``devices_per_process=2``) on :func:`_multiproc_argv`'s
    command line at ``MULTIPROC_LAYERS`` blocks with ``--pop_shards 1`` (pop
    1 × data 2), traced, a slot
    every epoch, its exporter lingering ``POD_LINGER_S``; the tp launch is
    two processes of :func:`tp_child`."""
    import shutil

    from hyperscalees_t2i_tpu_torch.rungs import BENCH_PROMPT_SET
    from hyperscalees_t2i_tpu_torch.tools import launch_local

    root = ROOT / "build" / "pod_es"
    tp_root = ROOT / "build" / "tp_sp"
    for d in (root, tp_root):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    port = _free_port()
    pod_argv = _multiproc_argv(root) + ["--run_dir", str(root), "--run_name", "pod", "--pop_shards", "1", "--pop_shard_update", "off",
                       "--trace", "true", "--save_every", "1", "--metrics_port", str(port),
                       "--metrics_linger_s", str(POD_LINGER_S)]
    (tp_root / "prompts.txt").write_text("\n".join(BENCH_PROMPT_SET[:TP_PROMPTS]) + "\n")
    tp_argv = ["--backend", "sana_one_step", "--model_scale", "full", "--prompts_txt", str(tp_root / "prompts.txt"),
               "--batch_size", str(TP_PROMPTS), "--out_dir", str(tp_root / "tp2"), "--tp", str(TP_N)]
    out = {"root": root, "tp_root": tp_root, "port": port, "argv": pod_argv}

    def pod():
        t = time.perf_counter()
        out["pod_rc"] = launch_local.run_pod(1, pod_argv, timeout_s=900,
                                             entry=["-c", _child_code(root, layers=MULTIPROC_LAYERS)],
                                             devices_per_process=2)
        out["pod_s"] = time.perf_counter() - t

    def tp():
        t = time.perf_counter()
        code = child_prelude() + f"chip_smoke.tp_child({str(tp_root)!r})"
        out["tp_rc"] = launch_local.run_pod(TP_N, tp_argv, timeout_s=900, entry=["-c", code])
        out["tp_s"] = time.perf_counter() - t

    out["threads"] = [threading.Thread(target=pod), threading.Thread(target=tp)]
    for t in out["threads"]:
        t.start()
    return out


def stop_pod_launches(pods):
    """Tell both launches' children to leave without touching the card."""
    for d in (pods["root"], pods["tp_root"]):
        _tell(d, "stop")
    for t in pods["threads"]:
        t.join()


def phase_pod_es(torch, pods):
    """The data axis over processes (``launch_local --num_processes 1
    --devices_per_process 2``: one host of two processes on the one card,
    ``--pop_shards 1`` → pop 1 × data 2) on :func:`_multiproc_argv`'s
    command line: Sana-Sprint 1.6B's widths at ``MULTIPROC_LAYERS`` of its 20
    blocks, int8, the flagship knobs and plan (pop 4, 4 prompts,
    member_batch 1), 2 epochs, traced, a slot every epoch. Each process evaluates all 4 members on its 2 of the 4 images
    (the global image positions' noise), and the rows are gathered over the
    data group (gloo, through the host), then across hosts through the
    store.

    Checks: both children exit 0; each counts K3 and K1 as its 4 members × 2
    images derive; both ranks' θ′ after every epoch bitwise equal; every
    process's gathered rows the same; the first epoch's ``[4, 4]`` rows
    bitwise those of :func:`phase_multiproc_es`'s one-process run on the same
    command line (else within ``POD_TOL``, the gap printed); every boundary
    committed by both processes (``_check_commits``); ``pod_summary.json``
    with ``n_hosts`` 2 and an aligned epoch; the ``pod/*`` gauges served on
    process 0's exporter after the merge; ``trace_report``'s Pod section and
    ``run_report``'s Pod panel over the run dir. Prints the replayed epoch
    and the gathers' anchor spans with the card's name and power limit."""
    import contextlib
    import io

    import numpy as np

    from hyperscalees_t2i_tpu_torch.tools import run_report, trace_report

    root, port = pods["root"], pods["port"]
    smi = _card()
    scraped = {}
    done = threading.Event()

    def scrape():  # the pod/* gauges appear after rank 0's merge, inside its exporter's linger window
        while not done.is_set():
            try:
                text = _scrape(port, "/metrics")
                if "pod_hosts" in text:
                    scraped["text"] = text
                    return
            except Exception:
                pass
            time.sleep(0.2)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    wall = {"go": time.time()}
    _tell(root, "go")
    pods["threads"][0].join()
    wall["end"] = time.time()
    done.set()
    scraper.join(timeout=5)
    gc.collect()
    torch.cuda.empty_cache()
    if pods.get("pod_rc") != 0:
        raise AssertionError(f"the data-axis launch exited {pods.get('pod_rc')} (its lines are above, prefixed [p<i>])")
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(2)]
    arrays = [np.load(root / f"rank{r}.npz") for r in range(2)]
    for r, rec in enumerate(ranks):
        got, want = rec["launches"], rec["expected"]
        if rec["processes"] != 2 or got != want or not (got["fused_qlora"] and got["int8_matmul"]):
            raise AssertionError(f"rank {r} of {rec['processes']}: launched {got}, expected {want} (K3 and K1 on its "
                                 "4 members × 2 images)")
    for name in ["theta"] + [f"theta{e}" for e in range(MULTIPROC_EPOCHS)]:
        if arrays[1][name].tobytes() != arrays[0][name].tobytes():
            raise AssertionError(f"the ranks left with different {name}")
    ref = np.load(ROOT / "build" / "multiproc_es" / "one_rows0.npz")
    gap, bitwise = 0.0, True
    for k in ref.files:
        blocks = [a[f"rows0_{k}"] for a in arrays]
        if any(b.tobytes() != blocks[0].tobytes() for b in blocks[1:]):
            raise AssertionError(f"the ranks gathered different rows {k}")
        per_proc = blocks[0].reshape(2, *ref[k].shape)  # each process posts its host's rows
        if per_proc[1].tobytes() != per_proc[0].tobytes():
            raise AssertionError(f"the two processes of the host posted different rows {k}")
        bitwise &= per_proc[0].tobytes() == ref[k].tobytes()
        gap = max(gap, float(np.abs(per_proc[0] - ref[k]).max()))
    if gap > POD_TOL:
        raise AssertionError(f"the data axis's first-epoch rows are {gap:.3g} from one process's (bound {POD_TOL})")
    run = root / "pod"
    commit = _check_commits(run, MULTIPROC_EPOCHS)
    summary = json.loads((run / "pod_summary.json").read_text())
    if summary.get("n_hosts") != 2 or summary.get("n_epochs_aligned", 0) < 1:
        raise AssertionError(f"pod_summary.json: {summary.get('n_hosts')} hosts, "
                             f"{summary.get('n_epochs_aligned')} aligned epochs")
    gauges = sorted({line.split()[0].split("{")[0] for line in scraped.get("text", "").splitlines()
                     if line.startswith("pod_")})
    if "pod_hosts" not in gauges:
        raise AssertionError("no pod/* gauge was served on process 0's exporter after the merge")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_t = trace_report.main([str(run)])
        rc_r = run_report.main([str(run), "--out", str(root / "run_report.html")])
    text = buf.getvalue()
    html_text = (root / "run_report.html").read_text() if rc_r == 0 else ""
    if rc_t != 0 or "## pod" not in text or rc_r != 0 or "<h2>Pod</h2>" not in html_text:
        raise AssertionError(f"trace_report exit {rc_t} (Pod section {'## pod' in text}), run_report exit {rc_r} "
                             f"(Pod panel {'<h2>Pod</h2>' in html_text})")
    pod_section = text[text.index("## pod"):].strip()
    epochs = [rec["step_time_s"] for rec in ranks]
    spans = dict(build=ranks[0]["wall"]["built"] - wall["go"],
                 train=ranks[0]["wall"]["trained"] - ranks[0]["wall"]["train"],
                 end=wall["end"] - ranks[0]["wall"]["trained"])
    log(f"[pod-es] {smi}: one host of two processes on the one card, pop 1 × data 2 (Sana-Sprint 1.6B's widths "
        f"at {MULTIPROC_LAYERS} of its 20 blocks, int8, the flagship plan); K3 {ranks[0]['launches']['fused_qlora']}, K1 {ranks[0]['launches']['int8_matmul']} "
        f"counted in each process (its 4 members × 2 images, as derived); θ′ bitwise on both ranks; the first "
        f"epoch's rows {'bitwise' if bitwise else f'within {gap:.3g} of'} the one-process run's; every slot committed "
        f"by both; epochs {epochs[0]} s (process 0), {epochs[1]} s (process 1); pod_summary.json {summary['n_hosts']} "
        f"hosts, {summary['n_epochs_aligned']} aligned epochs, straggler {summary.get('straggler_host')}; gauges "
        f"served {gauges}; the launch from the word: build {spans['build']:.1f} s, run_training {spans['train']:.1f} "
        f"s, merge, linger and exit {spans['end']:.1f} s\n{pod_section}")
    return dict(card=smi, launches=[rec["launches"] for rec in ranks], expected=[rec["expected"] for rec in ranks],
                rows_bitwise=bitwise, rows_gap=gap, step_time_s=epochs, commit=commit, gauges=gauges,
                pod_summary={k: summary.get(k) for k in ("n_hosts", "n_epochs_aligned", "straggler_host",
                                                          "epoch_spread_mean_s", "clock_offsets_s")},
                spans_s=spans, pod_s=pods.get("pod_s"))


def tp_child(out_dir):
    """One process of :func:`phase_tp_sp`'s launch, once ``out_dir/go`` says
    ``go``: ``run_benchmark``'s backend at ``--model_scale full`` (Sana-Sprint
    1.6B, bf16, DC-AE to 1024²; rank 0 first generates the ``--tp 0``
    images, eagerly), the generator sharded over the launch
    (``run_benchmark.shard_generator``) and the folder generated eagerly,
    rank 0 writing it; then an f32 Sana-Sprint DiT at ``TP_DIT_LAYERS``
    blocks, its output unsharded, then sharded (``parallel.tp``); then ring
    attention at Z-Image-Turbo's shape (30 heads, dh 128, the 1,048-token
    joint sequence with a ragged text key mask) over the launch against
    ``models.zimage.joint_attention`` in this process. Rank 0 writes
    ``out_dir/tp.json``."""
    import argparse

    import torch

    from hyperscalees_t2i_tpu_torch.evaluate import run_benchmark as rb
    from hyperscalees_t2i_tpu_torch.models import sana, zimage
    from hyperscalees_t2i_tpu_torch.ops import ring_attention as ra
    from hyperscalees_t2i_tpu_torch.parallel import tp
    from hyperscalees_t2i_tpu_torch.parallel.collectives import process_rank
    from hyperscalees_t2i_tpu_torch.parallel.mesh import initialize_multihost
    from hyperscalees_t2i_tpu_torch.utils import threefry
    from hyperscalees_t2i_tpu_torch.utils.graphs import GraphCache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    _wait_word(out / "go", "to start")
    args = rb.build_parser().parse_args(sys.argv[1:])
    initialize_multihost(args.coordinator, args.num_processes, args.process_id)
    rank = process_rank()
    res = {}
    t0 = time.perf_counter()
    backend = rb.make_backend(argparse.Namespace(**{**vars(args), "tp": 0}))
    res["build_s"] = time.perf_counter() - t0
    theta = rb.load_theta(backend, "base", None)
    quiet = lambda m: None  # noqa: E731
    ref, got = [], []
    if rank == 0:
        t0 = time.perf_counter()
        rb.generate_folder(backend, theta, out / "tp0", args.batch_size, args.limit,
                           programs=GraphCache(backend.device, graph=False), sink=ref, log=quiet)
        res["tp0_s"] = time.perf_counter() - t0
    res["sharded_leaves"] = rb.shard_generator(backend, args.backend, args.tp)
    for v in tp.TP_STATS.values():
        v[:] = [0, 0.0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = rb.generate_folder(backend, theta, args.out_dir, args.batch_size, args.limit,
                               programs=GraphCache(backend.device, graph=False), sink=got, log=quiet,
                               save=rank == 0)
    torch.cuda.synchronize()
    res["tp2_s"] = time.perf_counter() - t0
    res["generate_collectives"] = {k: list(v) for k, v in tp.TP_STATS.items()}
    if rank == 0:
        res["images"] = len(paths)
        res["image_gap"] = max(float(abs(a - b).max()) for a, b in zip(ref, got))
        res["images_finite"] = all(bool(torch.isfinite(torch.as_tensor(g)).all()) for g in got)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    # the f32 DiT at Sana-Sprint 1.6B's widths
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = sana.SanaConfig(n_layers=TP_DIT_LAYERS, compute_dtype=torch.float32)
    model = sana.SanaTransformer(cfg, sana.init_sana(cfg, threefry.prng_key(0, dev))).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    lat = torch.randn(2, 32, 32, cfg.in_channels, device=dev, generator=g)
    cap = torch.randn(2, 300, cfg.caption_dim, device=dev, generator=g)
    mask = torch.arange(300, device=dev)[None] < torch.tensor([[300], [171]], device=dev)
    t = torch.tensor([0.6, 1.2], device=dev)
    with torch.inference_mode():
        plain = model(lat, t, cap, mask)
        res["dit_sharded_leaves"] = tp.shard_module_tp(model, "sana")
        for v in tp.TP_STATS.values():
            v[:] = [0, 0.0]
        sharded = model(lat, t, cap, mask)
        torch.cuda.synchronize()
    res["dit_collectives"] = {k: list(v) for k, v in tp.TP_STATS.items()}
    res["dit_rel_err"] = float((sharded - plain).abs().max() / plain.abs().max())
    res["dit_finite"] = bool(torch.isfinite(sharded).all())
    del model, plain, sharded
    gc.collect()
    torch.cuda.empty_cache()
    # ring attention at Z-Image-Turbo's joint sequence: 24 text + 32² image tokens
    R, S, H, dh = 2, ZIMAGE_TEXT + (ZIMAGE_LATENT // 2) ** 2, ZIMAGE_TURBO["n_heads"], 128
    q, k, v = (torch.randn(R, S, H, dh, device=dev, generator=g) for _ in range(3))
    kmask = torch.cat([torch.arange(ZIMAGE_TEXT, device=dev)[None] < torch.tensor([[ZIMAGE_TEXT], [13]], device=dev),
                       torch.ones(R, S - ZIMAGE_TEXT, dtype=torch.bool, device=dev)], dim=1)
    with torch.inference_mode():
        want = zimage.joint_attention(q, k, v, kmask, torch.float32)
        for val in ra.RING_STATS.values():
            val[:] = [0, 0.0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring = zimage.joint_attention(q, k, v, kmask, torch.float32, sp_group=torch.distributed.group.WORLD)
        torch.cuda.synchronize()
    res["ring_s"] = time.perf_counter() - t0
    res["ring_collectives"] = {key: list(val) for key, val in ra.RING_STATS.items()}
    res["ring_rel_err"] = float((ring - want).abs().max() / want.abs().max())
    res["ring_abs_err"] = float((ring - want).abs().max())
    res["ring_shape"] = [R, S, H, dh]
    if rank == 0:
        (out / "tp.json").write_text(json.dumps(res))


def phase_tp_sp(torch, pods):
    """Tensor and sequence parallelism on the one card: one launch of
    ``TP_N`` processes (:func:`tp_child`) pays one CLI start for both checks.
    ``run_benchmark --tp 2`` at Sana-Sprint 1.6B's widths (bf16, the
    sharded generate eager, gloo collectives through the host): the images
    against the one-process ``--tp 0`` images, their largest gap printed;
    the f32 DiT (``TP_DIT_LAYERS`` of 20 blocks) within ``TP_TOL`` of its
    largest output of the one-process output; ring attention at
    Z-Image-Turbo's shape over sp 2 within ``TP_TOL`` of the one-process
    ``joint_attention``. K1-K4 are on neither path (a float base; the plain
    LoRA delta; ring attention is plain torch). Prints each collective's
    count and host seconds: the cost of a correctness path with two
    processes on one card, not a speed figure."""
    root = pods["tp_root"]
    smi = _card()
    _tell(root, "go")
    pods["threads"][1].join()
    gc.collect()
    torch.cuda.empty_cache()
    if pods.get("tp_rc") != 0 or not (root / "tp.json").exists():
        raise AssertionError(f"the tp launch exited {pods.get('tp_rc')} (its lines are above, prefixed [p<i>])")
    res = json.loads((root / "tp.json").read_text())
    pngs = sorted((root / "tp2").glob("*.png"))
    if res["images"] != TP_PROMPTS or len(pngs) != TP_PROMPTS or not res["images_finite"]:
        raise AssertionError(f"run_benchmark --tp {TP_N} wrote {len(pngs)} images, finite {res['images_finite']}")
    if not res["sharded_leaves"] or not res["dit_sharded_leaves"] or not res["dit_finite"]:
        raise AssertionError(f"sharded leaves {res['sharded_leaves']} (generator), {res['dit_sharded_leaves']} (DiT)")
    if res["dit_rel_err"] > TP_TOL or res["ring_rel_err"] > TP_TOL:
        raise AssertionError(f"tp {TP_N}: the f32 DiT {res['dit_rel_err']:.3g} of its max from one process; ring "
                             f"attention {res['ring_rel_err']:.3g} (bound {TP_TOL})")
    fmt = lambda c: ", ".join(f"{k} {int(n)} calls {s:.3f} s" for k, (n, s) in c.items())  # noqa: E731
    log(f"[tp-sp] {smi}: run_benchmark --tp {TP_N} at Sana-Sprint 1.6B's widths (bf16, {res['sharded_leaves']} "
        f"leaves sharded): {TP_PROMPTS} images in {res['tp2_s']:.2f} s against {res['tp0_s']:.2f} s at --tp 0 "
        f"(eager both), largest gap of the f32 images {res['image_gap']:.4g}; collectives "
        f"{fmt(res['generate_collectives'])}; the f32 DiT at {TP_DIT_LAYERS} of 20 blocks: "
        f"{res['dit_rel_err']:.3g} of its max from one process ({fmt(res['dit_collectives'])}); ring attention "
        f"{res['ring_shape']} over sp {TP_N}: {res['ring_rel_err']:.3g} of its max ({res['ring_abs_err']:.3g} abs) "
        f"from joint_attention in {res['ring_s']:.3f} s ({fmt(res['ring_collectives'])}); the backend built in "
        f"{res['build_s']:.1f} s. Two processes sharing one card through the host: a correctness path, not a speed "
        "figure")
    return dict(card=smi, **res, tp_s=pods.get("tp_s"))


BENCH_LADDER = "tiny,flaggen,flagship,ar_d16"  # phase_bench's rungs
BENCH_DIR = ROOT / "build" / "bench"
# K4 against its plain version at ar_d16's shapes: a call's largest difference
# over its largest plain output, check_close's bf16 bound
BENCH_PARITY_REL = 2.0 ** -7
BENCH_EARLY_NICE = 10  # the early children's niceness beside the build
BENCH_STEPS = 2  # the ladder's single-dispatch epochs a rung (the runner's default is 3)
BENCH_FLEET_BATCHES = 1  # --fleet's timed rounds a width (the runner's default is 3)
# the library kernels' families in the profiled flagship epoch, by their names (the first match); K1-K4 go by
# profile_trace.wrapper_of
KERNEL_FAMILIES = (("convolution (DC-AE)", ("conv", "implicit", "winograd", "cudnn")),
                   ("attention", ("flash", "fmha", "attention", "softmax")),
                   ("other GEMM", ("gemm", "cutlass", "sm90_", "cublas", "nvjet")),
                   ("copies and fills", ("memcpy", "memset", "copy")))
WRAPPER_FAMILIES = {"fused_qlora": "K3 (DiT adapted sites)", "int8_matmul": "K1 (int8 sites: DiT, DC-AE, towers)",
                    "lora_chain": "K2", "decode_attention": "K4"}


def kernel_family(name):
    from hyperscalees_t2i_tpu_torch.obs.profile_trace import wrapper_of

    wrapper = wrapper_of(name)
    if wrapper is not None:
        return WRAPPER_FAMILIES[wrapper]
    low = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES if any(k in low for k in keys)), "elementwise and other")


def _bench_child(argv, log_name, env=None, nice=False):
    """``tools.bench.cli(argv)`` (or ``tools.window.main``, ``argv[0] ==
    "window"``) in a child of the script, as ``python -m`` runs it, its
    output in ``BENCH_DIR/log_name``; ``nice``: at ``BENCH_EARLY_NICE``
    (its children inherit it), so the kernel build keeps the host's cores."""
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    mod, args = ("window", argv[1:]) if argv and argv[0] == "window" else ("bench", argv)
    call = "main" if mod == "window" else "cli"
    code = (child_prelude() + (f"import os; os.nice({BENCH_EARLY_NICE}); " if nice else "")
            + f"from hyperscalees_t2i_tpu_torch.tools import {mod}; sys.exit({mod}.{call}({list(args)!r}))")
    log_file = open(BENCH_DIR / log_name, "w")
    full_env = {**os.environ, "BENCH_PROGRAMS_JSONL": str(BENCH_DIR / "programs.jsonl"), **(env or {})}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT,
                            env=full_env)
    return proc, log_file


def start_bench_early():
    """The runner's scaling run (``--scaling --rungs tiny --devices 1,2``: a
    one-process and a two-process launch) and a window of one item
    (``--items bench_ladder --rungs tiny``), started with the script: the
    tiny rung launches no kernel, so they run on the card while the
    kernels build."""
    import shutil

    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    BENCH_DIR.mkdir(parents=True)
    scaling = _bench_child(["--scaling", "--rungs", "tiny", "--devices", "1,2", "--out",
                            str(BENCH_DIR / "SCALING.json")], "scaling.log",
                           {"BENCH_SCALING_DIR": str(BENCH_DIR / "scaling")}, nice=True)
    window = _bench_child(["window", "--budget_s", "900", "--out_dir", str(BENCH_DIR / "window"), "--items",
                           "bench_ladder", "--rungs", "tiny", "--round", "1", "--fresh"], "window.log", nice=True)
    return {"scaling": scaling, "window": window, "t0": time.perf_counter()}


def stop_bench_early(early):
    for proc, log_file in (early["scaling"], early["window"]):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()


def finish_bench_early(early):
    """Wait for :func:`start_bench_early`'s children (before the kernel
    checks time anything) and check them: the scaling digests equal at 1
    and 2 processes on the one card, the window's item completed with the
    tiny rung's record."""
    _bench_wait(early["scaling"], "--scaling", 300)
    scaling = json.loads((BENCH_DIR / "SCALING.json").read_text())
    _bench_wait(early["window"], "the window", 300)
    rollup = json.loads((BENCH_DIR / "window" / "WINDOW_r01.json").read_text())
    window_bench = json.loads((BENCH_DIR / "window" / "BENCH_window.json").read_text())
    digests = {s["devices"]: s["opt_scores_digest"] for s in scaling["summary"]}
    if sorted(digests) != [1, 2] or len(set(digests.values())) != 1 or not scaling["processes_on_one_card"]:
        raise AssertionError(f"--scaling: digests {digests}, one card {scaling['processes_on_one_card']}")
    if rollup["completed"] != ["bench_ladder"] or "imgs_per_sec" not in window_bench["rungs"]["tiny"]:
        raise AssertionError(f"the window: {rollup['completed']}, {window_bench['rungs']}")
    seconds = time.perf_counter() - early["t0"]
    log(f"[bench] scaling at 1 and 2 processes on one card: "
        + ", ".join(f"{s['devices']}: {s['imgs_per_sec']} images/s, digest {s['opt_scores_digest']}"
                    for s in scaling["summary"])
        + f"; the window: {rollup['completed']} in {rollup['spent_s']:.1f} s, tiny "
          f"{window_bench['rungs']['tiny']['imgs_per_sec']} images/s; both ended {seconds:.1f} s after they started")
    return {"scaling": scaling, "window": rollup, "digests": digests, "seconds": seconds}


def _bench_wait(child, what, timeout_s):
    proc, log_file = child
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{what} did not end in {timeout_s} s")
    log_file.close()
    text = (BENCH_DIR / Path(log_file.name).name).read_text()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}: {text[-3000:]}")
    return text


def _last_json(text):
    return json.loads([l for l in text.splitlines() if l.startswith("{")][-1])


def phase_bench(torch, early, es, var_es):
    """The rung runner, its serve mode and its report, as a user runs them
    (see the module note, 15): the ladder's parent and child at
    ``BENCH_LADDER``, then ``--serve --rung flagship --batches 2``,
    :func:`bench_fleet` and :func:`bench_profile`; every
    record checked, the runner's flagship and ``ar_d16`` epochs beside
    ``es``'s and ``var_es``'s; ``early`` is :func:`finish_bench_early`'s
    record (the scaling document is rendered with the rest)."""
    import contextlib
    import io

    from hyperscalees_t2i_tpu_torch.tools import bench, bench_report

    gc.collect()
    torch.cuda.empty_cache()
    card = _card()
    t0 = time.perf_counter()
    ladder_text = _bench_wait(_bench_child([], "ladder.log", {"BENCH_RUNGS": BENCH_LADDER, "BENCH_BUDGET_S": "600",
                                                              "BENCH_STEPS": str(BENCH_STEPS)}), "the ladder", 660)
    ladder_s = time.perf_counter() - t0
    ladder = _last_json(ladder_text)
    (BENCH_DIR / "BENCH.json").write_text(json.dumps(ladder) + "\n")
    # the serving bench through the runner's command line, in this process (no second CUDA start)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.cli(["--serve", "--rung", "flagship", "--batches", "2", "--out", str(BENCH_DIR / "SERVE.json")])
    if rc != 0:
        raise AssertionError(f"--serve exited {rc}")
    serve = _last_json(buf.getvalue())
    serve_s = time.perf_counter() - t0
    fleet, fleet_launches, fleet_s = bench_fleet(torch, bench, es)
    prof = bench_profile(es)

    name, _, limit = card.rpartition(",")
    rungs = ladder["rungs"]
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN

    # flaggen: the flagship's DiT sites once a generate call (K3 at the adapted
    # ones, K1 at the DiT's other int8 ones), at the flagship's tiling
    from hyperscalees_t2i_tpu_torch.rungs import rung_opt
    from hyperscalees_t2i_tpu_torch.train.config import TrainConfig

    dit_k1 = sum(r[-1] for r in K1_SHAPES if not r[0].startswith(("dcae", "clip")))
    _, pop, m, mb = RUNG_PLAN["flaggen"]
    calls = reward_calls(TrainConfig(pop_size=pop, member_batch=mb, reward_tile=rung_opt("flaggen")["reward_tile"]), m)
    expected = {
        "tiny": {k: 0 for k in KERNEL_TAGS},
        "flagship": es["expected_launches_per_epoch"],
        "flaggen": {"int8_matmul": dit_k1 * calls, "lora_chain": 0,
                    "fused_qlora": es["per_call"]["k3_per_call"] * calls, "decode_attention": 0},
        "ar_d16": {"int8_matmul": 0, "lora_chain": 0, "fused_qlora": 0,
                   "decode_attention": len(VAR_PATCH_NUMS) * VAR_DEPTH * var_es["per_call"]["calls"]},
    }
    for rung in BENCH_LADDER.split(","):
        r = rungs[rung]
        if "imgs_per_sec" not in r:
            raise AssertionError(f"the ladder's {rung} failed: {r.get('error')}")
        if (r.get("device_name"), r.get("power_limit")) != (name.strip(), limit.strip()):
            raise AssertionError(f"{rung}'s record is stamped {r.get('device_name')!r}, {r.get('power_limit')!r}, "
                                 f"the card is {card!r}")
        if r["mfu"] is None or not 0 < r["mfu"] <= 1 or r["physical_floor_s"] is None or \
                r["step_time_s"] < r["physical_floor_s"]:
            raise AssertionError(f"{rung}: mfu {r['mfu']}, step {r['step_time_s']} s, floor {r['physical_floor_s']} s")
        if r["kernel_launches"] != expected[rung]:
            raise AssertionError(f"{rung} launched {r['kernel_launches']} over its warm-up epoch, expected "
                                 f"{expected[rung]}")
        log(f"[bench] {rung}: {r['imgs_per_sec']} images/s, step {r['step_time_s']} s (single-dispatch "
            f"{r['step_time_single_dispatch_s']} s, chain {r['chain']}), mfu {r['mfu']}, floor "
            f"{r['physical_floor_s']} s, {r['roofline_bound']}-bound (predicted {r['predicted_step_time_s']} s), "
            f"compile {r['compile_s']} s (capture {r['capture_s']} s, pool {r['graph_pool_bytes'] / 2**30:.2f} GiB), "
            f"peak {(r['peak_bytes_est'] or 0) / 2**30:.2f} GiB, build {r['build_s']} s, launches "
            f"{r['kernel_launches']}; {r['device_name']}, {r['power_limit']}")
    ar = rungs["ar_d16"]
    parity, rel = ar["kernel_parity_maxdiff"], ar.get("kernel_parity_rel")
    if not isinstance(parity, float) or not isinstance(rel, float) or not rel <= BENCH_PARITY_REL:
        raise AssertionError(f"ar_d16's K4 parity {parity} at |plain| {ar.get('kernel_parity_ref_abs')}: "
                             f"{rel} of the call's largest output, bound {BENCH_PARITY_REL}")
    if ladder["value"] != rungs["flagship"]["imgs_per_sec"] or ladder["vs_baseline"] is None:
        raise AssertionError(f"the ladder's headline {ladder['value']} is not the flagship's")
    if not (serve["parity_bitwise"] and serve["parity_max_abs_diff"] == 0.0 and serve["hot_swap_effective"]):
        raise AssertionError(f"--serve parity {serve['parity_max_abs_diff']} (bitwise {serve['parity_bitwise']}), "
                             f"hot swap {serve['hot_swap_effective']}")
    report = bench_report.render(bench_report.iter_rungs([str(BENCH_DIR / "BENCH.json")], [])) + "\n\n" + \
        bench_report.render_trend([str(BENCH_DIR / n) for n in ("BENCH.json", "SCALING.json", "SERVE.json")])
    (BENCH_DIR / "REPORT.md").write_text(report + "\n")
    log("[bench] bench_report:\n" + report)
    fl = rungs["flagship"]
    log(f"[bench] the runner's flagship epoch {fl['step_time_s']} s ({fl['imgs_per_sec']} images/s) against "
        f"phase_es_flagship's replayed epochs {', '.join(f'{t:.3f}' for t in es['epoch_s'])} s; ar_d16 "
        f"{ar['step_time_s']} s at 16 blocks (phase_var_es at {var_es['layers']}: "
        f"{', '.join(f'{t:.3f}' for t in var_es['epoch_s'])} s); "
        f"flagship − flaggen {fl['step_time_s'] - rungs['flaggen']['step_time_s']:.4f} s an epoch (decode and "
        f"rewards, both at reward_tile {rung_opt('flaggen')['reward_tile']}); K4 parity {parity:.3g} at |plain| "
        f"{ar['kernel_parity_ref_abs']:.3g} ({rel:.3g} of the call's largest output); serve {serve['batched_imgs_per_sec']} images/s batched, "
        f"{serve['sequential_imgs_per_sec']} naive, {serve['sequential_aot_imgs_per_sec']} one-slot, bitwise; "
        f"ladder {ladder_s:.1f} s, serve {serve_s:.1f} s")
    return {"ladder": ladder, "serve": serve, **early, "report": report, "fleet": fleet, "profile": prof,
            "seconds": {"ladder": ladder_s, "serve": serve_s, "early_children": early["seconds"], "fleet": fleet_s,
                        "profile": prof["seconds"]},
            "launches": {k: sum(rungs[r]["kernel_launches"][k] for r in BENCH_LADDER.split(","))
                         for k in KERNEL_TAGS},
            "fleet_launches": fleet_launches, "profile_launches": prof["record"]["kernel_launches"]}


def bench_fleet(torch, bench, es):
    """The runner's ``--fleet --rung flagship --widths 1,2`` in this process,
    the launch counters set to 0 just before and read just after: its rows
    bitwise the solo step's at each width (the runner's parity), the K1 and
    K3 launches a whole number of flagship epochs' (its eager warm-ups and
    solo rows) and no K2 or K4; prints each width's tick beside the
    sequential solo steps'."""
    import contextlib
    import io

    t0 = time.perf_counter()
    buf = io.StringIO()
    torch.cuda.synchronize()
    _reset_counters()
    with contextlib.redirect_stdout(buf):
        rc = bench.cli(["--fleet", "--rung", "flagship", "--widths", "1,2", "--batches", str(BENCH_FLEET_BATCHES),
                        "--out", str(BENCH_DIR / "FLEET.json")])
    torch.cuda.synchronize()
    launches = _counters()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"--fleet exited {rc}")
    fleet = _last_json(buf.getvalue())
    widths = fleet["widths"]
    per = es["expected_launches_per_epoch"]
    epochs = launches["fused_qlora"] / per["fused_qlora"]
    if [w["width"] for w in widths] != [1, 2] or not fleet["parity_bitwise"] or \
            any(w["reward_rows_sha256"] != w["solo_rows_sha256"] for w in widths):
        raise AssertionError(f"--fleet: widths {[w['width'] for w in widths]}, rows against solo "
                             f"{[(w['reward_rows_sha256'], w['solo_rows_sha256']) for w in widths]}")
    if epochs != int(epochs) or not epochs or launches != {k: int(epochs) * v for k, v in per.items()}:
        raise AssertionError(f"--fleet launched {launches}, not a whole number of flagship epochs' {per}")
    log("[bench] --fleet --rung flagship: " + "; ".join(
        f"width {w['width']}: tick {w['fused_step_s']} s fused against {w['sequential_step_s']} s for the "
        f"{w['width']} solo step(s) ({w['fused_vs_sequential']}x), rows bitwise solo, compile {w['compile_s']} s, "
        f"pool {w['graph_pool_bytes'] / 2**30:.2f} GiB" for w in widths)
        + f"; launches {launches} ({int(epochs)} eager flagship epochs); {seconds:.1f} s")
    return fleet, launches, seconds


def bench_profile(es):
    """The runner's ``--profile DIR`` on the ``flagship`` rung in a ladder
    child of its own (its chained window off): the profile holds one
    ``bench/flagship`` range a timed replay, ``obs.calib.calibrate_run``
    joins their device time to the rung's ledger record
    (``measured_source`` ``profile``), and the range's largest kernels are
    printed by family (``KERNEL_FAMILIES``)."""
    from hyperscalees_t2i_tpu_torch.obs import calib, profile_trace

    prof_dir = BENCH_DIR / "profile"
    t0 = time.perf_counter()
    text = _bench_wait(_bench_child(["--profile", str(prof_dir)], "profile.log",
                                    {"BENCH_RUNGS": "flagship", "BENCH_BUDGET_S": "300", "BENCH_CHAIN": "0",
                                     "BENCH_STEPS": str(BENCH_STEPS),
                                     "BENCH_PROGRAMS_JSONL": str(prof_dir / "programs.jsonl")}), "--profile", 360)
    seconds = time.perf_counter() - t0
    rec = _last_json(text)["rungs"]["flagship"]
    if "imgs_per_sec" not in rec or rec["kernel_launches"] != es["expected_launches_per_epoch"]:
        raise AssertionError(f"--profile's flagship rung: {rec.get('error')}, launches {rec.get('kernel_launches')}")
    (trace_file,) = profile_trace.find_trace_files(prof_dir / "flagship")
    trace = profile_trace.load_trace(trace_file)
    ranges = profile_trace.program_durations(trace, ("bench/",))
    payload = calib.calibrate_run(prof_dir, host_measured={"bench/flagship": rec["step_time_single_dispatch_s"]})
    rows = [r for r in payload["rows"] if r["key"] == "bench/flagship"]
    if list(ranges) != ["bench/flagship"] or ranges["bench/flagship"]["count"] != BENCH_STEPS or \
            len(rows) != 1 or rows[0]["measured_source"] != "profile":
        raise AssertionError(f"--profile: ranges {ranges}, calib rows {payload['rows']}")
    ops = profile_trace.op_durations(trace)
    total_us = sum(o["total_us"] for o in ops.values())
    families = {}
    for name, o in ops.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + o["total_us"]
    largest = sorted(ops.items(), key=lambda kv: -kv[1]["total_us"])[:8]
    range_ms = ranges["bench/flagship"]["total_us"] / 1e3 / BENCH_STEPS
    row = rows[0]
    log(f"[bench] --profile flagship: bench/flagship {range_ms:.2f} ms device time a replay "
        f"({BENCH_STEPS} ranges), host {rec['step_time_single_dispatch_s']} s; calib joined it to the ledger "
        f"record: measured {row['measured_s']:.4f} s against predicted {row['predicted_s']} s; device time by family: "
        + ", ".join(f"{f} {us / 1e3 / BENCH_STEPS:.2f} ms ({us / total_us:.1%})"
                    for f, us in sorted(families.items(), key=lambda kv: -kv[1]))
        + "; largest kernels: " + "; ".join(f"{n[:80]} {o['total_us'] / 1e3 / BENCH_STEPS:.2f} ms x"
                                            f"{o['count'] // BENCH_STEPS}" for n, o in largest)
        + f"; {seconds:.1f} s")
    return {"record": {k: rec.get(k) for k in ("step_time_s", "step_time_single_dispatch_s", "imgs_per_sec", "mfu",
                                               "kernel_launches", "device_name", "power_limit")},
            "range_ms": range_ms, "calib_row": row, "families_ms": {f: us / 1e3 / BENCH_STEPS
                                                                    for f, us in families.items()},
            "largest_ms": {n: o["total_us"] / 1e3 / BENCH_STEPS for n, o in largest}, "seconds": seconds}


def kernel_summary(name, rows, launches, calls_key, replaces, scope):
    """One entry per kernel: its main-path calls per unit of its path (one
    flagship image, one VAR generate call), summed."""
    main = [r for r in rows if r["main_path"] and r[calls_key]]
    total = lambda key: sum(r[key] * r[calls_key] for r in main)  # noqa: E731
    ops_ms = sum(r["bound_ms"] * r[calls_key] for r in main if r["bound_by"] == "operations")
    bytes_ms = sum(r["bound_ms"] * r[calls_key] for r in main if r["bound_by"] == "bytes")
    return {
        "name": name, "route": "cuda",
        "source": f"hyperscalees_t2i_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": total("library_ms"),
        "scope": f"{scope}: {sum(r[calls_key] for r in main)} calls",
        **({"device_ms": total("device_ms")} if all("device_ms" in r for r in main) else {}),
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
    # the reward towers and tokenizers are read from local files only
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        return result

    # the reward path's first Hugging Face tokenizer lookup imports transformers (≈ 15 s on the card's
    # host, phase_weights_var's "rewards" stage): run it beside the kernel build, whose nvcc processes
    # leave the interpreter idle
    from hyperscalees_t2i_tpu_torch.rewards.suite import tokenize_with_hf

    warm = threading.Thread(target=tokenize_with_hf, args=(["a photo"],), daemon=True)
    warm.start()
    # the runner's scaling run and one-item window use the card beside the build (the tiny rung runs no kernel)
    bench_early = start_bench_early()
    # the SASS dumps run beside the kernel checks
    try:
        build = timed("build", phase_build, defer_sass=True)
        bench_early = timed("bench_early", finish_bench_early, bench_early)
    except BaseException:
        stop_bench_early(bench_early)
        raise
    warm.join()
    try:
        k1_rows = timed("k1_check", phase_k1_check, torch)
        k1_invariant = timed("k1_invariance", phase_k1_invariance, torch)
        chain_rows = timed("chain_check", phase_chain_check, torch)
        k2_invariant = timed("k2_invariance", phase_k2_invariance, torch)
        k3_invariant = timed("k3_invariance", phase_k3_invariance, torch)
        k4_rows, k4_extra = timed("k4_check", phase_k4_check, torch)
        k4_invariant = timed("k4_invariance", phase_k4_invariance, torch)
        k4_inf_rows = timed("k4_infinity", phase_k4_infinity, torch)
        inf_rows = timed("inf_kernel_check", phase_inf_kernel_check, torch)
        zimage_rows = timed("zimage_kernel_check", phase_zimage_kernel_check, torch)
    except BaseException:
        stop_sass_dumps(build["sass_dumps"])
        raise
    build = timed("build_sass", phase_build_sass, build)
    small_err = timed("small_reference", phase_small_reference, torch)
    es_tiny = timed("es_reference_tiny", phase_es_reference, torch, "tiny", int8=True)
    es_float_tiny = timed("es_reference_tiny_float", phase_es_reference, torch, "tiny", int8=False)
    train_tiny = timed("train_reference", phase_train_reference, torch)
    fleet_tiny = timed("fleet_reference", phase_fleet_reference, torch)
    pipeline_tiny = timed("pipeline_reference", phase_pipeline_reference, torch)
    var_tiny = timed("var_reference", phase_var_reference, torch)
    inf_tiny = timed("inf_reference", phase_inf_reference, torch)
    inf_q8_tiny = timed("inf_q8_reference", phase_inf_q8_reference, torch)
    zimage_tiny = timed("zimage_reference", phase_zimage_reference, torch)
    es_float = timed("es_flagship_float", phase_es_flagship, torch, base_quant="off", layers=FLAGSHIP_CUT_LAYERS)
    serve, serve_backend = timed("serve", phase_serve, torch, keep=True)
    tier = timed("serve_tier", phase_serve_tier, torch, serve_backend, serve)
    del serve_backend
    var_es = timed("var_es", phase_var_es, torch)
    weights_var = timed("weights_var", phase_weights_var, torch)
    inf_es = timed("inf_es", phase_inf_es, torch)
    inf_q8 = timed("inf_q8_es", phase_inf_q8_es, torch)
    weights_inf = timed("weights_infinity", phase_weights_infinity, torch)
    zimage = timed("zimage_es", phase_zimage_es, torch)
    weights_sana = timed("weights_sana", phase_weights_sana, torch)
    es, flagship = timed("es_flagship", phase_es_flagship, torch, keep=True)
    pipeline_es = timed("pipeline_es", phase_pipeline_es, torch, flagship[1], es)
    # the preflight children do their host start during the trainer phases
    children = start_preflight_children()
    try:
        train = timed("train_flagship", phase_train_flagship, torch, *flagship, es)
        chained = timed("train_chained", phase_train_chained, torch, flagship[1])
        artifacts = timed("train_artifacts", phase_train_artifacts, torch, *flagship)
        fleet_run = timed("fleet_flagship", phase_fleet_flagship, torch, *flagship, es)
    except BaseException:
        stop_preflight_children(children)
        raise
    run_tools = timed("run_tools", phase_run_tools, torch, *flagship, es, children)
    # the multi-process phases' children do their host start during the evaluation and threefry phases
    launches = start_multiproc_launches()
    try:
        evaluate = timed("evaluate", phase_evaluate, torch, *flagship)
        threefry_rows = threefry_shares(timed("threefry", phase_threefry, torch, flagship[0]), es, var_es,
                                        weights_inf, inf_q8)
        del flagship
        gc.collect()
        torch.cuda.empty_cache()
        multiproc = timed("multiproc_es", phase_multiproc_es, torch, launches)
    except BaseException:
        stop_multiproc_launches(launches)
        raise
    chaos_launches = launches["chaos"]
    # the pod phases' children do their host start during the chaos phase
    pods = start_pod_launches()
    try:
        chaos = timed("chaos_es", phase_chaos_es, torch, chaos_launches)
        pod = timed("pod_es", phase_pod_es, torch, pods)
    except BaseException:
        stop_pod_launches(pods)
        raise
    tp_sp = timed("tp_sp", phase_tp_sp, torch, pods)
    bench = timed("bench", phase_bench, torch, bench_early, es, var_es)

    # `launches`: the wrappers' counters over the main paths' eager epochs (the
    # eager variant's timed epochs, each run_training program's warm-up);
    # `launches_by_path` adds each graph path's launches on the device, from
    # the profiler over one replayed epoch (or serving flush)
    train_launches = lambda k: sum(run[k] for run in train["launches"])  # noqa: E731
    train_eager_epochs = sum(train["eager_epochs"])
    # the fleet's warm-up tick runs FLEET_W job epochs eagerly
    fleet_launches = lambda k: fleet_run["warmup_launches"][k]  # noqa: E731
    # Infinity-2B's eager epochs: each run_training's warm-up, each run's eager
    # epoch in turns with the graph, and the bf16 pop_fuse call (K2)
    inf_launches = lambda k: (inf_es["launches"][k] + inf_es["eager_launches"][k] + inf_q8["launches"][k]  # noqa: E731
                              + inf_q8["eager_launches"][k] + inf_es["fused_call"]["launches"][k])
    # the checkpoint phases' eager epochs: each run_training's warm-up and its epoch against the graph
    # (Infinity-2B's has none: phase_inf_q8_es holds that program against eager)
    weights_launches = lambda k: sum(p["launches"][k] + p.get("eager_launches", {}).get(k, 0)  # noqa: E731
                                     for p in (weights_var, weights_sana, weights_inf))
    # Z-Image's eager work: its run_training warm-up, its eager epoch against the
    # graph and the bf16 pop_fuse call (K2)
    zimage_launches = lambda k: (zimage["launches"][k] + zimage["eager_launches"][k]  # noqa: E731
                                 + zimage["fused_call"]["launches"][k])
    # the artifacts run's eager work: its warm-up and the strip and snapshot regenerations; the
    # run tools' resumed epoch (its warm-up) and the flagship preflight's warm-up (in its own process);
    # the evaluation tools' eager calls (generation, scoring, the demo's probe and warm-up)
    extra_launches = lambda k: (inf_launches(k) + weights_launches(k) + artifacts["launches"][k]  # noqa: E731
                                + zimage_launches(k) + run_tools["launches"][k] + run_tools["preflight_launches"][k]
                                + evaluate["launches"][k])
    kernels = [
        kernel_summary("int8_matmul", k1_rows,
                       es["eager"]["launches"]["int8_matmul"] + train_launches("int8_matmul")
                       + fleet_launches("int8_matmul") + extra_launches("int8_matmul"),
                       "calls_per_es_image",
                       "hyperscalees_t2i_tpu/ops/quant_mm.py:86", "one flagship ES image (DiT, DC-AE, both towers)"),
        kernel_summary("lora_chain", chain_rows["lora_chain"],
                       es_float["eager"]["launches"]["lora_chain"] + extra_launches("lora_chain"),
                       "calls_per_image", "hyperscalees_t2i_tpu/ops/fused_lora.py:80",
                       "the LoRA deltas of one flagship ES image over a bf16 base"),
        kernel_summary("fused_qlora", chain_rows["fused_qlora"],
                       es["eager"]["launches"]["fused_qlora"] + train_launches("fused_qlora")
                       + fleet_launches("fused_qlora") + extra_launches("fused_qlora"),
                       "calls_per_image", "hyperscalees_t2i_tpu/ops/fused_qlora.py:201",
                       "one flagship ES image's adapted sites"),
        kernel_summary("decode_attention", k4_rows,
                       var_es["eager"]["launches"]["decode_attention"] + extra_launches("decode_attention"),
                       "calls_per_call", "hyperscalees_t2i_tpu/ops/attention.py:58",
                       "one VAR-d16 generate call (32 rows, 10 scales x 16 layers)"),
    ]
    k4_inf = kernel_summary("decode_attention", k4_inf_rows, inf_launches("decode_attention"),
                            "calls_per_call", "hyperscalees_t2i_tpu/ops/attention.py:58",
                            f"one Infinity-2B generate call ({INF_ROWS} rows, 14 scales x 32 layers, self- and "
                            "cross-attention)")
    kernels[3]["launches_by_path"] = {
        "var_d16_es_graph_profiled_epoch": var_es["launches_profiled"]["decode_attention"],
        "var_d16_es_eager": var_es["eager"]["launches"]["decode_attention"],
        f"inf_2b_depth{INF_FLOAT_DEPTH}_run_training_warmup": inf_es["launches"]["decode_attention"],
        f"inf_2b_depth{INF_FLOAT_DEPTH}_eager_epoch": inf_es["eager_launches"]["decode_attention"],
        f"inf_2b_depth{INF_FLOAT_DEPTH}_graph_profiled_epoch": inf_es["launches_profiled"]["decode_attention"],
        f"inf_2b_q8_depth{INF_Q8_DEPTH}_run_training_warmup": inf_q8["launches"]["decode_attention"],
        f"inf_2b_q8_depth{INF_Q8_DEPTH}_graph_profiled_epoch": inf_q8["launches_profiled"]["decode_attention"],
        f"inf_2b_q8_depth{INF_Q8_DEPTH}_eager_epoch": inf_q8["eager_launches"]["decode_attention"],
        "weights_inf_2b_run_training_warmup": weights_inf["launches"]["decode_attention"],
        "weights_inf_2b_graph_profiled_epoch": weights_inf["launches_profiled"]["decode_attention"],
        f"inf_2b_depth{INF_FLOAT_DEPTH}_bf16_pop_fuse_call": inf_es["fused_call"]["launches"]["decode_attention"],
        "weights_var_d16_run_training_warmup": weights_var["launches"]["decode_attention"],
        "weights_var_d16_eager_epoch": weights_var["eager_launches"]["decode_attention"],
        "weights_var_d16_graph_profiled_epoch": weights_var["launches_profiled"]["decode_attention"]}
    chained_launches = lambda k: sum(run["launches"][k] for run in chained.values())  # noqa: E731
    for kern in kernels[:3]:
        name = kern["name"]
        kern["launches_by_path"] = {
            "es_flagship_graph_profiled_epoch": es["launches_profiled"][name],
            "es_flagship_eager": es["eager"]["launches"][name],
            "es_flagship_bf16_graph_profiled_epoch": es_float["launches_profiled"][name],
            "es_flagship_bf16_eager": es_float["eager"]["launches"][name],
            "serve_graph_profiled_flush": serve["launches_profiled"][name],
            "serve_eager": serve["eager"]["launches"][name],
            "train_flagship_warmups": train_launches(name), "train_chained_warmups": chained_launches(name),
            "pipeline_es_graph_profiled_epoch": pipeline_es["launches_profiled"][name],
            "pipeline_es_warmup": pipeline_es["launches_counted"][name],
            "serve_pipeline_graph_profiled_flush": tier["pipeline"]["launches_profiled"][name],
            "fleet_flagship_warmup_tick": fleet_run["warmup_launches"][name],
            "fleet_flagship_graph_profiled_tick": fleet_run["launches_profiled"][name],
            "fleet_tiny_warmup_tick": fleet_tiny["launches"][name],
            "fleet_tiny_graph_profiled_tick": fleet_tiny["launches_profiled"][name],
            "train_telemetry_warmup": train["telemetry"]["launches"][name],
            f"inf_2b_q8_depth{INF_Q8_DEPTH}_run_training_warmup": inf_q8["launches"][name],
            f"inf_2b_q8_depth{INF_Q8_DEPTH}_graph_profiled_epoch": inf_q8["launches_profiled"][name],
            f"inf_2b_q8_depth{INF_Q8_DEPTH}_eager_epoch": inf_q8["eager_launches"][name],
            "weights_inf_2b_run_training_warmup": weights_inf["launches"][name],
            "weights_inf_2b_graph_profiled_epoch": weights_inf["launches_profiled"][name],
            f"inf_2b_depth{INF_FLOAT_DEPTH}_bf16_pop_fuse_call": inf_es["fused_call"]["launches"][name],
            "weights_sana_run_training_warmup": weights_sana["launches"][name],
            "weights_sana_eager_epoch": weights_sana["eager_launches"][name],
            "weights_sana_graph_profiled_epoch": weights_sana["launches_profiled"][name],
            "train_artifacts_eager": artifacts["launches"][name],
            "train_artifacts_profile_window": artifacts["kernel_evidence"][name],
            "serve_profile_window_flush": serve["profile_window"]["launches"][name],
            "run_tools_resumed_epoch_warmup": run_tools["launches"][name],
            "preflight_flagship_warmup_child": run_tools["preflight_launches"][name],
            **{path: counts[name] for path, counts in evaluate["launches_by_path"].items()},
        }
        # the kernel at Infinity-2B's shapes: one generate call's calls (K1 on
        # the int8 base, its f32 route included; K2 over a bf16 base; K3 over
        # the int8 base), beside the flagship figures above
        inf_k = kernel_summary(name, inf_rows[name], inf_launches(name), "calls_per_call", kern["replaces"],
                               "one Infinity-2B generate call (8 rows, 14 scales x 32 layers)")
        kern["infinity"] = {k: inf_k[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                                                  "max_abs_err", "scope")}
        if name == "int8_matmul":
            f32 = [r for r in inf_rows[name] if r["dtype"] == "float32"]
            kern["infinity"]["f32_route"] = {k: sum(r[k] * r["calls_per_call"] for r in f32)
                                             for k in ("ms", "plain_ms", "library_ms", "device_ms", "bound_ms")}
        # the kernel at Z-Image-Turbo's shapes: one generate call's calls (one
        # chunk of 8 lanes × 2 images; K3 and K1 on the int8 base, K2 over bf16)
        kern["launches_by_path"]["zimage"] = {
            "run_training_warmup": zimage["launches"][name], "eager_epoch": zimage["eager_launches"][name],
            "graph_profiled_epoch": zimage["launches_profiled"][name],
            "bf16_pop_fuse_call": zimage["fused_call"]["launches"][name], "tiny_eager": zimage_tiny["launches"][name]}
        z_k = kernel_summary(name, zimage_rows[name], zimage_launches(name), "calls_per_call", kern["replaces"],
                             "one Z-Image-Turbo generate call (8 lanes x 2 images, 8 steps x 30 layers, the decoder "
                             "and towers at 512 px)")
        kern["zimage"] = {k: z_k[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                                              "max_abs_err", "scope")}
    kernels[3]["infinity"] = {k: k4_inf[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                     "device_ms", "max_abs_err", "scope")}
    # K4 in situ a call at the full depth: the int8 run's profiled replayed epoch, from the released-layout files
    kernels[3]["infinity"]["in_situ_ms"] = (weights_inf["profile"]["in_situ_ms"]["decode_attention"]
                                            / weights_inf["per_call"]["calls"])
    k1_serve = kernel_summary("int8_matmul", k1_rows, serve["eager"]["launches"]["int8_matmul"], "calls_per_image",
                              "hyperscalees_t2i_tpu/ops/quant_mm.py:86", "one flagship served image")
    # the adapted sites of an image: 8 a DiT block and 4 outside them (the tables count 20 blocks;
    # the bf16-base phase runs es_float["layers"] of them)
    for k, run, epochs in ((kernels[1], es_float, TIMED_EPOCHS),
                           (kernels[2], es, TIMED_EPOCHS + train_eager_epochs + FLEET_W)):
        table = sum(r["calls_per_image"] for r in chain_rows[k["name"]])
        if table != 8 * 20 + 4 or k["launches"] - extra_launches(k["name"]) != \
                (8 * run.get("layers", 20) + 4) * run["images_per_epoch"] * epochs:
            raise AssertionError(f"{k['name']} table and launch count disagree")
    if kernels[0]["launches"] - extra_launches("int8_matmul") != sum(r["calls_per_es_image"] for r in k1_rows) * \
            es["images_per_epoch"] * (TIMED_EPOCHS + train_eager_epochs + FLEET_W):
        raise AssertionError("K1 table and launch count disagree")
    # Infinity-2B: the int8 run's warm-up and its eager epoch (K1, K3; K3 at INF_Q8_DEPTH of the INF_DEPTH
    # blocks the kernel tables count), the bf16 pop_fuse call (K2) at INF_FLOAT_DEPTH of them
    q8_calls = inf_q8["per_call"]["calls"] * (inf_q8["eager_epochs"] + 1)
    for name, want in (("int8_matmul", q8_calls), ("fused_qlora", q8_calls * INF_Q8_DEPTH / INF_DEPTH),
                       ("lora_chain", INF_FLOAT_DEPTH / INF_DEPTH)):
        if inf_launches(name) != sum(r["calls_per_call"] for r in inf_rows[name]) * want:
            raise AssertionError(f"{name}'s Infinity-2B table and launch count disagree")
    # Z-Image: the int8 run's warm-up and its eager epoch (K1, K3), the bf16 pop_fuse call (K2); the
    # block sites' calls at ZIMAGE_ES_LAYERS of the 30 layers the kernel table counts
    z_calls = zimage["per_call"]["calls"] * (zimage["eager_epochs"] + 1)
    depth = ZIMAGE_ES_LAYERS / ZIMAGE_TURBO["n_layers"]
    for name, want in (("int8_matmul", z_calls), ("fused_qlora", z_calls * depth), ("lora_chain", depth)):
        if zimage_launches(name) != sum(r["calls_per_call"] for r in zimage_rows[name]) * want:
            raise AssertionError(f"{name}'s Z-Image table and launch count disagree")
    if train_launches("lora_chain") or train_launches("decode_attention"):
        raise AssertionError("the flagship trainer launched K2 or K4")
    if var_es["eager"]["launches"]["decode_attention"] != sum(r["calls_per_call"] for r in k4_rows) \
            * VAR_ES_LAYERS // VAR_DEPTH * var_es["per_call"]["calls"] * TIMED_EPOCHS:
        raise AssertionError("K4's VAR table and launch count disagree")
    if inf_es["launches"]["decode_attention"] != sum(r["calls_per_call"] for r in k4_inf_rows) * INF_FLOAT_DEPTH \
            // INF_DEPTH * inf_es["per_call"]["calls"] * inf_es["eager_epochs"]:
        raise AssertionError("K4's Infinity table and launch count disagree")
    # the data axis's processes: each one's eval-program warm-up (K3, K1)
    for kern in (kernels[0], kernels[2]):
        per_process = [launches[kern["name"]] for launches in pod["launches"]]
        kern["launches_by_path"]["pod_es_data_axis_warmup_per_process"] = per_process
        kern["launches"] += sum(per_process)
    # the rung runner's ladder child: each rung's warm-up epoch; its --fleet (warm-ups and solo rows) and
    # its --profile child's flagship warm-up
    for kern in kernels:
        name = kern["name"]
        kern["launches_by_path"]["bench_ladder_child_warmups"] = bench["launches"][name]
        kern["launches_by_path"]["bench_fleet_flagship_eager"] = bench["fleet_launches"][name]
        kern["launches_by_path"]["bench_profile_child_warmup"] = bench["profile_launches"][name]
        kern["launches"] += bench["launches"][name] + bench["fleet_launches"][name] + bench["profile_launches"][name]

    wall_s = time.perf_counter() - t_start
    log(f"[done] every phase passed in {wall_s:.1f} s (kernel build included)")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, device=torch.cuda.get_device_name(0), torch=torch.__version__, **build,
        k1_invariant_ranges=k1_invariant, k2_invariant_ranges=k2_invariant, k3_invariant_ranges=k3_invariant,
        k4_invariant_parts=k4_invariant,
        k1_shapes=k1_rows, chain_shapes=chain_rows, k4_shapes=k4_rows, k4_cases=k4_extra, k4_infinity_shapes=k4_inf_rows,
        small_reference_max_abs=small_err, es_tiny=es_tiny, es_tiny_float=es_float_tiny, var_tiny=var_tiny, inf_tiny=inf_tiny,
        inf_q8_tiny=inf_q8_tiny, inf_q8_es=inf_q8, weights_infinity=weights_inf, inf_kernel_shapes=inf_rows,
        es_flagship_float=es_float, serve=serve, var_es=var_es, inf_es=inf_es, es_flagship=es, train_tiny=train_tiny,
        threefry=threefry_rows, train_chained=chained, run_tools=run_tools, pipeline_tiny=pipeline_tiny,
        pipeline_es=pipeline_es, serve_tier=tier,
        train_flagship=train, train_artifacts=artifacts, fleet_tiny=fleet_tiny, fleet_flagship=fleet_run, weights_var=weights_var,
        weights_sana=weights_sana, zimage_kernel_shapes=zimage_rows, zimage_tiny=zimage_tiny, zimage_es=zimage,
        evaluate=evaluate, multiproc_es=multiproc, chaos_es=chaos, pod_es=pod, tp_sp=tp_sp, bench=bench,
        phase_seconds=phase_s, kernels=kernels, k1_serving=k1_serve, k4_infinity=k4_inf,
        wall_s=wall_s,
    ), indent=1))
    for k in kernels + [k1_serve, k4_inf]:
        log(f"[done] {k['name']} ({k['scope']}): {k['ms']:.3f} ms kernel"
            + (f" ({k['device_ms']:.3f} ms device time)" if "device_ms" in k else "") + f", {k['plain_ms']:.3f} ms plain, "
            f"{k['library_ms']:.3f} ms library, {k['bound_ms']:.3f} ms bound ({k['bound_by']}); "
            f"launches {k['launches']}")
    print(json.dumps({"phase_seconds": phase_s, "wall_s": round(wall_s, 1)}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
