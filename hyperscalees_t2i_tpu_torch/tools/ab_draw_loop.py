"""Times the stream's chunked draw loop (``utils.threefry._draw``) against a
variant that slices the key words once, outside the chunk loop, on the
VAR-d16 and Infinity-2B Gumbel draws of one generate call, in one process
and in turns (a, b, b, a, a, b; CUDA events over 5 calls each). Both must
draw the same values.

Run from the repo root on a CUDA host:
    PYTHONPATH=. python3 hyperscalees_t2i_tpu_torch/tools/ab_draw_loop.py
"""

from __future__ import annotations

import math
import subprocess

import torch


def hoisted_draw(key, shape, convert, dtype):
    """``_draw`` with the key words sliced once, outside the chunk loop."""
    from hyperscalees_t2i_tpu_torch.utils import threefry as tf

    shape = tf._shape(shape)
    n = math.prod(shape)
    keys = key.reshape(-1, 2)
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=key.device)
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    step = max(1, tf.CHUNK // max(keys.shape[0], 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
        b1, b2 = tf.threefry2x32(k1, k2, idx >> 32, idx & tf.MASK)
        out[:, lo:hi] = convert(b1 ^ b2)
    return out.reshape((*key.shape[:-1], *shape))


def _time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    from hyperscalees_t2i_tpu_torch.ops.sampling import per_scale_gumbel
    from hyperscalees_t2i_tpu_torch.rungs import RUNG_PLAN, infinity_rung_model, var_rung_model
    from hyperscalees_t2i_tpu_torch.utils import threefry as tf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    vm, im = var_rung_model("d16")["bcfg"].model, infinity_rung_model("2b")["bcfg"].model
    paths = {
        "var_d16_gumbel": lambda: per_scale_gumbel(tf.prng_key(6, dev), range(RUNG_PLAN["ar_d16"][2]),
                                                   vm.patch_nums, (vm.vq.vocab_size,)),
        "inf_2b_gumbel": lambda: per_scale_gumbel(tf.prng_key(6, dev), range(RUNG_PLAN["inf_2b"][2]),
                                                  im.patch_nums, (im.vq.bits, 2)),
    }
    current = tf._draw
    draws = {"current": current, "hoisted": hoisted_draw}
    try:
        for name, fn in paths.items():
            outs = {}
            for which, draw in draws.items():
                tf._draw = draw
                outs[which] = fn()
            same = all(torch.equal(a, b) for a, b in zip(outs["current"], outs["hoisted"]))
            times = {"current": [], "hoisted": []}
            for which in ("hoisted", "current", "current", "hoisted", "hoisted", "current"):
                tf._draw = draws[which]
                times[which].append(_time_ms(fn))
            print(f"{name}: outputs equal {same}; " +
                  "; ".join(f"{w} {', '.join(f'{v:.3f}' for v in ts)} ms" for w, ts in times.items()))
    finally:
        tf._draw = current


if __name__ == "__main__":
    main()
