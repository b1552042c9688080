"""PyTorch/CUDA port of the EGGROLL-ES text-to-image system, for NVIDIA Hopper.

The JAX package ``hyperscalees_t2i_tpu`` beside this one is the reference;
this package imports neither it nor ``jax``. Module names follow the JAX
package so each unit's counterpart is easy to find. What is ported so far is
the Sana-Sprint serving path:

``serve.engine.ServeEngine`` → ``parallel.pop_eval.make_adapter_batch_generator``
→ ``backends.sana_backend.SanaBackend.generate_p`` → ``models.sana`` (DiT +
one-step sampler) and ``models.dcae`` (decoder), with every int8 dense site
going through the hand-written CUDA kernel in ``csrc/int8_matmul.cu``
(``ops.quant_mm.int8_matmul``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request they raise (:mod:`.device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
