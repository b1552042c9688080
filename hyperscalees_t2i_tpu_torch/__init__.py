"""PyTorch/CUDA port of the EGGROLL-ES text-to-image system, for NVIDIA Hopper.

The JAX package ``hyperscalees_t2i_tpu`` beside this one is the reference;
this package imports neither it nor ``jax``. Module names follow the JAX
package so each unit's counterpart is easy to find. What is ported so far:

- Sana-Sprint serving: ``serve.engine.ServeEngine`` →
  ``parallel.pop_eval.make_adapter_batch_generator`` →
  ``backends.sana_backend.SanaBackend.generate_p`` → ``models.sana`` (DiT +
  one-step sampler) and ``models.dcae`` (decoder), every int8 dense site on
  the CUDA kernel ``csrc/int8_matmul.cu`` (K1);
- the EGGROLL-ES epoch (``train.trainer.make_es_step``) over the Sana
  backend (K3 ``csrc/fused_qlora.cu``, K2 ``csrc/lora_chain.cu``) and over
  the VAR backend (``backends.var_backend`` → ``models.var`` →
  ``models.msvq``) and the Infinity backend (``backends.infinity_backend``
  → ``models.infinity`` → ``models.bsq``), whose KV-cache and text
  attention is K4 ``csrc/decode_attention.cu``, and the Z-Image backend
  (``backends.zimage_backend`` → ``models.zimage`` → ``models.vaekl``,
  the dual adapter with conv LoRA on the decoder; K3 and K1);
- the single-process trainer around the step: ``train.trainer.run_training``
  (``metrics.jsonl``, per-prompt quality attribution and ``quality.jsonl``
  from ``obs.quality``, checkpoint slots from ``resilience.checkpoints``
  in the JAX package's file format, resume, the non-finite rollback,
  SIGTERM/SIGINT preemption) and its CLI, ``python -m
  hyperscalees_t2i_tpu_torch.train.cli``;
- the JAX noise stream, ``utils.threefry`` (threefry2x32 keys, ``split``,
  ``fold_in``, ``normal``, Gumbel, ``randint``): every draw of the port
  follows the JAX package's key tree, so a seed gives its numbers;
- one program per step, ``utils.graphs``: a CUDA graph per ES plan and per
  serving geometry on the card (the JAX package's AOT programs), and
  chained dispatch (``steps_per_dispatch``) in ``run_training``;
  ``tools/dispatch_tax.py`` times it against the eager step.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request they raise (:mod:`.device`).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # the package imports torch only when a module needs it: the rung
    # runner's parent process (tools/bench.py) and the window queue import
    # the package's stdlib-only modules and never load torch
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
