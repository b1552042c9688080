"""The multi-tenant serving generator (port of
``make_adapter_batch_generator`` from
``hyperscalees_t2i_tpu/parallel/pop_eval.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..es.noiser import stacked_adapter_theta

GenerateFn = Callable[..., torch.Tensor]


def make_adapter_batch_generator(
    generate_p: GenerateFn,
    adapter_batch: int,
    images_per_request: int,
    member_batch: int = 0,
) -> Callable[..., torch.Tensor]:
    """``gen_batch(stacked_theta, flat_ids [n, B], seeds [n], noise=None,
    guidance_scale=None) → images [n, B, H, W, C]`` for ``n <= adapter_batch``
    lanes, each lane one request with its own adapter and seed.

    Lanes run in chunks of ``member_batch`` (0 = all lanes in one chunk).
    Inside a chunk every base matmul takes all the chunk's rows at once and
    each lane's LoRA applies to its own rows (``lora.lora_delta``).
    Image ``j`` of a lane draws its noise from (lane seed, ``j``) only, so a
    request gives the same image served alone or in any batch."""
    A, B = adapter_batch, images_per_request
    if A < 1 or B < 1:
        raise ValueError(
            f"adapter_batch and images_per_request must be >= 1, got ({adapter_batch}, {images_per_request})"
        )

    def gen_batch(
        stacked_theta: Optional[Any],
        flat_ids: Any,
        seeds: Sequence[int],
        noise: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        ids = torch.as_tensor(flat_ids, dtype=torch.long)
        n = ids.shape[0]
        if not 1 <= n <= A or ids.shape[1] != B:
            raise ValueError(f"flat_ids {tuple(ids.shape)} does not fit the ({A}, {B}) serving geometry")
        chunk = min(member_batch, n) if member_batch > 0 else n
        outs = []
        for k0 in range(0, n, chunk):
            lanes = slice(k0, min(k0 + chunk, n))
            theta = None if stacked_theta is None else stacked_adapter_theta(stacked_theta, lanes)
            outs.append(generate_p(
                theta, ids[lanes], list(seeds[lanes]),
                noise=None if noise is None else noise[lanes],
                guidance_scale=guidance_scale,
            ))
        return torch.cat(outs)

    return gen_batch
