"""The kernels' wrappers and their plain versions: K1 ``quant_mm``, K2
``fused_lora``, K3 ``fused_qlora``, K4 ``attention``, and the shared build
(``_build``)."""

from typing import Dict


def kernel_launches() -> Dict[str, int]:
    """The K1-K4 wrappers' launch counters, by kernel name (kernels launched
    on the card; the plain versions, which the CPU runs, count nothing)."""
    from .attention import decode_attention
    from .fused_lora import member_lora_delta
    from .fused_qlora import fused_qlora_matmul
    from .quant_mm import int8_matmul

    return {"int8_matmul": int8_matmul.launches, "lora_chain": member_lora_delta.launches,
            "fused_qlora": fused_qlora_matmul.launches, "decode_attention": decode_attention.launches}
