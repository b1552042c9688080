"""Quantization, the int8 dequant-matmul and its CUDA kernel."""
