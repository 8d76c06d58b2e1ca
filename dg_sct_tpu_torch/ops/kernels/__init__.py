"""The port's CUDA kernels: K1 window attention, K2 attention half-block,
K3 adapter bottleneck, K4 int8 linear (its int8 GEMM, and the quantize of its
input as a kernel of its own). Each module holds the wrapper (kernel on a CUDA
tensor, plain version on a CPU tensor), the plain version and the launch
count."""
from __future__ import annotations

from . import adapter_bottleneck, block_attention, int8_linear, window_attention

KERNELS = {
    "window_attention": window_attention.KERNEL,
    "block_attention": block_attention.KERNEL,
    "adapter_bottleneck": adapter_bottleneck.KERNEL,
    "int8_linear": int8_linear.KERNEL,
    "int8_quantize": int8_linear.QUANTIZE,
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
