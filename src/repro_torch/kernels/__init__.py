"""The port's CUDA kernels, each with its plain PyTorch version.

One module a kernel family (``segmented_agg``, ``hash_probe``,
``block_prefix_sum``, ``radix_histogram``, ``flash_attention``; the fused
programs live in ``core/fused.py``); ``ops`` keeps the dispatch accounting,
the launch counters and the public ``flash_attention`` entry point;
``build`` compiles ``csrc/*.cu`` at first use. Importing this package
builds and loads nothing.
"""

from .flash_attention import flash_attention

__all__ = ["flash_attention"]
