"""spider-tpu's PyTorch port for NVIDIA Hopper GPUs.

It sits beside the JAX package ``spider_tpu`` (the reference it is tested
against), keeps that package's layout (``ops/``, ``models/``,
``models/pipelines/``, ``serving/``, ``runners/``, ``tasks/``, ``datasets/``,
``processors/``, ``common/``) and imports no JAX. The
TPU's Pallas kernels become hand-written CUDA kernels under ``csrc/``, built
with nvcc at their first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
