"""PyTorch / CUDA port of gen_adversarial_tpu for NVIDIA Hopper (H100).

The JAX package `gen_adversarial_tpu` is the reference this package is held
against; nothing here imports it (or JAX). Module paths mirror the JAX
package. Modules run NCHW tensors in `torch.channels_last` memory format;
the public defense and purify functions take and return NHWC images, as the
JAX package does.

Hand-written kernels live in `csrc/` and are built by `nvcc` into a plain-C
shared library at first use (`core/cuda_build.py`). On a CPU tensor every
kernel wrapper runs its plain PyTorch version instead.
"""
