"""PyTorch/CUDA port of ``opticalflowdiffusion_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here has a
counterpart at the same relative path there, and ``tests/test_torch_port_*``
hold each against it on the same inputs and weights.

Layout: images, flows and feature maps are NCHW tensors (the JAX package is
NHWC).  Flow channels keep the JAX order ``(dx, dy)``.  The linear-attention
ops take the flattened NCHW map, ``(B, C, N)`` with ``N = H * W``.

Device: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  On a CUDA tensor every op that has a hand-written kernel
launches it (or raises); its plain-PyTorch version runs only for CPU tensors.

This package imports torch, numpy and the standard library only: nothing of
JAX, flax, yaml or the JAX package.
"""
