"""PyTorch + CUDA port of vtoonify_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (ops/, nn/layers.py, models/, pipeline/,
convert/). Imports torch, never jax. The hand-written kernels live in
csrc/ and are bound in ops/kernels.py.
"""
