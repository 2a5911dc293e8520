"""exllamav3_tpu_torch: the PyTorch/CUDA port of exllamav3_tpu.

The JAX package `exllamav3_tpu` is the reference; this package keeps its
layout and module names so every file has an obvious counterpart. It imports
torch and numpy only, never jax and nothing of `exllamav3_tpu`.

Idiom: modules are static descriptions (no tensors) and the weights live in
a plain parameter dict keyed by module key, `forward(x, params, ctx)` being a
plain function of tensors. That is the JAX package's own structure, so a
parameter dict carries across between the two packages unchanged
(`util/params.py`).

Devices: every entry point takes a `device` and defaults to "cuda". Without
CUDA it raises; it runs on the CPU only when the caller passes
`device="cpu"`. Kernel wrappers (ops/) launch their hand-written Hopper
kernel for a CUDA tensor and use the plain PyTorch version for a CPU tensor.
"""
