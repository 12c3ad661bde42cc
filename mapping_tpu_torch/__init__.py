"""mapping_tpu_torch — the PyTorch and CUDA port of mapping_tpu for one
NVIDIA H100.

The JAX package `mapping_tpu` stays the reference; each module here is
named after its counterpart there and is tested against it on the same
inputs. This package imports torch and never jax, flax, pandas, pyyaml,
click, Pillow or msgpack. Hand-written CUDA kernels live in `csrc/` and
are wrapped in `kernels/`; the CLI is `python3 -m mapping_tpu_torch.main`.
"""
