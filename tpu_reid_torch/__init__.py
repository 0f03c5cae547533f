"""PyTorch/CUDA port of tpu_reid for one NVIDIA H100.

The package mirrors `tpu_reid/`'s layout and function names so each
function's JAX counterpart is found at the same path. It imports torch,
numpy, `regex` (the tokenizer) and the standard library, never jax or
tpu_reid; the hand-written CUDA kernels live in `csrc/` and are built at
first use (`ops/_build.py`).
"""
