"""PyTorch / CUDA port of parsenet_tpu for one NVIDIA H100.

The package mirrors the JAX package's layout module for module, so each
counterpart is easy to find. It never imports jax or parsenet_tpu; what it
needs from there it keeps as its own copy. The TPU's Pallas kernels become
hand-written CUDA C++ for sm_90a under `csrc/`, built on first use by
`ops.kernels`.

Entry points run on the card unless the caller passes device="cpu"; without
a CUDA device they raise rather than run on the CPU.
"""
