"""A frozen copy of the plain PyTorch paths of parsenet_tpu_torch.

The modules under this package are copies of the port's modules of the
same names as they stood when the benchmark was written, with the CUDA
kernels replaced by their plain versions (ops/kernels.py), the
data-parallel gathers removed (models/splinenet.py) and the precision
policy made switchable (core/guards.py). They import nothing of the port,
of the JAX package or of JAX, so a later change to the program cannot move
the yardstick. Relative imports only: the package is found as
`reference.plain` from the benchmark's folder.
"""
