"""Hand-written CUDA kernels of the port, one package per TPU kernel of the
JAX package, and ``flash`` (causal attention, which the JAX package leaves
to plain jnp): ``<name>.cu`` (the kernel, for sm_90a), ``ops.py`` (the
wrapper: the plain version for CPU tensors, the kernel for CUDA tensors)
and ``ref.py`` (the plain PyTorch version). ``_build`` compiles every
``.cu`` into one library at first use."""
