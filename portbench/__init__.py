"""The benchmark of the PyTorch/CUDA port ``repro_torch`` (see README.md).
Nothing here imports JAX or the JAX package ``repro``; the plain
reference (``portbench.reference``) imports nothing of the program."""
