"""Hand-written CUDA kernels of the port, each with a plain PyTorch version
beside it (see :mod:`repro_torch.kernels.spike_prop`)."""
