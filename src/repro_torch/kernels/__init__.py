"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), each
beside its plain PyTorch version.  Importing builds nothing: a kernel is
compiled by :mod:`repro_torch.kernels._build` at its first launch."""
