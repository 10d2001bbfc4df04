"""PyTorch/CUDA port of the persistent and partitioned halo-exchange system.

Stands beside the JAX package ``repro`` and imports nothing of it (nor
``jax``).  All ranks of a virtual process grid live stacked in one tensor
on one card (:mod:`repro_torch.core.mesh`); the pack kernels and the
27-point stencil are hand-written CUDA (:mod:`repro_torch.kernels`), each
beside a plain PyTorch version that the CPU path runs.
"""
