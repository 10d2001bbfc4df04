"""PyTorch/CUDA port of the persistent and partitioned halo-exchange system.

Stands beside the JAX package ``repro`` and imports nothing of it (nor
``jax``).  Two main paths: the halo exchange, with all ranks of a virtual
process grid stacked in one tensor on one card (:mod:`repro_torch.core.
mesh`), and dense-transformer serving (:mod:`repro_torch.serving.engine`).
The pack kernels, the 27-point stencil and the prefill flash attention are
hand-written CUDA (:mod:`repro_torch.kernels`), each beside a plain PyTorch
version that the CPU path runs.
"""
