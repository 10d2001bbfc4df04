from repro_torch.parallel.context import LOCAL, ParallelContext  # noqa: F401
