from repro_torch.serving.engine import EngineStats, Request, ServingEngine  # noqa: F401
