from repro_torch.models.api import Model, batch_spec, build_model, concrete_batch  # noqa: F401

__all__ = ["Model", "batch_spec", "build_model", "concrete_batch"]
