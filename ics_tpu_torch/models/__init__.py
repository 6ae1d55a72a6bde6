from ics_tpu_torch.models.registry import get_model, list_models  # noqa: F401
