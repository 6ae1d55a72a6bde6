from ics_tpu_torch.core.config import settings  # noqa: F401
