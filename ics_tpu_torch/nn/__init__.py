from ics_tpu_torch.nn.layers import Conv2D, Dense, LayerNorm, gelu  # noqa: F401
