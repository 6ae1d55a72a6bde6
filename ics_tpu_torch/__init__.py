"""ics_tpu_torch — the PyTorch and CUDA port of ``ics_tpu`` for an NVIDIA H100.

``ics_tpu`` (JAX) stays the reference. This package mirrors its module
names for the parts that touch the device and imports its JAX-free host
tiers as they are: ``web``, ``db``, ``crud``, ``core``, ``services``,
``schemas``, ``utils``, ``native``, ``runtime.batcher`` and
``runtime.decode``. It imports ``torch`` and never ``jax``.

- ``ops``      — hand-written CUDA kernels (flash attention) and the plain
                 PyTorch versions beside them; fp32 preprocessing
- ``nn``       — the layers ViT needs
- ``models``   — ViT and the registry of ported models
- ``weights``  — JAX parameter trees (as numpy) into state dicts
- ``runtime``  — inference engine and service for the host-decode lane
- ``api``      — the ``/inferencia`` routes; ``main`` — app and entry point
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def get_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device the port computes on.

    With no argument: the CUDA device, or ``RuntimeError`` when none is
    visible. There is no CPU fallback; a CPU run happens only where the
    caller names ``"cpu"``, as the tests do.
    """
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; ics_tpu_torch computes on a GPU "
                "(pass device='cpu' explicitly for a CPU run)"
            )
        return torch.device("cuda")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev


def disable_tf32() -> None:
    """Full fp32 for cuBLAS matmuls and cuDNN convolutions. PyTorch lets
    cuDNN use TF32 by default; the reference computes its fp32 paths (the
    resize matmuls, the fp32 forward) in full fp32, so the port does too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
