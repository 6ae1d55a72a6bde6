"""ics_tpu_torch — the PyTorch and CUDA port of ``ics_tpu`` for an NVIDIA H100.

``ics_tpu`` (JAX) stays the reference. This package mirrors its module
names and stands on its own: it imports ``torch``, never ``jax``, and nothing
of ``ics_tpu``. The host tiers are its own copies of the JAX package's
JAX-free modules (same names, same behaviour); the modules that touch the
device are ports.

- ``ops``      — hand-written CUDA kernels (flash attention, fused bottleneck
                 chain, uint8 normalize, depthwise convolution, window
                 attention) and the plain PyTorch versions beside them; fp32
                 preprocessing; the JPEG decode from DCT coefficients
- ``nn``       — layers and blocks of the ported models
- ``models``   — ViT, ResNet, ConvNeXt, MobileNetV3, EfficientNet, Swin and the
                 registry of ported models
- ``weights``  — JAX parameter and state trees (as numpy) into state dicts
- ``parallel`` — the device mesh (data parallelism, the tensor-parallel head)
                 and GPipe pipeline stages, driven from one process
- ``runtime``  — inference engine and service (pixel and device-decode lanes),
                 batcher, host decode, coefficient staging, hedged replicas
- ``api``      — the routers; ``main`` — app and entry point
- ``core``, ``web``, ``db``, ``crud``, ``schemas``, ``services``, ``utils``,
  ``native``, ``sync.nextcloud_client`` — host tiers, copied
- ``tools``    — measurement scripts for the GPU
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def get_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device the port computes on.

    With no argument: the current CUDA device, or ``RuntimeError`` when none
    is visible. There is no CPU fallback; a CPU run happens only where the
    caller names ``"cpu"``, as the tests do. A CUDA device always comes back
    with its index (``"cuda"`` resolves to the current one), so what an
    engine or a tensor is placed on does not change with whatever device a
    thread has made current since.
    """
    dev = torch.device("cuda" if name is None else name)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        if name is None:
            raise RuntimeError(
                "no CUDA device is visible; ics_tpu_torch computes on a GPU "
                "(pass device='cpu' explicitly for a CPU run)"
            )
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def disable_tf32() -> None:
    """Full fp32 for cuBLAS matmuls and cuDNN convolutions. PyTorch lets
    cuDNN use TF32 by default; the reference computes its fp32 paths (the
    resize matmuls, the fp32 forward) in full fp32, so the port does too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
