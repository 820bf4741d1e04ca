"""Device choice and the float32 precision policy.

Every entry point resolves its ``torch.device`` here. The default is
``cuda``; the CPU runs only when the caller asks for it (``DEVICE=cpu`` or
``device="cpu"``). Asking for ``cuda`` on a machine without a card raises:
the port never carries on on the CPU in its place.

The reference scores in full float32, so TF32 stays off for matrix products
and for cuDNN.
"""

from __future__ import annotations

import torch

from fraud_detection_tpu_torch import config


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32). Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` when given,
    else ``DEVICE`` (default ``cuda``). Raises ``RuntimeError`` for
    ``cuda`` when no card is present."""
    set_precision_policy()
    dev = torch.device(device if device is not None else config.device_backend())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False — set DEVICE=cpu (or pass device='cpu') to run on the "
                "CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev
