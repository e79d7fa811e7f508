"""Device selection for the port.

Every entry point takes an explicit `device`; nothing reads a global backend.
`resolve_device("cuda")` without a visible card raises instead of running on
the CPU.

Numerics on the card: float32 matrix products and convolutions run in full
float32, never TF32 (`allow_tf32 = False` for both cuBLAS and cuDNN). The JAX
reference resizes its image pyramid with HIGHEST-precision matmuls
(`bundleadjustment_tpu/ops/features.py:_resize_linear`), and TF32 would keep
about three decimal digits of the interpolated pixels.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Return a `torch.device` for "cpu" / "cuda" / "cuda:N" and set up the
    card's numerics. Raises RuntimeError for a CUDA device without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
