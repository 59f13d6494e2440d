"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Return ``device`` as a ``torch.device``, refusing a CUDA device when
    none is present: the entry points never fall back to the CPU quietly.

    On CUDA this also turns TF32 off for float32 matrix products. The MLPs
    multiply bf16-rounded operands in float32, as the JAX package does with
    ``preferred_element_type=float32``; TF32 would cut the float32
    accumulation inputs to 10 mantissa bits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
