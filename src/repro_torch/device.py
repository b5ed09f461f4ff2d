"""The one device rule every entry point applies."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate a requested device: ``cuda`` (the default everywhere) or
    ``cpu``, which only an explicit request selects.

    A CUDA request on a machine without a usable GPU raises; it never
    degrades to the CPU.  On CUDA, TF32 is switched off for matmuls and
    cuDNN: it keeps about three decimal digits, and the fp32 paths are held
    to 1e-5 against the reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
