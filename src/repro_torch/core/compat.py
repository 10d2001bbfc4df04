"""Device resolution for the PyTorch port.

Every entry point of the port runs on the CUDA card unless its caller asks
for the CPU by name (``device="cpu"``).  Asking for CUDA where there is none
raises: a measurement path never falls back to the CPU silently, because a
CPU number reported under a device name would be a wrong number.
"""

from __future__ import annotations

import torch

#: the device every entry point takes when its caller names none
DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    this process has none (never picks the CPU on its own)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """The Comb barrier: wait for all work queued on ``device``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (the JAX package's dtype names) or a
    torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
