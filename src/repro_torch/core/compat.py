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
    this process has none (never picks the CPU on its own).  ``"meta"`` is
    taken only when the caller names it: shapes and dtypes without storage,
    which the dry-run (:mod:`repro_torch.launch.dryrun`) builds its cells
    from."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or meta)")
    return dev


def device_name(device: torch.device) -> str:
    """What a record names its device by: the card's name, or ``"cpu"``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


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
