"""Device and dtype resolution shared by the entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (default CPU).  Asking for CUDA
    where there is none raises: the port never falls back to the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (float32 or float64)."""
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {dtype}")
        return dtype
    table = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}
    try:
        return table[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype}") from None


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(np.float32 if dtype == torch.float32 else np.float64)
