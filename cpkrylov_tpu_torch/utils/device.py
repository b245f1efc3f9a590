"""Device and dtype resolution shared by the entry points, and the two
ways values cross between the host and the device: :func:`upload` and
:func:`host_read`, each inside its profiler span."""
from __future__ import annotations

import numpy as np
import torch

from .profiling import HOST_READ_SPAN, UPLOAD_SPAN, span


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None (every entry point's default)
    is the CUDA card.  Asking for CUDA where there is none raises: the port
    never falls back to the CPU, which a caller asks for by name ("cpu")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        what = ("the default device (CUDA)" if device is None
                else f"device {device!r}")
        raise RuntimeError(f"{what} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
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


def upload(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` (a numpy array, a sequence or a tensor) on ``device`` as
    ``dtype`` (default its own), inside a ``cpkrylov.upload`` span.  As
    ``torch.as_tensor(a).to(...)``: on the host in its own dtype, the
    result may share ``a``'s memory."""
    with span(UPLOAD_SPAN):
        return torch.as_tensor(a).to(device=device, dtype=dtype)


def host_read(t: torch.Tensor):
    """The values of device tensor ``t`` on the host (``t.tolist()``: a
    Python scalar for a 0-d tensor), inside a ``cpkrylov.host_read`` span:
    the span's length is how long the host waited for the device."""
    with span(HOST_READ_SPAN):
        return t.tolist()
