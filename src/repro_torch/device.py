"""Where the port's entry points run: the card, unless the caller asks for
the CPU. A missing card is an error, never a quiet fall back to the CPU.

``meta`` is taken too, only where a caller names it: tensors there hold
shapes and no data, so a step run on them computes nothing and counts
its operations and bytes (``launch/op_cost.py``, the dry run)."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and absent;
    ``cpu`` and ``meta`` are taken as named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_count(device: torch.device) -> int:
    """The devices present of ``device``'s kind: the cards on ``cuda``,
    one otherwise."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, without making the host wait.

    On the card the array is copied into fresh pinned memory and sent with
    ``non_blocking=True``: a copy from pageable memory would synchronise
    the stream. PyTorch's pinned-memory cache does not hand the buffer out
    again before the copy has run. On the CPU it is a plain copy, so the
    caller may reuse its array at once."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)
