"""Device resolution and host-to-device copies shared by the port's entry
points."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def to_device(values, dtype, device: torch.device) -> torch.Tensor:
    """Host values (a numpy array, a list) as a new tensor of ``dtype`` on
    ``device``. To a CUDA device the copy goes through pinned memory and is
    asynchronous, so that the host does not wait for the work already
    queued on the card (a pipelined decode window, an overlapped prefill)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)
