"""Device resolution and host→device metadata transfer.

Entry points run on the card unless the caller asks for the CPU: a
missing GPU raises, it never silently becomes a CPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None means the card. Raises when a CUDA device is asked for (or
    defaulted to) on a host without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default — pass device='cpu' to run the plain versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to(arr, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy host data (numpy array or CPU tensor) to `device` without
    waiting on the card: CUDA copies go through pinned memory and are
    enqueued on the current stream."""
    t = torch.as_tensor(np.ascontiguousarray(arr) if isinstance(
        arr, np.ndarray) else arr)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone() if t.device == device else t.to(device)
