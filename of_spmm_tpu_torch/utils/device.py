"""Which device an entry point runs on."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The card unless the caller names another device.

    With ``device=None`` and no CUDA device this raises instead of carrying
    on on the CPU: a run that was meant for the card must not silently
    measure or serve from the host. Pass ``device="cpu"`` to run there.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def place_arrays(obj, device, memo: Optional[dict] = None):
    """``obj`` with every numpy array and tensor in it (through dataclasses
    and tuples) as a torch tensor on ``device``, preserving sharing: an
    object referenced twice is copied once (``memo`` maps ids to copies)."""
    memo = {} if memo is None else memo
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        res = torch.as_tensor(obj, device=device)
    elif dataclasses.is_dataclass(obj):
        res = dataclasses.replace(obj, **{f.name: place_arrays(getattr(obj, f.name), device, memo)
                                          for f in dataclasses.fields(obj)})
    elif isinstance(obj, tuple):
        res = tuple(place_arrays(o, device, memo) for o in obj)
    else:
        res = obj
    memo[key] = res
    return res
