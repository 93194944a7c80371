"""Which device an entry point runs on."""

from __future__ import annotations

from typing import Optional, Union

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
