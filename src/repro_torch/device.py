"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device raises ``RuntimeError`` when
    ``torch.cuda.is_available()`` is False; nothing carries on on the CPU by
    itself. Pass ``"cpu"`` explicitly to run the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev


def indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device, as
    a tensor placed there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
