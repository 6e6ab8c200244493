"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available: the port never falls back to the
    CPU on its own — a caller that wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU"
            )
        if dev.index is None:
            # Tensors report "cuda:<index>": name the index so device
            # comparisons hold.  Before CUDA is initialised the current
            # device is 0, and asking for it would initialise CUDA (a
            # driver that only builds a module for remote workers must
            # not).
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_initialized() else 0)
    return dev
