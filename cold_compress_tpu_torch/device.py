"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and no card
    is present: the port never continues on the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cold_compress_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU."
        )
    return dev
