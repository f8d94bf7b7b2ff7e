"""The device an entry point runs on: the card unless the caller asks for the
CPU. Nothing falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device``, or ``cuda`` when it is None. Raises when a CUDA device is
    asked for (or defaulted to) and CUDA is unavailable, naming
    ``device="cpu"`` as the way to run on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: han_tpu_torch runs on the card unless the "
            "caller asks for the CPU (pass device=\"cpu\", or --device cpu)")
    return device
