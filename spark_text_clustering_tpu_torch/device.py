"""Device policy for the PyTorch port.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
is written for the card, and a host without one raises instead of
quietly running the plain CPU versions.  Callers that want the CPU (the
tests) ask for it with ``device="cpu"``.

Count paths are float32 end to end.  Resolving a CUDA device turns TF32
off for matrix products and cuDNN, so no f32 product silently rounds to
ten mantissa bits.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``).  Raises
    ``RuntimeError`` when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
