"""Where a public entry point puts its input.

A `torch.Tensor` keeps its own device.  Any other input (a numpy array, a
list) goes to `device`, which defaults to the CUDA card: the CPU is used
only for a CPU tensor or for `device="cpu"`, never silently.
"""

from __future__ import annotations

import torch


def resolve(device: torch.device | str | None = None) -> torch.device:
    """The device a non-tensor input (or data a function makes) goes to:
    `device`, default the CUDA card.  Raises RuntimeError when that is the
    card and there is no CUDA device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a non-tensor input goes to the CUDA device by default, and "
            "there is none: pass a CPU tensor or device='cpu'")
    return device


def as_tensor(x, dtype: torch.dtype | None = None,
              device: torch.device | str | None = None) -> torch.Tensor:
    """`x` as a tensor of `dtype` (kept as it is when None), placed by the
    rule in the module docstring.  Raises RuntimeError for a non-tensor
    input bound for the card when there is no CUDA device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve(device))
