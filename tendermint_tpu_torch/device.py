"""The device the port's entry points run on.

CUDA by default. ``set_default_device("cpu")`` is the only way to run
the device path on the CPU (every kernel wrapper then uses its plain
PyTorch version); without it, and without a GPU, ``default_device()``
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

_DEFAULT: torch.device | None = None


def set_default_device(name: str | torch.device | None) -> None:
    """Pin the device for the port's entry points ("cpu" or "cuda");
    None restores the CUDA default."""
    global _DEFAULT
    _DEFAULT = None if name is None else torch.device(name)


def default_device() -> torch.device:
    if _DEFAULT is not None:
        return _DEFAULT
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; call "
            "tendermint_tpu_torch.device.set_default_device('cpu') to "
            "run the plain PyTorch versions on the CPU")
    return torch.device("cuda")
