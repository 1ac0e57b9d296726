"""The device the port's entry points run on.

CUDA by default. ``set_default_device("cpu")`` is the only way to run
the device path on the CPU (every kernel wrapper then uses its plain
PyTorch version); without it, and without a GPU, ``default_device()``
raises instead of carrying on on the CPU.

The multi-device paths run over a mesh: a list of devices, one entry a
shard. By default it is every CUDA device when there are at least two,
else there is none. ``set_mesh`` pins it, and an entry may repeat: four
entries of one card are four logical shards (four table blocks, four
lane sets, four launches on four streams), the counterpart of the
reference's virtual XLA devices.
"""

from __future__ import annotations

# torch is imported where a device is made, not here: the command line's
# key and home commands import this module (through crypto/batch.py) and
# need no torch.
_DEFAULT = None  # torch.device | None
_MESH = None  # tuple[torch.device, ...] | None


class NoDeviceError(RuntimeError):
    """No CUDA device and no ``set_default_device("cpu")``: a
    configuration error, never a device failure, so the breakers of
    crypto/batch.py let it through to the caller."""


def set_default_device(name: str | torch.device | None) -> None:
    """Pin the device for the port's entry points ("cpu" or "cuda");
    None restores the CUDA default."""
    global _DEFAULT
    import torch

    _DEFAULT = None if name is None else torch.device(name)


def default_device() -> torch.device:
    if _DEFAULT is not None:
        return _DEFAULT
    import torch

    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device available; call "
            "tendermint_tpu_torch.device.set_default_device('cpu') to "
            "run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def _checked(mesh: tuple[torch.device, ...]) -> tuple[torch.device, ...]:
    want = default_device().type
    bad = [str(d) for d in mesh if d.type != want]
    if bad:
        raise ValueError(f"mesh entries {bad} are not of the default "
                         f"device's type ({want})")
    return mesh


def set_mesh(devices) -> None:
    """Pin the mesh of the multi-device paths to these devices (names or
    torch.device, repeats allowed); None restores the default. Every
    entry must be of the default device's type: a CPU entry under a
    CUDA default raises ValueError, and so does the reverse."""
    global _MESH
    import torch

    if devices is None:
        _MESH = None
        return
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("an empty mesh; pass None for the default")
    _checked(mesh)
    _MESH = tuple(torch.device("cuda", torch.cuda.current_device())
                  if d.type == "cuda" and d.index is None else d
                  for d in mesh)


def mesh_devices() -> tuple[torch.device, ...] | None:
    """The pinned mesh, else every CUDA device when the default device
    is CUDA and there are at least two, else None."""
    if _MESH is not None:
        return _checked(_MESH)
    import torch

    if default_device().type == "cuda" and torch.cuda.device_count() >= 2:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return None
