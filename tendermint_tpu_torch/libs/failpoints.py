"""Named failpoints (reference: libs/failpoints.py), trimmed to the two
points of the device path and to the `error` and `corrupt` actions.

    error         raise FailpointError(name) from the call site
    corrupt       the call site's payload bytes come back bit-flipped
                  and truncated; on a point with no payload it degrades
                  to `error`

A trigger decides which armed hits fire: ``nth=N`` only the N-th
(1-based), ``count=N`` disarm after N fires; with none, every hit
fires. Arm with ``arm(name, action, nth=...)``;
``hit(name, payload)`` is the call-site hook, a dict lookup when
nothing is armed.
"""

from __future__ import annotations

import logging
import threading

logger = logging.getLogger("failpoints")

ACTIONS = ("error", "corrupt")

# name -> the call site passes a payload through hit()
CATALOG: dict[str, bool] = {
    # a device batch-verification launch (the general kernel, the
    # sr25519 kernel, the expanded commit path, the speculation arena)
    "device.verify": False,
    # one entry of the verify mesh, evaluated per entry in mesh order at
    # every dispatch (crypto/cuda/verify.py effective_mesh): the payload
    # is the entry's name, so `nth=K` selects the K-th entry; `error`
    # models a raising device, `corrupt` a wrong-verdict one — either
    # evicts ONLY that entry
    "device.shard_fail": True,
}


class FailpointError(Exception):
    """Raised by an armed `error` (or payload-less `corrupt`) point."""

    def __init__(self, name: str):
        super().__init__(f"injected failpoint {name!r}")
        self.name = name


class _Armed:
    __slots__ = ("action", "nth", "count", "hits")

    def __init__(self, action: str, nth: int | None, count: int | None):
        self.action = action
        self.nth = nth
        self.count = count  # remaining fires before auto-disarm
        self.hits = 0


_lock = threading.Lock()
_ACTIVE: dict[str, _Armed] = {}


def arm(name: str, action: str, *, nth: int | None = None,
        count: int | None = None) -> None:
    """Arm `name` with `action`. Raises ValueError on an unknown point,
    action or trigger."""
    if name not in CATALOG:
        raise ValueError(f"unknown failpoint {name!r}")
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    for label, v in (("nth", nth), ("count", count)):
        if v is not None and v < 1:
            raise ValueError(f"{label} must be >= 1")
    with _lock:
        _ACTIVE[name] = _Armed(action, nth, count)
    logger.warning("failpoint armed: %s %s", name, action)


def disarm(name: str) -> bool:
    with _lock:
        return _ACTIVE.pop(name, None) is not None


def disarm_all() -> int:
    with _lock:
        n = len(_ACTIVE)
        _ACTIVE.clear()
    return n


def any_armed() -> list[str]:
    """Names of the armed points."""
    with _lock:
        return sorted(_ACTIVE)


def _corrupt_bytes(data: bytes) -> bytes:
    """Flip one bit mid-payload and drop the final byte (if any)."""
    b = bytearray(data)
    if not b:
        return b"\xff"
    b[len(b) // 2] ^= 0x01
    return bytes(b[:-1]) if len(b) > 1 else bytes(b)


def _fires(name: str) -> str | None:
    """Count a hit of an armed point; its action when the hit fires."""
    armed = _ACTIVE.get(name)
    if armed is None:
        return None
    with _lock:
        if _ACTIVE.get(name) is not armed:  # racing disarm / re-arm
            return None
        armed.hits += 1
        if armed.nth is not None and armed.hits != armed.nth:
            return None
        if armed.count is not None:
            armed.count -= 1
            if armed.count <= 0:
                _ACTIVE.pop(name, None)
    logger.warning("failpoint firing: %s action=%s", name, armed.action)
    return armed.action


def hit(name: str, payload: bytes | None = None):
    """The call-site hook. Returns `payload` (transformed by an armed
    `corrupt`): call sites with a payload must use the return value."""
    action = _fires(name)
    if action is None:
        return payload
    if action == "corrupt" and payload is not None:
        return _corrupt_bytes(payload)
    raise FailpointError(name)
