"""Named failpoints (reference: libs/failpoints.py), trimmed to the
points of the device path, the light serving plane, the block store,
the ABCI connections, the mempool admission plane, the commit
pipeline (the consensus state machine's commit, the block executor,
the consensus WAL, the persistent KV stores, the FilePV's last-sign
state), the speculation plane, the p2p send path and state sync, and to the
`error`, `delay` and `corrupt` actions.

    error         raise FailpointError(name) from the call site
    delay         time.sleep(delay_ms) at the call site (stall shape)
    corrupt       the call site's payload bytes come back bit-flipped
                  and truncated; on a point with no payload it degrades
                  to `error`

A trigger decides which armed hits fire: ``nth=N`` only the N-th
(1-based), ``count=N`` disarm after N fires; with none, every hit
fires. Arm with ``arm(name, action, nth=..., delay_ms=...)``;
``hit(name, payload)`` is the call-site hook, a dict lookup when
nothing is armed; ``hit_async`` is its form for coroutine call sites.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger("failpoints")

ACTIONS = ("error", "delay", "corrupt")
MAX_DELAY_MS = 60_000.0

# name -> the call site passes a payload through hit()
CATALOG: dict[str, bool] = {
    # consensus/state.py finalize_commit: the block saved to the store,
    # the WAL's end-height not yet written ...
    "consensus.commit.block_saved": False,
    # ... the WAL's end-height written, the state not yet applied
    "consensus.commit.wal_delimited": False,
    # a device batch-verification launch (the general kernel, the
    # sr25519 kernel, the expanded commit path, the speculation arena)
    "device.verify": False,
    # one entry of the verify mesh, evaluated per entry in mesh order at
    # every dispatch (crypto/cuda/verify.py effective_mesh): the payload
    # is the entry's name, so `nth=K` selects the K-th entry; `error`
    # models a raising device, `corrupt` a wrong-verdict one — either
    # evicts ONLY that entry
    "device.shard_fail": True,
    # the light verify collector's coalesced launch
    # (light/serving.py): `error` degrades the batch to the host oracle,
    # exactly like a raising device launch; `delay` models a slow
    # verify so the pending-verify queue backs up and sheds
    "light.verify": False,
    # a block about to be persisted to the block store (store/__init__.py:
    # one atomic batch of meta, parts, commits and the store's state)
    "store.save_block": False,
    # an ABCI request leaving a proxy connection (proxy/__init__.py
    # instrument_client: every client type shares it)
    "abci.deliver": False,
    # the admission plane's batched tx-signature verification launch
    # (mempool/admission.py, device or host backend): `delay` models a
    # slow verify so the pre-verify queue backs up and sheds, `error` a
    # failed launch that degrades to the host oracle
    "mempool.admission.verify": False,
    # the block executor's persistence boundaries (state/execution.py
    # apply_block), in call order
    "state.apply.block_executed": False,  # executed, responses not saved
    "state.apply.responses_saved": False,  # responses saved, state not updated
    "state.apply.app_committed": False,  # app committed, state not saved
    "state.apply.state_saved": False,  # everything saved, events not fired
    # consensus WAL flush+fsync (consensus/wal.py write_sync's barrier)
    "wal.fsync": False,
    # the crc-framed record bytes about to be appended to the WAL head
    # (corrupt = a torn write mid-record)
    "wal.torn_write": True,
    # a persistent KV-store write (SqliteDB set/batch, FileDB append)
    "db.set": False,
    # a precommit lane entering a speculative verify-ahead launch
    # (consensus/speculation.py): the payload is the lane's observed
    # timestamp bytes; `corrupt` makes every speculated lane mismatch at
    # commit, `error` abandons the launch, `delay` stalls it
    "consensus.speculate": True,
    # the FilePV's LastSignState about to be persisted (privval/file_pv.py):
    # an error here must never let an unpersisted signature escape
    "privval.save": False,
    # a packet about to be written to a peer's MConnection
    # (p2p/conn/connection.py): `corrupt` is wire garbage the peer must
    # detect and drop us for, `error` kills the send routine, `delay`
    # stalls this peer's sends
    "p2p.send": True,
    # a snapshot chunk accepted from a peer (statesync/syncer.py
    # add_chunk): `corrupt` is bad chunk bytes the restore must retry
    # past, never apply
    "statesync.chunk": True,
    # a discovered snapshot about to be offered to the app over the
    # snapshot connection (statesync/syncer.py _sync): `error` here must
    # leave no partial restore state
    "statesync.offer": False,
    # a snapshot chunk about to be applied to the app (statesync/syncer.py
    # _fetch_and_apply): `corrupt` is a poisoned chunk at the apply
    # boundary, which the restore must retry with a new peer mix
    "statesync.apply": True,
    # a snapshot chunk about to be served to a requesting peer
    # (statesync/reactor.py): `corrupt` makes this node a chunk
    # poisoner, which syncing peers must quarantine by name
    "statesync.serve": True,
}

# The reference's crash sites (its catalog's legacy_index flag: the
# persistence boundaries of committing a height that the legacy
# FAIL_TEST_INDEX ordinal counts) among the points above ...
CRASH_SITES = frozenset({
    "consensus.commit.block_saved", "consensus.commit.wal_delimited",
    "state.apply.block_executed", "state.apply.responses_saved",
    "state.apply.app_committed", "state.apply.state_saved",
})
# ... and the per-height commit-pipeline points, in persistence order
# (the reference's COMMIT_PIPELINE): a crash at any of them leaves a
# cross-store skew consensus/replay.py heals.
COMMIT_PIPELINE: tuple[str, ...] = (
    "wal.fsync",
    "db.set",
    "store.save_block",
    "consensus.commit.block_saved",
    "consensus.commit.wal_delimited",
    "state.apply.block_executed",
    "state.apply.responses_saved",
    "state.apply.app_committed",
    "state.apply.state_saved",
    "privval.save",
)
assert CRASH_SITES <= set(COMMIT_PIPELINE) <= set(CATALOG)


class FailpointError(Exception):
    """Raised by an armed `error` (or payload-less `corrupt`) point."""

    def __init__(self, name: str):
        super().__init__(f"injected failpoint {name!r}")
        self.name = name


class _Armed:
    __slots__ = ("action", "delay_ms", "nth", "count", "hits")

    def __init__(self, action: str, delay_ms: float, nth: int | None,
                 count: int | None):
        self.action = action
        self.delay_ms = delay_ms
        self.nth = nth
        self.count = count  # remaining fires before auto-disarm
        self.hits = 0


_lock = threading.Lock()
_ACTIVE: dict[str, _Armed] = {}


def arm(name: str, action: str, *, delay_ms: float = 0.0,
        nth: int | None = None, count: int | None = None) -> None:
    """Arm `name` with `action`. Raises ValueError on an unknown point,
    action, delay or trigger."""
    if name not in CATALOG:
        raise ValueError(f"unknown failpoint {name!r}")
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    if not 0.0 <= delay_ms <= MAX_DELAY_MS:
        raise ValueError(f"delay_ms {delay_ms} out of [0, {MAX_DELAY_MS}]")
    for label, v in (("nth", nth), ("count", count)):
        if v is not None and v < 1:
            raise ValueError(f"{label} must be >= 1")
    with _lock:
        _ACTIVE[name] = _Armed(action, delay_ms, nth, count)
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


def _fires(name: str) -> _Armed | None:
    """Count a hit of an armed point; its entry when the hit fires."""
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
    return armed


def hit(name: str, payload: bytes | None = None):
    """The call-site hook. Returns `payload` (transformed by an armed
    `corrupt`): call sites with a payload must use the return value."""
    armed = _fires(name)
    if armed is None:
        return payload
    action = armed.action
    if action == "delay":
        time.sleep(armed.delay_ms / 1000.0)
        return payload
    if action == "corrupt" and payload is not None:
        return _corrupt_bytes(payload)
    raise FailpointError(name)


async def hit_async(name: str, payload: bytes | None = None):
    """hit() for coroutine call sites (abci.deliver, p2p.send): the `delay` action
    awaits asyncio.sleep instead of blocking the event loop, so an
    injected stall slows the targeted component the way a real slow app
    would while the rest of the loop keeps running."""
    armed = _fires(name)
    if armed is None:
        return payload
    action = armed.action
    if action == "delay":
        import asyncio

        await asyncio.sleep(armed.delay_ms / 1000.0)
        return payload
    if action == "corrupt" and payload is not None:
        return _corrupt_bytes(payload)
    raise FailpointError(name)
