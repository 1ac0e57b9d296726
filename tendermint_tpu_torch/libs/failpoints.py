"""Named failpoints (reference: tendermint_tpu/libs/failpoints.py; Go
libs/fail, which this generalizes). Every interesting boundary has a
stable name, and a test or an operator arms an action on it:

    crash         os._exit(1), no cleanup (the legacy behavior)
    error         raise FailpointError(name) from the call site
    delay         time.sleep(delay_ms) at the call site (stall shape)
    corrupt       the call site's payload bytes come back bit-flipped
                  and truncated (torn-write shape); on a point with no
                  payload it degrades to `error`

with a trigger deciding which armed hits fire:

    nth=N         only the N-th armed hit (1-based)
    every=N       every N-th armed hit
    prob=P        each hit with probability P (the `random` module's
                  generator: `random.seed` makes a run repeatable)
    count=N       auto-disarm after N fires

Control surfaces, all reaching the one registry:

  * env:    TM_TPU_FAILPOINTS="wal.fsync=error;nth=3,db.set=delay:50"
            parsed once at the first hit; a malformed entry is logged
            and ignored, so a typo in a chaos variable never becomes
            the fault being injected.
  * config: [chaos] failpoints = "<same spec>" (strict: a bad spec
            fails Config.validate_basic, not a running node).
  * HTTP:   POST /debug/failpoint on the DebugServer (libs/debugsrv.py)
            with {"name": ..., "action": ..., "nth": ...}; GET lists
            every point with its armed spec and hit/fire counters.

Evaluations and fires count in the failpoint family
(failpoint_hits_total, failpoint_fires_total). With nothing armed a
hit costs one dict.get on an empty dict (and, on the six legacy crash
sites only, an is-None check).

FAIL_TEST_INDEX keeps the legacy semantics of Go's libs/fail for the
six crash sites of committing a height (CRASH_SITES): the n-th such
site reached in the process exits hard. It is parsed once at first
use; a malformed value is logged and ignored. libs/fail.py is its
shim.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass

logger = logging.getLogger("failpoints")

ENV_VAR = "TM_TPU_FAILPOINTS"
LEGACY_ENV_VAR = "FAIL_TEST_INDEX"

ACTIONS = ("crash", "error", "delay", "corrupt")
MAX_DELAY_MS = 60_000.0


class FailpointError(Exception):
    """Raised by an armed `error` (or payload-less `corrupt`) point."""

    def __init__(self, name: str):
        super().__init__(f"injected failpoint {name!r}")
        self.name = name


@dataclass(frozen=True)
class FailpointDef:
    name: str
    description: str
    # participates in the legacy FAIL_TEST_INDEX ordinal (the six
    # original fail() persistence-boundary crash sites, in call order)
    legacy_index: bool = False
    # the call site passes bytes through hit(); `corrupt` transforms it
    payload: bool = False


# The closed catalog.
CATALOG_DEFS: tuple[FailpointDef, ...] = (
    FailpointDef(
        "consensus.commit.block_saved",
        "block saved to the store, WAL end-height not yet written",
        legacy_index=True),
    FailpointDef(
        "consensus.commit.wal_delimited",
        "WAL end-height written, state not yet applied",
        legacy_index=True),
    FailpointDef(
        "state.apply.block_executed",
        "block executed on the app, ABCI responses not yet saved",
        legacy_index=True),
    FailpointDef(
        "state.apply.responses_saved",
        "ABCI responses saved, state not yet updated",
        legacy_index=True),
    FailpointDef(
        "state.apply.app_committed",
        "app committed, state not yet saved",
        legacy_index=True),
    FailpointDef(
        "state.apply.state_saved",
        "everything saved, events not yet fired",
        legacy_index=True),
    FailpointDef(
        "wal.fsync",
        "consensus WAL flush+fsync (write_sync durability barrier)"),
    FailpointDef(
        "wal.torn_write",
        "the crc-framed record bytes about to be appended to the WAL "
        "head (corrupt = torn write mid-record)",
        payload=True),
    FailpointDef(
        "db.set",
        "a persistent KV-store write (SqliteDB set/batch, FileDB "
        "append)"),
    FailpointDef(
        "device.verify",
        "a device batch-verification kernel launch (the general "
        "kernel, the sr25519 kernel, the expanded commit path, the "
        "speculation arena)"),
    FailpointDef(
        "device.shard_fail",
        "one entry of the verify mesh, evaluated per entry in mesh "
        "order at every sharded dispatch (crypto/cuda/verify.py "
        "effective_mesh — payload is the entry's name, so `nth=K` "
        "selects the K-th entry; `error` models a raising device, "
        "`corrupt` a wrong-verdict one — either must evict ONLY that "
        "entry while the fabric reshards over the survivors)",
        payload=True),
    FailpointDef(
        "abci.deliver",
        "an ABCI request leaving a proxy connection (every client "
        "type: local, socket)"),
    FailpointDef(
        "p2p.send",
        "a packet about to be written to a peer's MConnection "
        "(corrupt = wire garbage; the peer must detect and drop)",
        payload=True),
    FailpointDef(
        "statesync.chunk",
        "a snapshot chunk accepted from a peer (corrupt = bad chunk "
        "bytes; restore must fail the snapshot, not apply them)",
        payload=True),
    FailpointDef(
        "statesync.offer",
        "a discovered snapshot about to be offered to the app over "
        "the snapshot ABCI connection (statesync/syncer.py _sync — "
        "`crash` here must restart into clean discovery with no "
        "partial restore state served)"),
    FailpointDef(
        "statesync.apply",
        "a snapshot chunk about to be applied to the app (payload is "
        "the chunk bytes; `corrupt` models a poisoned chunk reaching "
        "the apply boundary — restore must retry with a new peer mix, "
        "never serve the garbage; `crash` mid-restore must restart "
        "into clean discovery)",
        payload=True),
    FailpointDef(
        "statesync.serve",
        "a snapshot chunk about to be served to a requesting peer "
        "(statesync/reactor.py — payload is the chunk bytes; "
        "`corrupt` turns THIS node into a chunk poisoner: syncing "
        "peers must quarantine it and restore from honest peers)",
        payload=True),
    FailpointDef(
        "mempool.admission.verify",
        "the admission plane's batched tx-signature verification "
        "launch (mempool/admission.py — device or host backend; "
        "`delay` models a slow verify so the pre-verify queue backs "
        "up and sheds, `error` a failed launch that must degrade to "
        "the host oracle)"),
    FailpointDef(
        "light.verify",
        "the light serving plane's coalesced header-commit "
        "verification launch (light/serving.py — device or host "
        "backend; `delay` models a slow verify so the pending-verify "
        "queue backs up and sheds requests with 429s, `error` a "
        "failed launch that must degrade to the host oracle, never "
        "fail the requests)"),
    FailpointDef(
        "consensus.speculate",
        "a precommit lane entering a speculative verify-ahead launch "
        "(consensus/speculation.py — payload is the lane's observed "
        "timestamp bytes; `corrupt` models a wrong-timestamp flood so "
        "every speculated lane mismatches at commit and falls back to "
        "the breaker-aware verify path, `error` abandons the launch, "
        "`delay` stalls it past the commit)",
        payload=True),
    FailpointDef(
        "store.save_block",
        "a block about to be persisted to the block store (one atomic "
        "batch: meta + parts + commits + store state)"),
    FailpointDef(
        "privval.save",
        "LastSignState about to be persisted (tmp+rename+fsync) — a "
        "crash here must never let an unpersisted signature escape"),
)

BY_NAME: dict[str, FailpointDef] = {d.name: d for d in CATALOG_DEFS}
# name -> the call site passes a payload through hit()
CATALOG: dict[str, bool] = {d.name: d.payload for d in CATALOG_DEFS}
# The legacy FAIL_TEST_INDEX crash sites: the persistence boundaries of
# committing a height, in call order.
CRASH_SITES = frozenset(d.name for d in CATALOG_DEFS if d.legacy_index)

# The per-height commit-pipeline points, in persistence order: a crash
# at any of them leaves a legal cross-store skew that the startup
# reconciler (consensus/replay.py) must heal.
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


class _Armed:
    __slots__ = ("action", "delay_ms", "nth", "every", "prob",
                 "count", "hits", "fires")

    def __init__(self, action: str, delay_ms: float = 0.0,
                 nth: int | None = None, every: int | None = None,
                 prob: float | None = None, count: int | None = None):
        self.action = action
        self.delay_ms = delay_ms
        self.nth = nth
        self.every = every
        self.prob = prob
        self.count = count  # remaining fires before auto-disarm
        self.hits = 0
        self.fires = 0

    def spec(self) -> dict:
        out: dict = {"action": self.action}
        if self.action == "delay":
            out["delay_ms"] = self.delay_ms
        for k in ("nth", "every", "prob", "count"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


_lock = threading.Lock()
_ACTIVE: dict[str, _Armed] = {}
# lifetime counters survive disarm so a sweep can assert blast radius
_TOTALS: dict[str, list] = {}  # name -> [hits, fires]

# -- legacy FAIL_TEST_INDEX (parse once; malformed -> log + ignore) --

_legacy_parsed = False
_legacy_index: int | None = None
_legacy_counter = -1


def _legacy_target() -> int | None:
    global _legacy_parsed, _legacy_index
    if not _legacy_parsed:
        _legacy_parsed = True
        env = os.environ.get(LEGACY_ENV_VAR)
        if env is not None:
            try:
                _legacy_index = int(env)
            except ValueError:
                logger.warning(
                    "ignoring malformed %s=%r (not an integer)",
                    LEGACY_ENV_VAR, env)
                _legacy_index = None
    return _legacy_index


_env_pending = True


def _install_env_spec() -> None:
    global _env_pending
    _env_pending = False
    spec = os.environ.get(ENV_VAR)
    if spec:
        install_spec(spec, source="env", strict=False)


# -- arming -----------------------------------------------------------


def _validate(name: str, action: str, delay_ms: float = 0.0,
              nth: int | None = None, every: int | None = None,
              prob: float | None = None,
              count: int | None = None) -> None:
    if name not in BY_NAME:
        raise ValueError(f"unknown failpoint {name!r}")
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r}")
    if not 0.0 <= delay_ms <= MAX_DELAY_MS:
        raise ValueError(f"delay_ms {delay_ms} out of [0, {MAX_DELAY_MS}]")
    for label, v in (("nth", nth), ("every", every), ("count", count)):
        if v is not None and v < 1:
            raise ValueError(f"{label} must be >= 1")
    if prob is not None and not 0.0 <= prob <= 1.0:
        raise ValueError("prob must be in [0, 1]")


def validate_spec(spec: str) -> None:
    """Full dry-run validation of a spec string — grammar AND the same
    per-entry checks arm() enforces, so a strict surface (config
    validate_basic) rejects everything install_spec would reject."""
    for name, kwargs in parse_spec(spec):
        _validate(name, **kwargs)


def arm(name: str, action: str, *, delay_ms: float = 0.0,
        nth: int | None = None, every: int | None = None,
        prob: float | None = None, count: int | None = None) -> None:
    """Arm `name` with `action`. Raises ValueError on an unknown point
    or malformed spec (callers wanting lenience catch it)."""
    _validate(name, action, delay_ms, nth, every, prob, count)
    with _lock:
        _ACTIVE[name] = _Armed(action, delay_ms, nth, every, prob, count)
    logger.warning("failpoint armed: %s %s", name,
                   _ACTIVE[name].spec())


def disarm(name: str) -> bool:
    with _lock:
        armed = _ACTIVE.pop(name, None)
    if armed is not None:
        logger.warning("failpoint disarmed: %s", name)
    return armed is not None


def disarm_all() -> int:
    with _lock:
        n = len(_ACTIVE)
        _ACTIVE.clear()
    if n:
        logger.warning("all failpoints disarmed (%d)", n)
    return n


def parse_spec(spec: str) -> list[tuple[str, dict]]:
    """Parse "name=action[:arg][;trig=val...]" comma-separated entries
    into [(name, arm-kwargs)]. Raises ValueError on the first bad
    entry (callers choose strictness)."""
    out: list[tuple[str, dict]] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, *trigs = entry.split(";")
        name, sep, action = head.partition("=")
        if not sep:
            raise ValueError(f"missing '=' in failpoint entry {entry!r}")
        name, action = name.strip(), action.strip()
        kwargs: dict = {}
        action, colon, arg = action.partition(":")
        if action == "delay":
            kwargs["delay_ms"] = float(arg) if colon else 100.0
        elif colon:
            raise ValueError(
                f"action {action!r} takes no argument ({entry!r})")
        for t in trigs:
            k, sep2, v = t.partition("=")
            k, v = k.strip(), v.strip()
            if not sep2 or k not in ("nth", "every", "prob", "count"):
                raise ValueError(f"bad trigger {t!r} in {entry!r}")
            kwargs[k] = float(v) if k == "prob" else int(v)
        out.append((name, {"action": action, **kwargs}))
    return out


def install_spec(spec: str, source: str = "config",
                 strict: bool = True) -> int:
    """Arm every entry of a spec string. strict=True raises on the
    first malformed entry (config path: fail fast at validate);
    strict=False logs and skips bad entries (env path: a chaos typo
    must not take the node down on its own)."""
    armed = 0
    try:
        entries = parse_spec(spec)
    except ValueError as e:
        if strict:
            raise
        logger.warning("ignoring malformed %s failpoint spec: %s",
                       source, e)
        return 0
    for name, kwargs in entries:
        try:
            arm(name, **kwargs)
            armed += 1
        except ValueError as e:
            if strict:
                raise
            logger.warning("ignoring bad %s failpoint entry %r: %s",
                           source, name, e)
    return armed


# -- the call-site hook -----------------------------------------------


def _metrics():
    from .metrics import failpoint_metrics

    return failpoint_metrics()


def _corrupt_bytes(data: bytes) -> bytes:
    """Deterministic torn-write shape: flip one bit mid-payload and
    drop the final byte (if any) — enough to break any crc/auth tag
    without being ignorable."""
    b = bytearray(data)
    if not b:
        return b"\xff"
    b[len(b) // 2] ^= 0x01
    return bytes(b[:-1]) if len(b) > 1 else bytes(b)


def _decide(name: str) -> tuple[str, float] | None:
    """Shared per-hit bookkeeping: env parse, legacy ordinal, trigger
    evaluation, counters, metrics. Returns (action, delay_ms) when the
    point fires, None otherwise."""
    if _env_pending:
        _install_env_spec()
    if name in CRASH_SITES and _legacy_target() is not None:
        global _legacy_counter
        _legacy_counter += 1
        if _legacy_counter == _legacy_target():
            os._exit(1)
    armed = _ACTIVE.get(name)
    if armed is None:
        return None

    with _lock:
        if _ACTIVE.get(name) is not armed:  # racing disarm/re-arm
            return None
        armed.hits += 1
        totals = _TOTALS.setdefault(name, [0, 0])
        totals[0] += 1
        fire = True
        if armed.nth is not None:
            fire = armed.hits == armed.nth
        elif armed.every is not None:
            fire = armed.hits % armed.every == 0
        if fire and armed.prob is not None:
            fire = random.random() < armed.prob
        if fire:
            armed.fires += 1
            totals[1] += 1
            if armed.count is not None:
                armed.count -= 1
                if armed.count <= 0:
                    _ACTIVE.pop(name, None)
        action = armed.action
        delay_ms = armed.delay_ms
    try:
        m = _metrics()
        m.hits.inc(point=name)
        if fire:
            m.fires.inc(point=name, action=action)
    except Exception:  # metrics must never be the injected fault
        logger.exception("failpoint metrics update failed")
    if not fire:
        return None
    logger.warning("failpoint firing: %s action=%s", name, action)
    return action, delay_ms


def hit(name: str, payload: bytes | None = None):
    """The call-site function for SYNCHRONOUS sites (WAL fsync, DB
    writes, kernel launches — places that block the caller anyway, so
    a `delay` there faithfully models a slow disk/device). Returns
    `payload` (transformed by an armed `corrupt`) — call sites with a
    payload MUST use the return value. No-op (beyond an empty dict
    probe) when nothing is armed."""
    decided = _decide(name)
    if decided is None:
        return payload
    action, delay_ms = decided
    if action == "crash":
        os._exit(1)
    if action == "delay":
        time.sleep(delay_ms / 1000.0)
        return payload
    if action == "corrupt" and payload is not None:
        return _corrupt_bytes(payload)
    raise FailpointError(name)


async def hit_async(name: str, payload: bytes | None = None):
    """hit() for coroutine call sites (abci.deliver, p2p.send): the
    `delay` action awaits asyncio.sleep instead of blocking the event
    loop, so an injected stall slows the TARGETED component the way a
    real slow app/peer would — consensus, RPC and crucially the
    disarm endpoint keep running."""
    decided = _decide(name)
    if decided is None:
        return payload
    action, delay_ms = decided
    if action == "crash":
        os._exit(1)
    if action == "delay":
        import asyncio

        await asyncio.sleep(delay_ms / 1000.0)
        return payload
    if action == "corrupt" and payload is not None:
        return _corrupt_bytes(payload)
    raise FailpointError(name)


# -- introspection (debug endpoint, tools) ----------------------------


def state() -> dict:
    """{name: {description, armed: spec|None, hits, fires}} over the
    whole catalog — the GET /debug/failpoint body."""
    with _lock:
        active = {k: v.spec() for k, v in _ACTIVE.items()}
        totals = {k: list(v) for k, v in _TOTALS.items()}
    out = {}
    for d in CATALOG_DEFS:
        h, f = totals.get(d.name, (0, 0))
        out[d.name] = {
            "description": d.description,
            "armed": active.get(d.name),
            "hits": h,
            "fires": f,
        }
    return out


def any_armed() -> list[str]:
    """Names of currently armed points (the /status chaos flag)."""
    with _lock:
        return sorted(_ACTIVE)


# -- legacy shim + test reset -----------------------------------------


def legacy_fail() -> None:
    """libs/fail.py fail(): participates in the same FAIL_TEST_INDEX ordinal as the
    six named legacy sites."""
    if _legacy_target() is None:
        return
    global _legacy_counter
    _legacy_counter += 1
    if _legacy_counter == _legacy_target():
        os._exit(1)


def reset() -> None:
    """Full test reset: disarm everything, clear counters, re-read the
    legacy env var on next use."""
    global _legacy_parsed, _legacy_index, _legacy_counter, _env_pending
    with _lock:
        _ACTIVE.clear()
        _TOTALS.clear()
    _legacy_parsed = False
    _legacy_index = None
    _legacy_counter = -1
    _env_pending = True
