"""BatchVerifier: accumulate (pubkey, msg, sig) triples and verify them
as one wide batch with per-lane verdicts, and the device breakers
(reference: tendermint_tpu/crypto/batch.py).

Per-lane verdicts are load-bearing: evidence handling must know which
signature failed, and one bad vote must not poison the others. Lanes
are grouped by key type. An ed25519 group of ``_DEVICE_THRESHOLD`` or
more runs the general kernel (K4, crypto/cuda/verify.py); an sr25519
group of ``_DEVICE_THRESHOLD_SR`` or more runs the sr25519 group
equation (K9, crypto/cuda/sr_verify.py) after the host's Merlin
challenges; smaller groups verify on the host, key by key.

A device launch that raises, or a known-answer lane that reads false,
opens a CIRCUIT BREAKER and the caller gets host verdicts (the same
semantics, slower) instead of an exception on a consensus-critical
path. A breaker per backend (ed25519, sr25519), and under the ed25519
one a breaker per mesh entry (``DeviceBreaker``): an entry that fails
is evicted alone, the fabric reshards over the survivors
(crypto/cuda/verify.py effective_mesh), and when every entry is out the
backend breaker opens too. After a jittered exponential cooldown
(libs/clock.py time) the next caller runs a PROBE_LANES known-answer
batch first — on the entry's own device for a DeviceBreaker — and a
passing probe closes the breaker. Two errors are never caught here
(``UNCAUGHT``): ``NoDeviceError`` (no GPU and no
``set_default_device("cpu")``), a configuration error, and
``KernelError``, a fault of the port: a kernel that fails to build, to
launch or to take its tensors, or that faults while it runs. Every
CUDA error code is classified by crypto/cuda/kernels.py, whether the
launch returned it or the synchronisation before a readback did: an
illegal or misaligned address, an illegal instruction, an assert or a
trap is KernelError. What degrades is a device that raises anything
else (an injected ``device.verify`` failpoint, a device-health code
such as an uncorrectable ECC error or a lost device) or that returns a
wrong known-answer verdict.

Counters: ``METRICS`` — host_fallbacks, evictions by (entry, reason),
probes by (backend, result), host_rechecks (a plain dict; the
reference's metrics library is not ported).
"""

from __future__ import annotations

import functools
import hashlib
import logging
import threading

import numpy as np

from . import PubKey
from ..device import NoDeviceError
from ..libs import clock
from .cuda.kernels import KernelError

logger = logging.getLogger("crypto.batch")

# Below this many sigs, host verification beats a launch (the
# reference's crossover, kept so both route at the same points).
_DEVICE_THRESHOLD = 40
# sr25519 has no OpenSSL fast path: the host oracle costs milliseconds
# a signature, so its device crossover is a handful of lanes (the
# reference's value).
_DEVICE_THRESHOLD_SR = 4
# Degraded mode (device unavailable): sr25519 groups at least this big
# run the group equation's plain version on the CPU
# (verify_batch_sr(device="cpu"), the reference's cpu=True) instead of
# the per-signature oracle.
_CPU_JIT_THRESHOLD_SR = 16

# Errors that every breaker ladder re-raises (module docstring).
UNCAUGHT = (NoDeviceError, KernelError)

BREAKER_BASE_COOLDOWN_S = 2.0
BREAKER_MAX_COOLDOWN_S = 300.0
PROBE_LANES = 8  # synthetic lanes per half-open probe

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

METRICS: dict = {"host_fallbacks": 0, "evictions": {}, "probes": {},
                 "host_rechecks": 0}


def count(key: str, sub=None) -> None:
    """Add one to METRICS[key] (to METRICS[key][sub] for a keyed one)."""
    if sub is None:
        METRICS[key] += 1
    else:
        METRICS[key][sub] = METRICS[key].get(sub, 0) + 1


class CircuitBreaker:
    """closed -> (launch raised) -> open -> (cooldown expired, next
    acquire) -> half-open probe -> closed on success, open again (with
    a doubled cooldown) on failure. Thread-safe: only one caller probes
    at a time and concurrent acquirers during a probe take the host
    path instead of blocking."""

    def __init__(self, backend: str, probe):
        self.backend = backend
        self._label = backend
        self._probe = probe  # () -> bool: known-answer round trip
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self._open_until = 0.0
        self._probing = False

    def available(self) -> bool:
        """Pure read: True iff closed. Never probes."""
        return self.state == CLOSED

    def cooldown_remaining(self) -> float:
        if self.state == CLOSED:
            return 0.0
        return max(0.0, self._open_until - clock.monotonic())

    def _open_locked(self) -> None:
        from ..libs.net import jittered_backoff

        cd = jittered_backoff(max(self.consecutive_failures - 1, 0),
                              BREAKER_BASE_COOLDOWN_S,
                              BREAKER_MAX_COOLDOWN_S)
        self._open_until = clock.monotonic() + cd
        self.state = OPEN
        logger.warning("device breaker OPEN (%s): failure #%d, cooldown "
                       "%.1fs", self._label, self.consecutive_failures, cd)

    def record_failure(self) -> None:
        """A production (or probe) launch failed on this backend."""
        with self._lock:
            self.consecutive_failures += 1
            self._open_locked()

    def acquire(self) -> bool:
        """Called before a device launch. Closed: go ahead. Open and
        cooling down, or another caller probing: host path. Open and
        expired: half-open — run the probe inline; success closes the
        breaker and admits the caller."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self._probing or clock.monotonic() < self._open_until:
                return False
            self._probing = True
            self.state = HALF_OPEN
        try:
            ok = bool(self._probe())
        except UNCAUGHT:
            with self._lock:
                self._probing = False
                self.state = OPEN
            raise
        except Exception:
            logger.exception("half-open probe raised (%s)", self._label)
            ok = False
        count("probes", (self.backend, "ok" if ok else "failed"))
        with self._lock:
            self._probing = False
            if ok:
                self.consecutive_failures = 0
                self.state = CLOSED
                logger.warning("device breaker CLOSED (%s): probe "
                               "succeeded", self._label)
            else:
                self.consecutive_failures += 1
                self._open_locked()
        return ok

    def reset(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._open_until = 0.0
            self._probing = False
            self.state = CLOSED


@functools.cache
def _ed_probe_triple() -> tuple[bytes, bytes, bytes]:
    """A fixed known-answer (pub, msg, sig): the breaker probe's triple,
    also carried by the speculation arena's sentinel lanes."""
    from . import ed25519_ref as edr

    seed = hashlib.sha256(b"tendermint_tpu ed25519 breaker probe").digest()
    msg = b"breaker probe"
    return edr.public_key_from_seed(seed), msg, edr.sign(seed, msg)


def _probe_ed25519(device=None) -> bool:
    """PROBE_LANES copies of the known-answer triple through K4 (on
    `device`, else the default dispatch); a wrong verdict is a failed
    probe."""
    from ..libs import failpoints
    from .cuda import verify as tv

    failpoints.hit("device.verify")
    p, m, s = _ed_probe_triple()
    out = tv.verify_batch([p] * PROBE_LANES, [m] * PROBE_LANES,
                          [s] * PROBE_LANES, device=device)
    return bool(np.asarray(out).all())


@functools.cache
def _sr_probe_triple() -> tuple[bytes, bytes, bytes]:
    from . import sr25519_ref as srr

    mini = hashlib.sha256(b"tendermint_tpu sr25519 breaker probe").digest()
    msg = b"breaker probe"
    return srr.public_key_from_mini(mini), msg, srr.sign(mini, msg)


def _probe_sr25519(device=None) -> bool:
    from ..libs import failpoints
    from .cuda import sr_verify

    failpoints.hit("device.verify")
    p, m, s = _sr_probe_triple()
    out = sr_verify.verify_batch_sr([p] * PROBE_LANES, [m] * PROBE_LANES,
                                    [s] * PROBE_LANES, device=device)
    return bool(np.asarray(out).all())


_BREAKERS: dict[str, CircuitBreaker] = {
    "ed25519": CircuitBreaker("ed25519", _probe_ed25519),
    "sr25519": CircuitBreaker("sr25519", _probe_sr25519),
}

_BACKEND_PROBES = {"ed25519": _probe_ed25519, "sr25519": _probe_sr25519}


class DeviceBreaker(CircuitBreaker):
    """A breaker per mesh entry, under the backend one: an entry that
    raises or returns wrong verdicts is evicted alone while the backend
    breaker stays closed. Its half-open probe is the same known-answer
    batch on THIS entry's torch device (8 lanes, below the shard
    minimum, so it never shards); a passing probe re-admits the entry
    and the next dispatch reshards back. A recursive
    evicted_devices(probe=True) during the probe sees ``_probing`` and
    keeps the entry listed as evicted."""

    def __init__(self, backend: str, device: str):
        super().__init__(backend, None)
        self.device = device  # the entry's name (verify.Mesh.names)
        self._label = f"{backend} {device}"
        self._probe = self._device_probe

    def _device_probe(self) -> bool:
        from .cuda import verify as tv

        mesh = tv._mesh()
        if mesh is None or self.device not in mesh.names:
            return False
        dev = mesh[mesh.names.index(self.device)]
        return bool(_BACKEND_PROBES[self.backend](device=dev))


# (backend, entry name) -> DeviceBreaker; created on first eviction, so
# a mesh-less process never mints entry state.
_DEVICE_BREAKERS: dict[tuple[str, str], DeviceBreaker] = {}
_DEVICE_LOCK = threading.Lock()


def device_breaker(backend: str, device: str) -> DeviceBreaker:
    with _DEVICE_LOCK:
        br = _DEVICE_BREAKERS.get((backend, device))
        if br is None:
            br = _DEVICE_BREAKERS[(backend, device)] = DeviceBreaker(
                backend, device)
        return br


def device_breaker_states(backend: str | None = None) -> dict[str, str]:
    """{entry name: state} (all backends merged unless one is named)."""
    with _DEVICE_LOCK:
        return {dev: br.state
                for (be, dev), br in sorted(_DEVICE_BREAKERS.items())
                if backend is None or be == backend}


def evicted_devices(backend: str = "ed25519",
                    probe: bool = False) -> list[str]:
    """Sorted names of the entries whose breaker is not closed.
    probe=False is a pure read; probe=True also runs the due half-open
    probes inline, so a dispatch both learns the surviving set and
    drives re-admission."""
    with _DEVICE_LOCK:
        brs = [br for (be, _), br in _DEVICE_BREAKERS.items()
               if be == backend]
    out = []
    for br in brs:
        if probe and not br.available():
            br.acquire()  # no-op while cooling down / already probing
        if not br.available():
            out.append(br.device)
    return sorted(out)


def readmit_device(backend: str, device: str) -> None:
    """Force an entry's breaker closed without a probe (the operator
    override; the natural path is a passing half-open probe)."""
    with _DEVICE_LOCK:
        br = _DEVICE_BREAKERS.get((backend, device))
    if br is not None:
        br.reset()
        logger.warning("mesh entry %s force re-admitted (%s backend)",
                       device, backend)


def _mesh_device_strs() -> list[str]:
    """The entry names of the base mesh; [] when there is no
    multi-device mesh (or no device at all: a pure read never
    raises)."""
    from .cuda import verify as tv

    try:
        mesh = tv._mesh()
    except NoDeviceError:
        return []
    return [] if mesh is None else list(mesh.names)


def breaker(backend: str = "ed25519") -> CircuitBreaker:
    return _BREAKERS[backend]


def breaker_states() -> dict[str, str]:
    """{backend: state}."""
    return {name: b.state for name, b in _BREAKERS.items()}


def reset_breakers() -> None:
    """Force every backend and entry breaker closed (tests, and the end
    of chip_smoke.py's healing phase)."""
    for b in _BREAKERS.values():
        b.reset()
    with _DEVICE_LOCK:
        device_brs = list(_DEVICE_BREAKERS.values())
        _DEVICE_BREAKERS.clear()
    for b in device_brs:
        b.reset()


def device_available(backend: str | None = None) -> bool:
    """Pure read (never probes): is the backend's breaker closed? With
    no backend, True only when every breaker is closed."""
    if backend is not None:
        return _BREAKERS[backend].available()
    return all(b.available() for b in _BREAKERS.values())


def mark_device_failed(backend: str = "ed25519", device=None,
                       reason: str = "launch_error") -> None:
    """Record a device-side verify failure. With no `device` it is
    backend-wide: the backend breaker opens. With `device` (an entry
    name, or a sequence of them, e.g. from
    MeshResidentArena.failed_shards()) only the named entries' breakers
    open and the fabric reshards over the survivors; when every entry
    of the mesh is out, the backend breaker opens too."""
    if not device:
        _BREAKERS[backend].record_failure()
        return
    names = [device] if isinstance(device, str) else list(device)
    for name in names:
        device_breaker(backend, name).record_failure()
        count("evictions", (name, reason))
        logger.error("mesh entry %s evicted (%s backend, reason=%s); "
                     "resharding over the survivors", name, backend,
                     reason)
    mesh_devs = _mesh_device_strs()
    if mesh_devs and set(evicted_devices(backend)) >= set(mesh_devs):
        logger.error("all %d mesh entries evicted (%s backend); opening "
                     "the backend breaker", len(mesh_devs), backend)
        _BREAKERS[backend].record_failure()


def host_verify(items) -> np.ndarray:
    """Per-lane verdicts of (pub_key, msg, sig) triples on the host: the
    per-key verify (ed25519: OpenSSL strict accept, else the ZIP-215
    oracle, crypto/ed25519.py; sr25519: the oracle, crypto/sr25519.py)."""
    return np.fromiter(
        (len(s) == 64 and pk.verify_signature(m, s) for pk, m, s in items),
        bool, count=len(items))


class BatchVerifier:
    """Accumulate signatures, verify them all at once.

    Usage:
        bv = BatchVerifier()
        bv.add(pk, msg, sig)
        all_ok, lane_ok = bv.verify()

    ``use_device``: None routes by group size;
    True asks for the device whatever the size; False keeps the host.
    """

    def __init__(self, use_device: bool | None = None):
        self._items: list[tuple[PubKey, bytes, bytes]] = []
        self._use_device = use_device

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, np.ndarray]:
        """Returns (all_valid, per-lane verdicts in add order)."""
        n = len(self._items)
        if n == 0:
            return True, np.zeros(0, bool)
        verdicts = np.zeros(n, bool)
        by_type: dict[str, list[int]] = {}
        for i, (pk, _, _) in enumerate(self._items):
            by_type.setdefault(pk.type_name, []).append(i)
        for type_name, idxs in by_type.items():
            items = [self._items[i] for i in idxs]
            verdicts[np.asarray(idxs)] = self._verify_group(type_name, items)
        return bool(verdicts.all()), verdicts

    def _device_group(self, backend: str, device_verify, items):
        """The breaker ladder of one key type: the device when its
        breaker admits the call, else (or when the launch raises, which
        opens the breaker) None, counted as a host fallback."""
        if breaker(backend).acquire():
            try:
                from ..libs import failpoints

                failpoints.hit("device.verify")
                return device_verify([pk.bytes() for pk, _, _ in items],
                                     [m for _, m, _ in items],
                                     [s for _, _, s in items])
            except UNCAUGHT:
                raise
            except Exception:
                mark_device_failed(backend)
                logger.exception(
                    "device %s batch failed (%d lanes); breaker open "
                    "%.1fs, degrading to host", backend, len(items),
                    breaker(backend).cooldown_remaining())
        count("host_fallbacks")
        return None

    def _verify_group(self, type_name, items) -> np.ndarray:
        use_dev = self._use_device
        if type_name == "ed25519":
            if use_dev is None:
                use_dev = len(items) >= _DEVICE_THRESHOLD
            if use_dev:
                from .cuda.verify import verify_batch

                out = self._device_group("ed25519", verify_batch, items)
                if out is not None:
                    return out
            return host_verify(items)
        if type_name == "sr25519":
            if use_dev is None:
                use_dev = len(items) >= _DEVICE_THRESHOLD_SR
            if use_dev:
                from .cuda.sr_verify import verify_batch_sr

                out = self._device_group("sr25519", verify_batch_sr, items)
                if out is not None:
                    return out
                # Degraded mode: the group equation's plain version on
                # the CPU (only when the caller wanted the device; an
                # explicit use_device=False keeps the oracle).
                if len(items) >= _CPU_JIT_THRESHOLD_SR:
                    try:
                        return verify_batch_sr(
                            [pk.bytes() for pk, _, _ in items],
                            [m for _, m, _ in items],
                            [s for _, _, s in items], device="cpu")
                    except Exception:
                        logger.exception(
                            "CPU sr25519 batch failed (%d lanes); "
                            "falling back to the per-signature oracle",
                            len(items))
        return host_verify(items)
