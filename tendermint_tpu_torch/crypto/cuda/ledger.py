"""Device launch ledger: one structured record per kernel launch
(reference: tendermint_tpu/crypto/tpu/ledger.py).

Every dispatch site of the verify stack — the general kernel K4
(verify.py), K3 and K5 over the expanded tables (expanded.py), the
resident arenas K7 and K8 (resident.py) and sr25519 K9 (sr_verify.py)
— appends one record per launch into a bounded process-global ring.
It says which hardware ran each launch, what each millisecond and
byte bought, and whether the card is serving.

A record is a plain dict:

    wall / mono        completion timestamps (time.time / monotonic)
    dur_ms             begin -> finalize wall time of the launch
    workload           consensus|speculation|admission|light|fastsync|
                       probe|bench (a context variable; planes tag
                       their calls with workload())
    kernel             general|expanded|structured|*_sharded|
                       resident|resident_mesh|sr25519
    backend / device   backend.backend_label of the device string the
                       verdict tensor lives on ("cuda:0" -> "gpu",
                       "cpu" -> "cpu-fallback")
    device_name        the card's name (torch.cuda.get_device_name),
                       "" on the CPU
    n_devices          physical devices the launch spanned: four
                       logical shards of one card are one device
    shard              the mesh entry's name ("cuda:0/2") for a launch
                       on one entry of a mesh, else None
    lanes / capacity / occupancy
                       real lanes vs the padded lanes the kernel ran
    bytes_h2d          host->device payload (for an arena launch, the
                       delta shipped since the last one)
    bytes_d2h          verdict readback bytes
    compile_cache      miss when this launch built or loaded the kernel
                       library (kernels.build / kernels.load), hit when
                       it did not; None for the plain version on the CPU
    stages_ms          pack / dispatch / exec / readback. `exec` is the
                       card's own time: a pair of timing events recorded
                       around the kernel on the launch's stream and read
                       after the synchronisation that precedes the
                       readback (no new synchronisation); on the CPU the
                       plain version's wall time. The others are host
                       wall time.
    shard_lanes        per-entry lane split on a mesh
    active_devices     the mesh entries the launch's mesh had
    verdict            ok|invalid|sentinel_failed|raised
    ok_lanes / error

Consumers: watchdog.py classifies the effective backend from recent
records; GET /debug/launches exports the ring (libs/debugsrv.py);
rollup() gives the per-workload account a benchmark reads.

Imports no torch at module level: recording works wherever numpy does.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

from ...libs import tracing as _tracing
from . import backend as _backend

# Workload tags (closed set).
WORKLOADS = ("consensus", "speculation", "admission", "light",
             "fastsync", "probe", "bench")

DEFAULT_CAPACITY = 512

_LOCK = threading.Lock()
_RING: deque = deque(maxlen=DEFAULT_CAPACITY)
_EVICTED = 0

# The tag lives in libs/tracing.py so that TRACER.wrap carries it into
# executor threads with the active span.
_WORKLOAD = _tracing.WORKLOAD


# ---------------------------------------------------------------- workload


class _WorkloadCtx:
    __slots__ = ("_tag", "_token")

    def __init__(self, tag: str):
        self._tag = tag

    def __enter__(self):
        self._token = _WORKLOAD.set(self._tag)
        return self._tag

    def __exit__(self, *exc) -> bool:
        _WORKLOAD.reset(self._token)
        return False


def workload(tag: str) -> _WorkloadCtx:
    """Tag every launch recorded inside the block with `tag`. Context
    variable scoped, so concurrent planes in one process cannot mislabel
    each other's launches; an executor thread sees it only through
    TRACER.wrap or a copied context."""
    return _WorkloadCtx(tag)


def current_workload() -> str:
    return _WORKLOAD.get()


# ---------------------------------------------------------------- devices

_NAMES: dict[str, str] = {}


def device_of(t) -> tuple[str, int]:
    """(device string, 1) of the tensor a launch's verdicts live on;
    the process default (or "") for anything without a device."""
    try:
        d = getattr(t, "device", None)
        if d is not None and not callable(d):
            return str(d), 1
    except Exception:
        pass
    return default_device_str(), 1


def device_name(device: str) -> str:
    """The card's name for a CUDA device string, "" otherwise. Cached
    per device; reads torch only when CUDA is already initialised (a
    launch ran), so it never brings CUDA up itself."""
    dev = str(device)
    if not dev.startswith("cuda"):
        return ""
    name = _NAMES.get(dev)
    if name is None:
        torch = sys.modules.get("torch")
        name = ""
        try:
            if torch is not None and torch.cuda.is_initialized():
                name = torch.cuda.get_device_name(torch.device(dev))
        except Exception:
            name = ""
        if name:
            _NAMES[dev] = name
    return name


def default_device_str() -> str:
    """"cuda:<current device>" when torch has already initialised CUDA in
    this process (a launch just ran), else "". A sys.modules probe: the
    ledger never initialises CUDA itself."""
    torch = sys.modules.get("torch")
    if torch is None:
        return ""
    try:
        if torch.cuda.is_initialized():
            return f"cuda:{torch.cuda.current_device()}"
    except Exception:
        pass
    return ""


def nbytes_of(obj) -> int:
    """Total bytes over a (possibly nested) dict/tuple/list of numpy
    arrays or tensors — the H2D payload dispatch sites feed records."""
    if obj is None:
        return 0
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(nbytes_of(v) for v in obj)
    try:
        return int(obj.nbytes)
    except (AttributeError, TypeError):
        return 0


# Loads of the kernel library, counted by kernels.lib() and
# kernels.use_library(): a launch during which this moved caused the
# build or load (compile_cache "miss").
LIBRARY_LOADS = [0]


# ---------------------------------------------------------------- records


class _StageCtx:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec, name):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = (time.perf_counter() - self._t0) * 1e3
        self._rec.add_stage(self._name, dt)
        return False


class _ExecCtx:
    """Times one kernel launch (see LaunchRecord.timed)."""

    __slots__ = ("_rec", "_device", "_stream", "_t0", "_loads")

    def __init__(self, rec, device):
        self._rec = rec
        self._device = device

    def __enter__(self):
        rec = self._rec
        rec.device = str(self._device)
        self._loads = LIBRARY_LOADS[0]
        self._stream = None
        if self._device.type == "cuda":
            import torch

            idx = self._device.index
            rec.device = "cuda:%d" % (torch.cuda.current_device()
                                      if idx is None else idx)
            self._stream = torch.cuda.current_stream(self._device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            rec._events = [ev]
        self._t0 = time.perf_counter()
        return rec

    def __exit__(self, etype, exc, tb) -> bool:
        dt = (time.perf_counter() - self._t0) * 1e3
        rec = self._rec
        if self._stream is None:
            rec.add_stage("exec", dt)  # the plain version ran inline
            return False
        rec.add_stage("dispatch", dt)
        rec.compile_hit = LIBRARY_LOADS[0] == self._loads
        if etype is None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            rec._events.append(ev)
        else:
            rec._events = None
        return False


class LaunchRecord:
    """One launch. Dispatch sites fill the fields they know, time the
    kernel call with timed(), and call done() after the readback (or
    fail()); LaunchGroup does this for the launches of one call."""

    __slots__ = ("kernel", "workload", "wall", "mono", "_t0",
                 "lanes", "capacity", "bytes_h2d", "bytes_d2h",
                 "compile_hit", "device", "n_devices", "shard",
                 "shard_lanes", "active_devices", "verdict", "ok_lanes",
                 "stages_ms", "error", "_done", "_restamp", "_events")

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.workload = _WORKLOAD.get()
        self.wall = time.time()
        self.mono = time.monotonic()
        self._t0 = time.perf_counter()
        self.lanes = 0
        self.capacity = 0
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.compile_hit: bool | None = None
        self.device = ""
        self.n_devices = 1
        self.shard: str | None = None
        self.shard_lanes: list[int] | None = None
        self.active_devices: list[str] | None = None
        self.verdict = ""
        self.ok_lanes = 0
        self.stages_ms: dict[str, float] = {}
        self.error: str | None = None
        self._done = False
        self._restamp = True
        self._events = None

    def add_stage(self, name: str, ms: float) -> None:
        st = self.stages_ms
        st[name] = round(st.get(name, 0.0) + ms, 4)

    def stage(self, name: str) -> _StageCtx:
        """Time a host stage (pack/dispatch/readback/queue_wait), around
        the same blocks the crypto.* spans bracket."""
        return _StageCtx(self, name)

    def timed(self, device) -> _ExecCtx:
        """Wrap the kernel wrapper's call on `device` (a torch.device).
        CUDA: a timing event before and after it on the device's current
        stream (the launch's stream), read into stages_ms["exec"] by
        done(), which runs after the synchronisation that precedes the
        readback; the call's host time is "dispatch". CPU: the plain
        version's wall time is "exec"."""
        return _ExecCtx(self, device)

    def _read_events(self) -> None:
        evs, self._events = self._events, None
        if not evs or len(evs) != 2:
            return
        try:
            if evs[1].query():  # never waits: complete after the sync
                self.add_stage("exec", evs[0].elapsed_time(evs[1]))
        except Exception:  # pragma: no cover - recording never fatal
            pass

    def verdicts(self, arr) -> None:
        """Summarize a (lanes,) bool verdict array. Leaves an explicitly
        set verdict (sentinel_failed) alone."""
        try:
            import numpy as np

            a = np.asarray(arr, bool)
            self.ok_lanes = int(a.sum())
            if not self.verdict:
                self.verdict = "ok" if bool(a.all()) else "invalid"
        except Exception:
            pass

    def result(self, t) -> None:
        """Device and readback bookkeeping off the verdict tensor."""
        dev, _n = device_of(t)
        if dev:
            self.device = dev
        self.bytes_d2h = max(self.bytes_d2h, nbytes_of(t))

    def fail(self, exc: BaseException) -> None:
        self.verdict = "raised"
        self.error = repr(exc)
        self._events = None
        self.done()

    def done(self) -> None:
        if self._done:
            return
        self._done = True
        self._read_events()
        if self._restamp:
            # completion stamp: a first launch whose build outlives the
            # watchdog window must not be born outside it
            self.wall = time.time()
            self.mono = time.monotonic()
        try:
            _append(self._finalize())
        except Exception:  # pragma: no cover - recording never fatal
            pass

    def _finalize(self) -> dict:
        if not self.device:
            self.device = default_device_str()
        backend = (_backend.backend_label(self.device) if self.device
                   else "unknown")
        occ = (round(self.lanes / self.capacity, 4)
               if self.capacity else None)
        cc = None if self.compile_hit is None else \
            ("hit" if self.compile_hit else "miss")
        return {
            "wall": round(self.wall, 6),
            "mono": self.mono,
            "dur_ms": round((time.perf_counter() - self._t0) * 1e3, 4),
            "workload": self.workload,
            "kernel": self.kernel,
            "backend": backend,
            "device": self.device,
            "device_name": device_name(self.device),
            "n_devices": self.n_devices,
            "shard": self.shard,
            "lanes": self.lanes,
            "capacity": self.capacity,
            "occupancy": occ,
            "bytes_h2d": int(self.bytes_h2d),
            "bytes_d2h": int(self.bytes_d2h),
            "compile_cache": cc,
            "stages_ms": dict(self.stages_ms),
            "shard_lanes": (list(self.shard_lanes)
                            if self.shard_lanes is not None else None),
            "active_devices": (list(self.active_devices)
                               if self.active_devices is not None
                               else None),
            "verdict": self.verdict or "ok",
            "ok_lanes": self.ok_lanes,
            "error": self.error,
        }


class _LaunchCtx:
    """with ledger.launch("resident") as rec: — fail() on exception
    (which propagates), done() otherwise."""

    __slots__ = ("_rec",)

    def __init__(self, rec: LaunchRecord):
        self._rec = rec

    def __enter__(self) -> LaunchRecord:
        return self._rec

    def __exit__(self, etype, exc, tb) -> bool:
        if exc is not None:
            self._rec.fail(exc)
        else:
            self._rec.done()
        return False


def begin(kernel: str) -> LaunchRecord:
    """Open a record for a launch whose lifetime doesn't fit one `with`
    block."""
    return LaunchRecord(kernel)


def launch(kernel: str) -> _LaunchCtx:
    return _LaunchCtx(begin(kernel))


class LaunchGroup:
    """The records of one dispatch-site call, one per kernel launch: a
    call that splits over a mesh launches once per entry. The site opens
    the group around its pack, launches and readback; each launch adds
    its record with launch(); the host stages the launches share (pack,
    readback) are timed once with stage() and given to each record; and
    settle(verdicts) summarises each record's lanes of the call's host
    verdicts. An exception out of the block marks every open record
    `raised` and propagates."""

    __slots__ = ("kernel", "records", "_shared", "_sels")

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.records: list[LaunchRecord] = []
        self._shared: dict[str, float] = {}
        self._sels: list = []

    def stage(self, name: str) -> _StageCtx:
        return _StageCtx(self, name)

    def add_stage(self, name: str, ms: float) -> None:
        self._shared[name] = self._shared.get(name, 0.0) + ms

    def launch(self, device, *, capacity: int, sel=None,
               bytes_h2d: int = 0, shard: str | None = None,
               n_devices: int = 1, shard_lanes=None,
               active_devices=None, kernel: str | None = None) -> _ExecCtx:
        """A record for one launch on `device` over `capacity` lanes, of
        which `sel` (a slice or an index array into the call's host
        verdicts; default: the first `capacity`) are real; returns
        the record's timed() context for the kernel call."""
        rec = LaunchRecord(kernel or self.kernel)
        rec.capacity = int(capacity)
        rec.bytes_h2d = int(bytes_h2d)
        rec.shard = shard
        rec.n_devices = n_devices
        rec.shard_lanes = shard_lanes
        rec.active_devices = active_devices
        self.records.append(rec)
        self._sels.append(slice(0, capacity) if sel is None else sel)
        return rec.timed(device)

    def settle(self, verdicts=None) -> None:
        """Close every record (after the readback): shared stages,
        `verdicts[sel]` summarised into lanes/ok_lanes/verdict, the exec
        events read."""
        import numpy as np

        v = None if verdicts is None else np.asarray(verdicts, bool)
        for rec, sel in zip(self.records, self._sels):
            if rec._done:
                continue
            for name, ms in self._shared.items():
                rec.add_stage(name, ms)
            if v is not None:
                part = v[sel]
                rec.lanes = int(part.size)
                rec.bytes_d2h = rec.capacity  # one bool a lane
                rec.verdicts(part)
            rec.done()

    def fail(self, exc: BaseException) -> None:
        for rec in self.records:
            if not rec._done:
                rec.fail(exc)

    def __enter__(self) -> "LaunchGroup":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        if exc is not None:
            self.fail(exc)
        else:
            self.settle()
        return False


def group(kernel: str) -> LaunchGroup:
    return LaunchGroup(kernel)


def _append(record: dict) -> None:
    global _EVICTED
    evicted = False
    with _LOCK:
        if len(_RING) >= (_RING.maxlen or 0):
            _EVICTED += 1
            evicted = True
        _RING.append(record)
    try:
        from ...libs.metrics import tpu_metrics

        tmet = tpu_metrics()
        tmet.launch_ledger_records.inc(workload=record["workload"],
                                       backend=record["backend"])
        if evicted:
            tmet.launch_ledger_evictions.inc()
    except Exception:  # pragma: no cover - metrics never fatal
        pass


def record(**fields) -> None:
    """One-shot record for sites with nothing to time (tests, host
    degradations a caller wants visible in the ledger)."""
    rec = LaunchRecord(fields.pop("kernel", "general"))
    if "mono" in fields or "wall" in fields:
        rec._restamp = False  # caller-pinned timestamps win
    for k, v in fields.items():
        setattr(rec, k, v)
    rec.done()


# ---------------------------------------------------------------- reads


def set_capacity(n: int) -> None:
    """Resize the ring (config crypto.ledger_capacity). Keeps the newest
    records; resets the eviction count."""
    global _RING, _EVICTED
    n = max(int(n), 16)
    with _LOCK:
        if _RING.maxlen == n:
            return
        _RING = deque(_RING, maxlen=n)
        _EVICTED = 0


def capacity() -> int:
    return _RING.maxlen or 0


def evicted() -> int:
    return _EVICTED


def reset() -> None:
    """Drop every record, the eviction count and every HBM entry."""
    global _EVICTED
    with _LOCK:
        _RING.clear()
        _EVICTED = 0
    with _HBM_LOCK:
        _HBM.clear()


def snapshot(workload: str | None = None,
             seconds: float | None = None) -> list[dict]:
    """Records oldest-first; optionally one workload and/or only the
    last `seconds` (monotonic window)."""
    with _LOCK:
        recs = list(_RING)
    if seconds:
        cut = time.monotonic() - seconds
        recs = [r for r in recs if r["mono"] >= cut]
    if workload:
        recs = [r for r in recs if r["workload"] == workload]
    return recs


def _pctl(vals: list[float], p: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    return round(vals[min(len(vals) - 1, int(p * len(vals)))], 4)


def rollup(records: list[dict] | None = None,
           seconds: float | None = None) -> dict:
    """Per-workload account over the ring (or an explicit record list):
    launch count, lanes, bytes each way, backend mix, verdict mix, exec
    p50/p99."""
    if records is None:
        records = snapshot(seconds=seconds)
    workloads: dict[str, dict] = {}
    for r in records:
        w = workloads.setdefault(r["workload"], {
            "launches": 0, "lanes": 0, "bytes_h2d": 0, "bytes_d2h": 0,
            "backends": {}, "verdicts": {}, "_exec": []})
        w["launches"] += 1
        w["lanes"] += r.get("lanes", 0)
        w["bytes_h2d"] += r.get("bytes_h2d", 0)
        w["bytes_d2h"] += r.get("bytes_d2h", 0)
        w["backends"][r["backend"]] = \
            w["backends"].get(r["backend"], 0) + 1
        w["verdicts"][r["verdict"]] = \
            w["verdicts"].get(r["verdict"], 0) + 1
        ex = r.get("stages_ms", {}).get("exec")
        if ex is not None:
            w["_exec"].append(ex)
    for w in workloads.values():
        ex = w.pop("_exec")
        w["exec_ms_p50"] = _pctl(ex, 0.50)
        w["exec_ms_p99"] = _pctl(ex, 0.99)
    return {
        "records": len(records),
        "capacity": capacity(),
        "evicted": _EVICTED,
        "workloads": workloads,
    }


# ------------------------------------------------------- HBM accounting

# (device, kind) -> resident bytes. Kinds: comb_tables (an expanded
# set's tables on a device), table_shard (a key-range shard's block),
# arena (a resident arena's buffers), arena_shard (a mesh arena's
# block on a device). Owners re-register on rebuild; 0 unregisters.
_HBM_LOCK = threading.Lock()
_HBM: dict[tuple[str, str], int] = {}


def register_hbm(kind: str, device: str, nbytes: int) -> None:
    """A device-resident allocation claims `nbytes` on `device` —
    exported as tpu_hbm_resident_bytes{device,kind} and checked against
    the card's memory by the watchdog."""
    key = (str(device), str(kind))
    with _HBM_LOCK:
        if nbytes:
            _HBM[key] = int(nbytes)
        else:
            _HBM.pop(key, None)
    try:
        from ...libs.metrics import tpu_metrics

        tpu_metrics().hbm_resident_bytes.set(
            int(nbytes), device=key[0], kind=key[1])
    except Exception:  # pragma: no cover - metrics never fatal
        pass


def hbm_snapshot() -> dict[str, dict[str, int]]:
    """{device: {kind: bytes}} of every registered allocation."""
    out: dict[str, dict[str, int]] = {}
    with _HBM_LOCK:
        for (dev, kind), n in _HBM.items():
            out.setdefault(dev, {})[kind] = n
    return out


def hbm_device_totals() -> dict[str, int]:
    return {dev: sum(kinds.values())
            for dev, kinds in hbm_snapshot().items()}
