"""Debug/profiling HTTP server — the pprof analogue and the Prometheus
listener (reference: tendermint_tpu/libs/debugsrv.py; Go
node/node.go:807-812 serves net/http/pprof on `rpc.pprof-laddr`, and a
Prometheus listener on `instrumentation.prometheus_listen_addr`).

  GET /debug/pprof/            index
  GET /debug/pprof/goroutine   all asyncio tasks + thread stacks
  GET /debug/pprof/heap?seconds=N
                               tracemalloc top allocations sampled over
                               an N-second window (default 0.5;
                               tracing is stopped afterwards)
  GET /debug/pprof/profile?seconds=N
                               cProfile the process for N seconds,
                               pstats text
  GET /debug/trace?seconds=N   the span ring (libs/tracing.py) as Chrome
                               trace-event JSON (Perfetto /
                               chrome://tracing); seconds windows to the
                               trailing N s (default: the whole ring);
                               height=H keeps one height's spans
  GET /debug/trace/rollup      per-span-kind p50/p95/p99 JSON
  GET /debug/trace/anchor      monotonic/wall clock pair for
                               cross-process correlation
  GET /debug/launches?workload=W&seconds=N
                               launch-ledger records + per-workload
                               rollup + watchdog classification + HBM
                               registry (crypto/cuda/ledger.py)
  GET /metrics                 Prometheus text exposition (the full
                               per-module catalog)
  GET /status                  node health: per-subsystem checks into
                               one ok/degraded/failing verdict, the
                               watchdog's device check among them
  GET /debug/failpoint         failpoint registry state
  POST /debug/failpoint        arm/disarm a named failpoint (JSON body:
                               name, action, delay_ms and the
                               triggers nth, every, prob, count)
"""

from __future__ import annotations

import asyncio
import io
import logging
import os
import sys
import time
import traceback

logger = logging.getLogger("debugsrv")

# /status thresholds. "Advancing" is judged against the slow end of
# sane block cadence, not the fast end: a 30 s gap on a 1 s-block
# chain is already ten missed heights, while 120 s without a commit
# means consensus is not making progress at any realistic cadence.
HEALTH_STALL_DEGRADED_S = 30.0
HEALTH_STALL_FAILING_S = 120.0
HEALTH_MEMPOOL_DEGRADED = 0.80   # pool fill ratio
HEALTH_MEMPOOL_FAILING = 0.95

_RANK = {"ok": 0, "degraded": 1, "failing": 2}
# this package's name, for the sys.modules probes of optional planes
_PKG = __name__.rsplit(".", 2)[0]


class HealthMonitor:
    """Aggregates subsystem liveness into one verdict for GET /status.

    Stateless reads come from the process-global metric singletons
    (height, peers, mempool size) plus crypto.batch's device-cooldown
    flag; the only state kept here is the (height, monotonic time)
    pair of the last observed height advance, which turns the height
    gauge into an is-it-moving check. An attached Node sharpens the
    checks (mempool capacity, solo-validator exemption) but is
    optional — a bare DebugServer still answers."""

    def __init__(self, node=None,
                 stall_degraded_s: float = HEALTH_STALL_DEGRADED_S,
                 stall_failing_s: float = HEALTH_STALL_FAILING_S):
        self.node = node
        self.stall_degraded_s = stall_degraded_s
        self.stall_failing_s = stall_failing_s
        self._last_height: float | None = None
        self._last_advance_t: float = time.monotonic()

    def status(self) -> dict:
        from ..crypto import batch as cbatch
        from .metrics import (consensus_metrics, mempool_metrics,
                              p2p_metrics, tpu_metrics)

        now = time.monotonic()
        checks: dict[str, dict] = {}

        # -- consensus: is the height advancing? --
        cm = consensus_metrics()
        height = cm.height.value()
        if self._last_height is None:
            # First reading baselines the height but NOT the advance
            # clock (that baselined at construction): a node stalled
            # since boot must not look "advancing" on the first poll.
            self._last_height = height
        elif height > self._last_height:
            self._last_height = height
            self._last_advance_t = now
        age = now - self._last_advance_t
        syncing = bool(cm.fast_syncing.value() or cm.state_syncing.value())
        if syncing:
            c = {"status": "ok", "detail": "syncing"}
        elif height == 0:
            c = {"status": "degraded", "detail": "no height committed yet"}
        elif age < self.stall_degraded_s:
            c = {"status": "ok"}
        elif age < self.stall_failing_s:
            c = {"status": "degraded",
                 "detail": f"height stalled {age:.0f}s"}
        else:
            c = {"status": "failing",
                 "detail": f"height stalled {age:.0f}s"}
        c["height"] = int(height)
        c["last_advance_age_s"] = round(age, 1)
        checks["consensus"] = c

        # -- p2p: are we connected to anyone? --
        node = self.node
        if node is not None and getattr(node, "switch", None) is not None:
            peers = node.switch.n_peers()
        else:
            peers = int(p2p_metrics().peers.value())
        solo = False
        if node is not None:
            try:
                solo = node._only_validator_is_us()
            except Exception:
                solo = False
        if peers > 0:
            checks["p2p"] = {"status": "ok", "peers": peers}
        elif solo:
            checks["p2p"] = {"status": "ok", "peers": 0,
                             "detail": "solo validator"}
        else:
            checks["p2p"] = {"status": "degraded", "peers": 0,
                             "detail": "no peers"}
        # persistent peers abandoned after exhausting reconnect
        # attempts: connected-or-not, the operator must see them
        if node is not None and getattr(node, "switch", None) is not None:
            exhausted = sorted(node.switch.reconnect_exhausted)
            if exhausted:
                c = checks["p2p"]
                c["status"] = "degraded"
                c["reconnect_exhausted"] = exhausted
                c["detail"] = (f"{len(exhausted)} persistent peer(s) "
                               "abandoned after reconnect attempts")

        # -- mempool: saturation --
        if node is not None and getattr(node, "mempool", None) is not None:
            size = node.mempool.size()
            cap = node.config.mempool.size
        else:
            size = int(mempool_metrics().size.value())
            cap = 0
        mp: dict = {"size": size}
        if cap > 0:
            ratio = size / cap
            mp["capacity"] = cap
            mp["fill_ratio"] = round(ratio, 3)
            if ratio >= HEALTH_MEMPOOL_FAILING:
                mp["status"] = "failing"
                mp["detail"] = "mempool saturated"
            elif ratio >= HEALTH_MEMPOOL_DEGRADED:
                mp["status"] = "degraded"
                mp["detail"] = "mempool nearly full"
            else:
                mp["status"] = "ok"
        else:
            mp["status"] = "ok"
        checks["mempool"] = mp

        # -- admission: the device pre-verify plane in front of
        # CheckTx (mempool/admission.py). Present only when a Node
        # with an enabled plane is attached; sheds are designed
        # behavior, a saturated pre-verify backlog is degraded. --
        plane = getattr(getattr(node, "mempool", None),
                        "admission", None)
        if plane is not None:
            try:
                checks["admission"] = plane.status_check()
            except Exception:  # pragma: no cover - monitoring guard
                logger.exception("admission status check failed")

        # -- light: the light-client serving plane, when one is live
        # in THIS process (light/serving.py — a LightProxy/ServingPool
        # host, not a validator). Consulted only if the module is
        # already imported: a plane can only exist then, and an
        # ordinary node's /status poll must not pay the import. --
        mod = sys.modules.get(_PKG + ".light.serving")
        if mod is not None:
            plane = mod.active_plane()
            if plane is not None:
                try:
                    checks["light"] = plane.status_check()
                except Exception:  # pragma: no cover - monitor guard
                    logger.exception("light status check failed")

        # -- speculation: the verify-ahead plane, when one is live in
        # THIS process (consensus/speculation.py). Consulted only if
        # the module is already imported (a plane can only exist
        # then); misses are designed behavior — the check never
        # degrades, it shows the hit/miss/overlap story. --
        mod = sys.modules.get(_PKG + ".consensus.speculation")
        if mod is not None:
            plane = mod.active_plane()
            if plane is not None:
                try:
                    checks["speculation"] = plane.status_check()
                except Exception:  # pragma: no cover - monitor guard
                    logger.exception("speculation status check failed")

        # -- statesync: restore progress + the poisoned-peer
        # quarantine ledger, when this process ever ran a state sync
        # (statesync/syncer.py). Consulted only if the module is
        # already imported (a syncer can only exist then); quarantined
        # peers mark the check degraded — the restore is healthy but
        # an active poisoning attempt must be visible. --
        mod = sys.modules.get(_PKG + ".statesync.syncer")
        if mod is not None:
            syncer = mod.active_syncer()
            if syncer is not None:
                try:
                    checks["statesync"] = syncer.status_check()
                except Exception:  # pragma: no cover - monitor guard
                    logger.exception("statesync status check failed")

        # -- device: is the accelerator serving, and is the verify
        # queue draining? Per-backend circuit-breaker states (ed25519
        # and sr25519 degrade independently) MERGED with the silicon
        # watchdog's launch-ledger verdict: configured-vs-effective
        # backend, last successful device launch age, exec-p50 drift
        # and HBM budget (crypto/cuda/watchdog.py). Either source
        # degrades the check; the reason string names which. --
        states = cbatch.breaker_states()
        qdepth = int(tpu_metrics().verify_queue_depth.value())
        dv: dict = {"queue_depth": qdepth, "breakers": states}
        broken = sorted(b for b, s in states.items() if s != "closed")
        reasons = []
        if broken:
            reasons.append("breaker open ({}): verifying on host"
                           .format(", ".join(broken)))
        # per-mesh-device breakers (a chip evicted from the fabric is
        # mesh_degraded, NOT a backend fallback: the survivors serve)
        dev_states = cbatch.device_breaker_states()
        if dev_states:
            dv["device_breakers"] = dev_states
            evicted = sorted(d for d, s in dev_states.items()
                             if s != "closed")
            if evicted:
                dv["evicted_devices"] = evicted
                reasons.append(
                    "mesh_degraded: device breaker open ({}); verify "
                    "continues on the surviving devices".format(
                        ", ".join(evicted)))
        try:
            from ..crypto.cuda import watchdog as _watchdog

            wd = _watchdog.verdict()
            dv["effective_backend"] = wd["effective_backend"]
            dv["configured_backend"] = wd["configured_backend"]
            dv["last_device_launch_age_s"] = \
                wd["last_device_launch_age_s"]
            dv["launches_in_window"] = wd["launches_in_window"]
            if wd["status"] != "ok":
                reasons.append(wd["reason"])
        except Exception:  # pragma: no cover - monitoring guard
            logger.exception("silicon watchdog verdict failed")
        if not reasons:
            dv["status"] = "ok"
        else:
            dv["status"] = "degraded"
            dv["detail"] = "; ".join(reasons)
        checks["device"] = dv

        # -- overload: the backpressure controller's aggregate view
        # (libs/overload.py) — "pressured" and "shedding" are degraded
        # but NOT failing: shedding under flood is the designed
        # behavior, and the level must clear on its own once load
        # drops (the liveness-under-overload e2e asserts exactly
        # that round trip) --
        from .overload import CONTROLLER

        osnap = CONTROLLER.evaluate()
        oc: dict = {"level": osnap["level"],
                    "status": "ok" if osnap["level"] == "ok"
                    else "degraded"}
        hot = {name: q for name, q in osnap["queues"].items()
               if q["fill"] >= 0.5}
        if hot:
            oc["queues"] = hot
        if osnap["level"] != "ok":
            oc["detail"] = (f"worst queue fill "
                            f"{osnap['worst_fill']:.2f}; shedding"
                            if osnap["level"] == "shedding"
                            else f"worst queue fill "
                                 f"{osnap['worst_fill']:.2f}")
        checks["overload"] = oc

        # -- recovery: the last startup's reconciliation report
        # (consensus/replay.py RecoveryReport). A repaired boot is a
        # HEALTHY boot — status stays ok — but the repairs, the skew
        # heights and any quarantined corruption evidence stay
        # visible for the life of the process, so "did that crash
        # recover cleanly?" is one GET away, not a log dig. --
        rep = getattr(node, "recovery_report", None) \
            if node is not None else None
        if rep is not None:
            rc: dict = {
                "status": "ok",
                "repairs": [r["kind"] for r in rep.get("repairs", [])],
                "blocks_replayed": rep.get("blocks_replayed", 0),
                "heights": {
                    "app": rep.get("app_height", 0),
                    "state": rep.get("state_height", 0),
                    "store": rep.get("store_height", 0),
                },
            }
            if rep.get("wal_tail_repaired_bytes"):
                rc["wal_tail_repaired_bytes"] = \
                    rep["wal_tail_repaired_bytes"]
            if rep.get("quarantined_files"):
                rc["quarantined_files"] = rep["quarantined_files"]
            checks["recovery"] = rc

        # -- chaos: armed failpoints make a node degraded BY DESIGN —
        # the flag keeps an injection run from masquerading as healthy
        # (check only present while something is armed) --
        from . import failpoints

        armed = failpoints.any_armed()
        if armed:
            checks["failpoints"] = {
                "status": "degraded",
                "detail": "failpoints armed",
                "armed": armed,
            }

        overall = max((c["status"] for c in checks.values()),
                      key=_RANK.__getitem__)
        return {"status": overall, "checks": checks}


def _goroutine_dump() -> str:
    out = io.StringIO()
    tasks = asyncio.all_tasks()
    out.write(f"asyncio tasks: {len(tasks)}\n\n")
    for t in sorted(tasks, key=lambda t: t.get_name()):
        out.write(f"--- task {t.get_name()} "
                  f"({'done' if t.done() else 'pending'})\n")
        for line in t.get_stack(limit=20):
            out.write("".join(traceback.format_stack(line, limit=20)[-1]))
        out.write("\n")
    out.write(f"\nthreads: {len(sys._current_frames())}\n\n")
    import threading

    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.write(f"--- thread {names.get(tid, tid)}\n")
        out.write("".join(traceback.format_stack(frame)))
        out.write("\n")
    return out.getvalue()


async def _heap_dump(window_s: float = 0.5) -> str:
    """Windowed tracemalloc sample. tracemalloc MUST NOT be left
    running after the request: it hooks every allocation and slows
    the whole process 3-4x — a single `debug dump` poll used to
    permanently degrade the node it was diagnosing (found when the
    test suite's post-/heap tests all ran ~4x slower). Operators who
    want cumulative tracing can start the process with
    PYTHONTRACEMALLOC=1; tracing that was already on stays on."""
    import tracemalloc

    out = io.StringIO()
    started_here = not tracemalloc.is_tracing()
    if started_here:
        tracemalloc.start()
        await asyncio.sleep(window_s)
        out.write(f"allocations sampled over a {window_s:.1f}s window "
                  "(tracemalloc stopped after the snapshot; start the "
                  "process with PYTHONTRACEMALLOC=1 for cumulative "
                  "tracing)\n")
    try:
        snap = tracemalloc.take_snapshot()
        current, peak = tracemalloc.get_traced_memory()
        out.write(f"traced current={current} peak={peak}\n\n")
        for stat in snap.statistics("lineno")[:50]:
            out.write(f"{stat}\n")
    finally:
        if started_here:
            tracemalloc.stop()
    return out.getvalue()


def _parse_seconds(raw, default: float, cap: float) -> float:
    """Query-param seconds: garbage/NaN/negative must degrade to the
    default, never into asyncio.sleep (a NaN timer hangs the request)."""
    try:
        v = float(raw) if raw is not None else default
    except ValueError:
        return default
    if not (0.0 <= v):  # catches NaN too
        return default
    return min(v, cap)


async def _profile(seconds: float) -> str:
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    await asyncio.sleep(min(seconds, 60.0))
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(60)
    return out.getvalue()


class DebugServer:
    """Tiny HTTP/1.0 server for the routes above."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, node=None):
        self.host = host
        self.port = port
        self.health = HealthMonitor(node)
        self._server = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("debug/pprof server on %s:%d", self.host, self.port)
        return self.port

    def close(self) -> None:
        if self._server is not None:
            self._server.close()

    async def _serve(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            parts = line.decode().split(" ")
            if len(parts) < 2:
                return
            method, target = parts[0].upper(), parts[1]
            clen = 0
            while True:
                hline = await reader.readline()
                if hline in (b"\r\n", b"\n", b""):
                    break
                name, _, val = hline.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    try:
                        clen = min(int(val.strip()), 1 << 20)
                    except ValueError:
                        clen = 0
            req_body = await reader.readexactly(clen) if clen else b""
            path, _, query = target.partition("?")
            params = dict(
                kv.partition("=")[::2] for kv in query.split("&") if kv
            )
            body = await self._route(path, params, method=method,
                                     body=req_body)
            ctype = b"text/plain"
            if isinstance(body, tuple):
                body, ctype = body
            writer.write(
                b"HTTP/1.0 200 OK\r\nContent-Type: " + ctype +
                b"\r\nContent-Length: " + str(len(body)).encode() +
                b"\r\n\r\n" + body
            )
            await writer.drain()
        except Exception:
            logger.exception("debug request failed")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, path: str, params: dict,
                     method: str = "GET", body: bytes = b"") -> bytes:
        if path in ("/debug/pprof", "/debug/pprof/"):
            return (b"pprof endpoints: goroutine, heap?seconds=N, "
                    b"profile?seconds=N; also /metrics, /status, "
                    b"/debug/trace?seconds=N, /debug/trace/rollup, "
                    b"/debug/launches?workload=W&seconds=N, "
                    b"/debug/failpoint (GET state / POST arm)\n")
        if path == "/debug/failpoint":
            return self._failpoint_route(method, body)
        if path == "/debug/pprof/goroutine":
            return _goroutine_dump().encode()
        if path == "/debug/pprof/heap":
            secs = _parse_seconds(params.get("seconds"), 0.5, cap=10.0)
            return (await _heap_dump(secs)).encode()
        if path == "/debug/pprof/profile":
            secs = _parse_seconds(params.get("seconds"), 5.0, cap=60.0)
            return (await _profile(secs)).encode()
        if path == "/debug/trace":
            import json

            from .tracing import TRACER, chrome_trace

            secs = _parse_seconds(params.get("seconds"), 0.0, cap=3600.0)
            # snapshot() is a cheap ring copy, but rendering 16k+
            # spans to JSON is tens of ms (more with a resized ring)
            # — do it off the event loop so a trace capture (or a
            # polling `debug dump`) never stalls consensus/gossip.
            recs = TRACER.snapshot(seconds=secs or None)
            # ?height=H server-side filter: the forensics collector
            # wants one height's spans per node, not whole rings.
            # Matches spans whose attrs carry height==H (consensus
            # timeline + origin-rehydrated recv spans).
            hraw = params.get("height")
            if hraw is not None:
                try:
                    hwant = int(hraw)
                except ValueError:
                    hwant = None
                if hwant is not None:
                    recs = [r for r in recs if r[6] and (
                        r[6].get("height") == hwant or
                        r[6].get("origin_height") == hwant)]
            # Ring-health meta rides every export: a collector must be
            # able to tell a truncated trace from a complete one.
            meta = {"capacity": TRACER.capacity, "dropped": TRACER.dropped}
            body = await asyncio.get_running_loop().run_in_executor(
                None, lambda: json.dumps(chrome_trace(recs, meta)).encode())
            return body, b"application/json"
        if path == "/debug/trace/rollup":
            import json

            from .tracing import TRACER

            secs = _parse_seconds(params.get("seconds"), 0.0, cap=3600.0)

            def render() -> bytes:
                return json.dumps({
                    "stages": TRACER.stage_rollup(seconds=secs or None),
                    "capacity": TRACER.capacity,
                    "spans_dropped": TRACER.dropped,
                }).encode()

            body = await asyncio.get_running_loop().run_in_executor(
                None, render)
            return body, b"application/json"
        if path == "/debug/trace/anchor":
            import json
            import time as _t

            from .tracing import TRACER

            # Monotonic-clock anchor for cross-process correlation:
            # span timestamps are per-process perf_counter_ns, so the
            # forensics collector maps them onto a shared axis via
            # offset = wall_ns - mono_ns sampled here (back-to-back,
            # so the pairing error is sub-µs).
            return (json.dumps({
                "mono_ns": _t.perf_counter_ns(),
                "wall_ns": _t.time_ns(),
                "pid": os.getpid(),
                "capacity": TRACER.capacity,
                "spans_dropped": TRACER.dropped,
            }).encode(), b"application/json")
        if path == "/debug/launches":
            import json

            from ..crypto.cuda import ledger as cuda_ledger
            from ..crypto.cuda import watchdog as cuda_watchdog

            wl = params.get("workload") or None
            secs = _parse_seconds(params.get("seconds"), 0.0,
                                  cap=86400.0)

            def render() -> bytes:
                recs = cuda_ledger.snapshot(workload=wl,
                                           seconds=secs or None)
                return json.dumps({
                    "records": recs,
                    "rollup": cuda_ledger.rollup(recs),
                    "watchdog": cuda_watchdog.classify(),
                    "hbm": cuda_ledger.hbm_snapshot(),
                }).encode()

            # a full 512-record ring renders to ~500 KB of JSON — off
            # the event loop, like /debug/trace
            body = await asyncio.get_running_loop().run_in_executor(
                None, render)
            return body, b"application/json"
        if path == "/metrics":
            from .metrics import DEFAULT, node_metrics

            # A scrape must show the full per-module catalog even on a
            # node nothing has recorded into yet (idempotent, cheap).
            node_metrics()
            return DEFAULT.render_text().encode()
        if path == "/status":
            import json

            return (json.dumps(self.health.status()).encode(),
                    b"application/json")
        return b"unknown path; see /debug/pprof/\n"

    @staticmethod
    def _failpoint_route(method: str, body: bytes):
        """GET: catalog + armed state + counters. POST: arm/disarm —
        {"name": "wal.fsync", "action": "error", "nth": 3} arms; action
        "off" disarms; {"name": "all", "action": "off"} clears
        everything. Bad requests come back as {"error": ...} (the
        HTTP/1.0 server always answers 200)."""
        import json

        from . import failpoints

        if method != "POST":
            return (json.dumps(failpoints.state()).encode(),
                    b"application/json")
        try:
            spec = json.loads(body or b"{}")
            name = spec.get("name", "")
            action = spec.get("action", "")
            if action == "off":
                if name == "all":
                    failpoints.disarm_all()
                elif not failpoints.disarm(name):
                    raise ValueError(f"failpoint {name!r} not armed")
            else:
                kwargs = {}
                for k in ("delay_ms", "prob"):
                    if k in spec:
                        kwargs[k] = float(spec[k])
                for k in ("nth", "every", "count"):
                    if k in spec:
                        kwargs[k] = int(spec[k])
                failpoints.arm(name, action, **kwargs)
        except (ValueError, TypeError, KeyError, AttributeError) as e:
            return (json.dumps({"error": str(e)}).encode(),
                    b"application/json")
        return (json.dumps({"ok": True,
                            "armed": failpoints.any_armed()}).encode(),
                b"application/json")
