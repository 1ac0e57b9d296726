"""The port's debug server (tendermint_tpu_torch/libs/debugsrv.py) held
against the JAX package's (tendermint_tpu/libs/debugsrv.py): a
DebugServer of each package over the same state — the same launch
records (from a numpy seed, the reference's TPU device string where the
port has "cuda:0"), the same spans in the tracer's ring — answers its
/debug/* routes alike; /metrics renders the same catalog; the pprof
routes answer; /debug/failpoint arms and refuses alike; /status holds
the same checks once both packages' plane registries are cleared."""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.tpu import ledger as jledger
from tendermint_tpu.crypto.tpu import watchdog as jwatchdog
from tendermint_tpu.libs import debugsrv as jdebugsrv
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import ledger as pledger
from tendermint_tpu_torch.crypto.cuda import watchdog as pwatchdog
from tendermint_tpu_torch.libs import debugsrv as pdebugsrv
from tendermint_tpu_torch.libs import failpoints as pfailpoints
from tendermint_tpu_torch.libs import metrics as pmetrics
from tendermint_tpu_torch.libs import tracing as ptracing

PACKAGES = {
    "port": dict(srv=pdebugsrv, ledger=pledger, watchdog=pwatchdog,
                 tracing=ptracing, metrics=pmetrics, sil_dev="cuda:0",
                 cpu_dev="cpu"),
    "reference": dict(srv=jdebugsrv, ledger=jledger, watchdog=jwatchdog,
                      tracing=jtracing, metrics=jmetrics,
                      sil_dev="TPU_0(process=0,(0,0,0,0))",
                      cpu_dev="TFRT_CPU_0"),
}
COMMON = ("workload", "kernel", "lanes", "capacity", "occupancy",
          "bytes_h2d", "bytes_d2h", "verdict", "ok_lanes", "stages_ms",
          "n_devices")


@pytest.fixture(autouse=True)
def _clean():
    pbatch.reset_breakers()
    jbatch.reset_breakers()
    saved = {}
    for k, p in PACKAGES.items():
        p["ledger"].reset()
        p["watchdog"].configure()
        saved[k] = list(p["tracing"].TRACER._ring)
        p["tracing"].TRACER.clear()
    yield
    for k, p in PACKAGES.items():
        p["ledger"].reset()
        p["watchdog"].configure()
        p["tracing"].TRACER.clear()
        p["tracing"].TRACER._ring.extend(saved[k])


def _seed_state(p, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(24):
        wl = ("consensus", "admission", "light")[rng.integers(3)]
        dev = p["sil_dev"] if rng.integers(4) else p["cpu_dev"]
        with p["ledger"].workload(wl):
            p["ledger"].record(
                kernel=("general", "structured", "resident")[i % 3],
                device=dev, verdict=("ok", "invalid")[rng.integers(2)],
                lanes=int(rng.integers(1, 9000)), capacity=10240,
                bytes_h2d=int(rng.integers(0, 1 << 20)), ok_lanes=7,
                stages_ms={"exec": float(np.round(rng.uniform(0.1, 2), 3)),
                           "pack": 0.5})
    tr = p["tracing"]
    kinds = sorted(jtracing.registered_kinds() - {"test.kind"})
    t0 = 10**12
    for i in range(40):
        t0 += int(rng.integers(1, 10**6))
        tr.TRACER._ring.append((kinds[rng.integers(len(kinds))], i + 1, 0,
                                1, t0, int(rng.integers(1, 10**7)),
                                {"height": int(rng.integers(1, 4))}))


async def _get(port: int, path: str, method: str = "GET",
               body: bytes = b"") -> tuple[bytes, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = f"{method} {path} HTTP/1.0\r\nContent-Length: {len(body)}\r\n\r\n"
    writer.write(head.encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    ctype = next(line.split(b":", 1)[1].strip()
                 for line in head.split(b"\r\n")
                 if line.lower().startswith(b"content-type"))
    return ctype, payload


def _serve_all(paths, method="GET", body=b""):
    async def go(p):
        srv = p["srv"].DebugServer()
        port = await srv.start()
        try:
            return [await _get(port, path, method, body) for path in paths]
        finally:
            srv.close()

    return {k: asyncio.run(go(p)) for k, p in PACKAGES.items()}


def _gpu(obj):
    if isinstance(obj, dict):
        return {_gpu(k): _gpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_gpu(v) for v in obj)
    return "gpu" if obj == "tpu" else obj


@pytest.mark.parametrize("seed", [0, 1])
def test_debug_launches_answer_alike(seed):
    for p in PACKAGES.values():
        _seed_state(p, seed)
        p["watchdog"].configure("gpu" if p["srv"] is pdebugsrv else "tpu")
    got = _serve_all(["/debug/launches", "/debug/launches?workload=light"])
    out = {}
    for k, answers in got.items():
        docs = []
        for ctype, body in answers:
            assert ctype == b"application/json"
            doc = json.loads(body)
            docs.append((
                [{f: r[f] for f in COMMON} for r in doc["records"]],
                [r["backend"] for r in doc["records"]],
                doc["rollup"], doc["watchdog"]["effective_backend"],
                doc["watchdog"]["launches_in_window"]))
        out[k] = _gpu(docs) if k == "reference" else docs
    assert out["port"] == out["reference"]
    assert len(out["port"][0][0]) == 24
    assert {r["workload"] for r in out["port"][1][0]} <= {"light"}


@pytest.mark.parametrize("seed", [2, 3])
def test_debug_trace_and_rollup_answer_alike(seed):
    for p in PACKAGES.values():
        _seed_state(p, seed)
    got = _serve_all(["/debug/trace", "/debug/trace?height=2",
                      "/debug/trace/rollup"])
    docs = {k: [json.loads(b) for _, b in answers]
            for k, answers in got.items()}
    assert docs["port"] == docs["reference"]
    trace, by_height, roll = docs["port"]
    assert len(trace["traceEvents"]) == 40
    assert trace["tm_tpu"] == {"capacity": ptracing.TRACER.capacity,
                               "dropped": 0}
    assert all(e["args"]["height"] == 2 for e in by_height["traceEvents"])
    assert sum(v["count"] for v in roll["stages"].values()) == 40


# The /status checks a bare server always answers (a plane live in the
# process, from another test, adds its own).
CORE_CHECKS = {"consensus", "p2p", "mempool", "device", "overload"}


def test_metrics_and_anchor_and_status_answer_alike():
    got = _serve_all(["/metrics", "/debug/trace/anchor", "/status"])
    types_ = {}
    for k, answers in got.items():
        (mt, metrics), (at, anchor), (st, status) = answers
        assert mt == b"text/plain" and at == st == b"application/json"
        checks = set(json.loads(status)["checks"])
        assert CORE_CHECKS <= checks
        types_[k] = (sorted(re_types(metrics.decode(),
                                     PACKAGES[k]["metrics"])),
                     sorted(json.loads(anchor)))
    assert types_["port"] == types_["reference"]
    assert len(types_["port"][0]) > 100


def re_types(text: str, metrics) -> list[str]:
    """The `# TYPE` lines of the declared catalog's metrics."""
    catalog = set(metrics.all_module_metrics())
    return [line for line in text.splitlines()
            if line.startswith("# TYPE ") and line.split()[2] in catalog]


def test_the_pprof_routes_answer():
    got = _serve_all(["/debug/pprof/", "/debug/pprof/goroutine",
                      "/debug/pprof/heap?seconds=0.05",
                      "/debug/pprof/profile?seconds=0.05",
                      "/debug/pprof/heap?seconds=nan"])
    for k, answers in got.items():
        index, goroutine, heap, profile, heap_nan = (b for _, b in answers)
        assert b"goroutine" in index and b"/debug/launches" in index
        assert b"asyncio tasks" in goroutine and b"threads:" in goroutine
        assert b"traced current=" in heap and b"traced current=" in heap_nan
        assert b"function calls" in profile or b"ncalls" in profile


def test_failpoint_route_arms_disarms_and_refuses_every_and_prob():
    """GET lists the catalog; POST arms with every trigger the reference
    takes (nth, every, prob, count, the crash action) and disarms, in
    both packages alike; a bad `every` or `prob` value is refused by
    both with the same error, as both validate_spec refuse it."""
    bodies = [json.dumps(b).encode() for b in (
        {"name": "wal.fsync", "action": "error", "nth": 2},
        {"name": "db.set", "action": "error", "every": 2},
        {"name": "p2p.send", "action": "corrupt", "prob": 0.5},
        {"name": "state.apply.app_committed", "action": "crash",
         "count": 1},
        {"name": "light.verify", "action": "delay", "delay_ms": 5,
         "every": 3})]
    off = json.dumps({"name": "all", "action": "off"}).encode()
    bad = [json.dumps(b).encode() for b in (
        {"name": "wal.fsync", "action": "error", "every": 0},
        {"name": "wal.fsync", "action": "error", "prob": 1.5},
        {"name": "wal.fsync", "action": "explode"})]
    pfailpoints.reset()  # lifetime counters of earlier tests in the worker
    jfailpoints.reset()
    try:
        armed = [_serve_all(["/debug/failpoint"], "POST", b)
                 for b in bodies]
        state = _serve_all(["/debug/failpoint"])
        _serve_all(["/debug/failpoint"], "POST", off)
        after = _serve_all(["/debug/failpoint"])
        refused = [_serve_all(["/debug/failpoint"], "POST", b)
                   for b in bad]
    finally:
        pfailpoints.reset()
        jfailpoints.reset()
    for k in PACKAGES:
        assert json.loads(armed[-1][k][0][1]) == {
            "ok": True, "armed": sorted(["wal.fsync", "db.set", "p2p.send",
                                         "state.apply.app_committed",
                                         "light.verify"])}
    docs = {k: json.loads(state[k][0][1]) for k in PACKAGES}
    assert set(docs["port"]) == set(docs["reference"])
    for name in docs["port"]:
        assert {f: docs["port"][name][f] for f in ("armed", "hits",
                                                   "fires")} == \
            {f: docs["reference"][name][f] for f in ("armed", "hits",
                                                     "fires")}
    assert docs["port"]["db.set"]["armed"] == {"action": "error",
                                               "every": 2}
    assert docs["port"]["p2p.send"]["armed"] == {"action": "corrupt",
                                                 "prob": 0.5}
    for k in PACKAGES:
        assert all(v["armed"] is None
                   for v in json.loads(after[k][0][1]).values())
    for answers in refused:
        err = {k: json.loads(answers[k][0][1]) for k in PACKAGES}
        assert err["port"] == err["reference"] and "error" in err["port"]
    for spec in ("wal.fsync=error;every=2", "db.set=crash;prob=0.25",
                 "wal.fsync=error;every=0", "db.set=error;prob=2"):
        got = []
        for p in (pfailpoints, jfailpoints):
            try:
                p.validate_spec(spec)
                got.append("ok")
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], spec


def test_status_full_check_set_equals_the_reference(monkeypatch):
    """With both packages' plane registries cleared (the light serving
    plane, the speculation plane, the state-sync syncer: other tests in
    the worker leave theirs live), nothing armed and the gauges a bare
    server reads (the consensus height and sync flags, p2p peers,
    mempool size, the verify queue's depth) at 0, /status holds the same
    checks in both, each with the same status but overload's (its
    controller's queues are whatever the worker's earlier tests
    registered)."""
    import importlib

    for pkg in ("tendermint_tpu", "tendermint_tpu_torch"):
        for mod, attr in (("light.serving", "_ACTIVE_PLANE"),
                          ("consensus.speculation", "_ACTIVE_PLANE"),
                          ("statesync.syncer", "_ACTIVE_SYNCER")):
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"),
                                attr, None)
    pfailpoints.reset()
    jfailpoints.reset()
    gauges = []
    for p in PACKAGES.values():
        m = p["metrics"]
        cm = m.consensus_metrics()
        gauges += [cm.height, cm.fast_syncing, cm.state_syncing,
                   m.p2p_metrics().peers, m.mempool_metrics().size,
                   m.tpu_metrics().verify_queue_depth]
    saved = [g.value() for g in gauges]
    try:
        for g in gauges:
            g.set(0)
        got = _serve_all(["/status"])
    finally:
        for g, v in zip(gauges, saved):
            g.set(v)
    checks = {k: json.loads(answers[0][1])["checks"]
              for k, answers in got.items()}
    assert set(checks["port"]) == set(checks["reference"]) == CORE_CHECKS
    status = {k: {c: v["status"] for c, v in checks[k].items()
                  if c != "overload"} for k in PACKAGES}
    assert status["port"] == status["reference"]
    # no node: no height committed yet, no peers
    assert status["port"]["consensus"] == status["port"]["p2p"] == \
        "degraded"


def test_status_device_check_reads_the_watchdog():
    """The port's /status device check: the accelerator promised and a
    launch on the CPU, degraded with cpu_fallback; a card launch
    recovers it."""
    pwatchdog.configure("gpu")
    mon = pdebugsrv.HealthMonitor()
    pledger.record(device="cpu", verdict="ok")
    dv = mon.status()["checks"]["device"]
    assert dv["status"] == "degraded"
    assert dv["effective_backend"] == "cpu_fallback"
    pledger.record(device="cuda:0", verdict="ok")
    dv = mon.status()["checks"]["device"]
    assert dv["status"] == "ok" and dv["effective_backend"] == "gpu"
