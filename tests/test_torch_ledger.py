"""The port's launch ledger, backend vocabulary and watchdog
(tendermint_tpu_torch/crypto/cuda/{ledger,backend,watchdog}.py) held
against the JAX package's (tendermint_tpu/crypto/tpu/...).

The cases of the reference's tests/test_ledger.py that are not
specific to its chip run on both packages (parametrised), with a card's
device string in the port where the reference has a TPU's, and "gpu"
where it has "tpu". Record lists made from a numpy seed go through
both watchdogs' classify and both rollups. The port-only cases pin what
the port adds: the CPU plain route recorded as cpu-fallback, a
KernelError propagating through a `raised` record, the workload tag
crossing into an executor thread through TRACER.wrap, one record per
launch with n_devices 1 on a four-shard mesh of one device, the arena's
delta bytes and the HBM registry's bytes."""

from __future__ import annotations

import concurrent.futures
import types

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import backend as jbackend
from tendermint_tpu.crypto.tpu import ledger as jledger
from tendermint_tpu.crypto.tpu import watchdog as jwatchdog
from tendermint_tpu_torch import device as pdevice
from tendermint_tpu_torch.crypto.cuda import backend as pbackend
from tendermint_tpu_torch.crypto.cuda import ledger as pledger
from tendermint_tpu_torch.crypto.cuda import watchdog as pwatchdog

PACKAGES = {
    "port": types.SimpleNamespace(
        name="tendermint_tpu_torch", ledger=pledger, watchdog=pwatchdog,
        backend=pbackend, sil_dev="cuda:0", cpu_dev="cpu", sil="gpu",
        promise="gpu", budget={"budget_bytes": 16 * 1024**3}),
    "reference": types.SimpleNamespace(
        name="tendermint_tpu", ledger=jledger, watchdog=jwatchdog,
        backend=jbackend, sil_dev="TPU_0(process=0,(0,0,0,0))",
        cpu_dev="TFRT_CPU_0", sil="tpu", promise="tpu", budget={}),
}


@pytest.fixture(autouse=True)
def _clean():
    caps = {k: p.ledger.capacity() for k, p in PACKAGES.items()}
    for p in PACKAGES.values():
        p.ledger.reset()
        p.watchdog.configure()
    yield
    for k, p in PACKAGES.items():
        p.ledger.set_capacity(caps[k])
        p.ledger.reset()
        p.watchdog.configure()


def _rec(p, device=None, verdict="ok", workload=None, exec_ms=1.0,
         **fields):
    device = p.sil_dev if device is None else device
    if workload is None:
        p.ledger.record(device=device, verdict=verdict,
                        stages_ms={"exec": exec_ms}, **fields)
        return
    with p.ledger.workload(workload):
        p.ledger.record(device=device, verdict=verdict,
                        stages_ms={"exec": exec_ms}, **fields)


def _unlabel(p, obj):
    """The reference's backend words in the port's vocabulary."""
    if p.sil == "gpu":
        return obj
    if isinstance(obj, dict):
        return {_unlabel(p, k): _unlabel(p, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unlabel(p, v) for v in obj)
    return "gpu" if obj == "tpu" else obj


# ------------------------------------------------------------- ring


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ring_bounded_and_evictions_counted(pkg):
    p = PACKAGES[pkg]
    p.ledger.set_capacity(16)
    assert p.ledger.capacity() == 16
    for i in range(20):
        _rec(p, lanes=i)
    recs = p.ledger.snapshot()
    assert len(recs) == 16 and p.ledger.evicted() == 4
    assert recs[-1]["lanes"] == 19 and recs[0]["lanes"] == 4
    p.ledger.set_capacity(1)
    assert p.ledger.capacity() == 16


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_workload_tag_scopes_and_default(pkg):
    p = PACKAGES[pkg]
    with p.ledger.workload("probe"):
        _rec(p)
        with p.ledger.workload("bench"):
            _rec(p)
        _rec(p)
    _rec(p)
    assert [r["workload"] for r in p.ledger.snapshot()] == \
        ["probe", "bench", "probe", "consensus"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_record_timestamps_are_completion_stamped(pkg):
    p = PACKAGES[pkg]
    rec = p.ledger.begin("general")
    rec.mono = rec.wall = -1e9
    rec.device = p.sil_dev
    rec.verdict = "ok"
    rec.done()
    r = p.ledger.snapshot()[-1]
    assert r["mono"] > 0 and r["wall"] > 0
    p.watchdog.configure(backend=p.promise)
    assert p.watchdog.classify()["launches_in_window"] == 1
    p.ledger.record(device=p.sil_dev, verdict="ok", mono=-1e9)
    assert p.ledger.snapshot()[-1]["mono"] == -1e9


def _seeded_ops(seed: int, n: int = 40):
    """The same record operations for both packages, from a numpy seed:
    (workload, silicon?, verdict, lanes, bytes_h2d, exec_ms, age_s)."""
    rng = np.random.default_rng(seed)
    workloads = ("consensus", "admission", "light", "probe")
    verdicts = ("ok", "ok", "ok", "invalid", "raised")
    return [(workloads[rng.integers(4)], bool(rng.integers(2)),
             verdicts[rng.integers(5)], int(rng.integers(1, 4096)),
             int(rng.integers(0, 1 << 20)),
             float(np.round(rng.uniform(0.1, 9.0), 3)),
             float(rng.choice([0.0, 5.0, 30.0, 120.0])))
            for _ in range(n)]


def _apply(p, ops) -> None:
    for wl, sil, verdict, lanes, nbytes, ex, _age in ops:
        _rec(p, device=p.sil_dev if sil else p.cpu_dev, verdict=verdict,
             workload=wl, exec_ms=ex, lanes=lanes, capacity=4096,
             bytes_h2d=nbytes, bytes_d2h=lanes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_rollup_equal_on_the_same_records(seed):
    ops = _seeded_ops(seed)
    got = {}
    for k, p in PACKAGES.items():
        p.ledger.set_capacity(32)
        _apply(p, ops)
        roll = p.ledger.rollup()
        snap = [{f: r[f] for f in ("workload", "kernel", "backend",
                                   "lanes", "capacity", "occupancy",
                                   "bytes_h2d", "bytes_d2h", "verdict",
                                   "stages_ms")}
                for r in p.ledger.snapshot()]
        got[k] = _unlabel(p, (roll, snap, p.ledger.evicted(),
                              len(p.ledger.snapshot(workload="light"))))
    assert got["port"] == got["reference"]
    roll = got["port"][0]
    assert roll["records"] == 32 and roll["evicted"] == 8
    assert set(roll["workloads"]) <= {"consensus", "admission", "light",
                                      "probe"}


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_watchdog_classifies_the_same_record_lists(seed):
    """classify() over one explicit record list, in both packages, with
    the reference's device strings mapped to the port's: the same
    state (tpu -> gpu), counts and ages."""
    ops = _seeded_ops(seed, 12)
    import time

    now = time.monotonic()
    got = {}
    for k, p in PACKAGES.items():
        recs = [{"mono": now - age,
                 "device": p.sil_dev if sil else p.cpu_dev,
                 "verdict": verdict, "stages_ms": {"exec": ex}}
                for _wl, sil, verdict, _l, _b, ex, age in ops]
        out = p.watchdog.classify(recs)
        got[k] = _unlabel(p, {f: out[f] for f in (
            "effective_backend", "launches_in_window", "exec_p50_ms")})
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_backend_classification_helper(pkg):
    p = PACKAGES[pkg]
    assert p.backend.backend_label(p.sil_dev) == p.sil
    assert p.backend.backend_label(p.cpu_dev) == "cpu-fallback"
    assert p.backend.effective_state_of(p.cpu_dev) == "cpu_fallback"
    backend, problems = p.backend.classify_stamps(p.sil, False, p.cpu_dev)
    assert backend == "cpu_fallback" and problems
    backend, problems = p.backend.classify_stamps(p.sil, False, p.sil_dev)
    assert backend == "silicon" and not problems
    assert len(p.backend.EFFECTIVE_STATES) == 5


def test_backend_vocabulary_names_the_card():
    """ROADMAP Queue C: the port stamps a CUDA device string or a card's
    name "gpu" (the reference would stamp it cpu-fallback), and "gpu" /
    "cuda" are silicon stamps."""
    for dev in ("cuda", "cuda:0", "cuda:3", "NVIDIA H100 80GB HBM3"):
        assert pbackend.backend_label(dev) == "gpu"
        assert jbackend.backend_label(dev) == "cpu-fallback"
    for dev in ("cpu", "cpu:0", "host", ""):
        assert pbackend.backend_label(dev) == "cpu-fallback"
    assert pbackend.EFFECTIVE_STATES == (
        "gpu", "mesh_degraded", "cpu_fallback", "idle", "unknown")
    for stamp in ("gpu", "cuda"):
        assert pbackend.classify_stamps(stamp, False, "cuda:0") == \
            ("silicon", [])
        assert pbackend.classify_stamps(stamp, True, "cuda:0")[0] == \
            "cpu_fallback"


# ------------------------------------------------------------- watchdog


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watchdog_degrades_within_one_launch_and_recovers(pkg):
    """The accelerator promised, ONE launch landing on the CPU degrades
    the /status device check with cpu_fallback and flips the one-hot
    gauge; a raising launch keeps it degraded; one card launch (the
    breaker probe's shape) recovers it."""
    import importlib

    p = PACKAGES[pkg]
    cbatch = importlib.import_module(f"{p.name}.crypto.batch")
    debugsrv = importlib.import_module(f"{p.name}.libs.debugsrv")
    metrics = importlib.import_module(f"{p.name}.libs.metrics")
    cbatch.reset_breakers()
    p.watchdog.configure(p.promise, 60.0)
    mon = debugsrv.HealthMonitor()
    dv = mon.status()["checks"]["device"]
    assert dv["status"] == "ok" and dv["effective_backend"] == "unknown"
    _rec(p, device=p.cpu_dev)
    dv = mon.status()["checks"]["device"]
    assert dv["status"] == "degraded"
    assert dv["effective_backend"] == "cpu_fallback"
    assert dv["configured_backend"] == p.promise
    assert "cpu_fallback" in dv["detail"] and dv["launches_in_window"] == 1
    g = metrics.tpu_metrics().effective_backend
    assert g.value(backend="cpu_fallback") == 1 and g.value(backend=p.sil) == 0
    with pytest.raises(ValueError):
        with p.ledger.launch("general"):
            raise ValueError("the launch died")
    assert p.ledger.snapshot()[-1]["verdict"] == "raised"
    assert mon.status()["checks"]["device"]["status"] == "degraded"
    _rec(p, workload="probe")
    dv = mon.status()["checks"]["device"]
    assert dv["status"] == "ok" and dv["effective_backend"] == p.sil
    assert g.value(backend=p.sil) == 1 and g.value(backend="cpu_fallback") == 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watchdog_never_degrades_without_the_promise(pkg):
    p = PACKAGES[pkg]
    _rec(p, device=p.cpu_dev)
    for backend in ("auto", "cpu"):
        p.watchdog.configure(backend)
        assert p.watchdog.verdict(**p.budget)["status"] == "ok"
    p.watchdog.configure(p.promise)
    assert p.watchdog.verdict(**p.budget)["status"] == "degraded"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watchdog_exec_drift_degrades(pkg, monkeypatch):
    p = PACKAGES[pkg]
    monkeypatch.setenv("TM_TPU_SILICON_BASELINE_MS", "1.0")
    p.watchdog.configure(p.promise)
    _rec(p, exec_ms=1.5)
    assert p.watchdog.verdict(**p.budget)["status"] == "ok"
    p.ledger.reset()
    _rec(p, exec_ms=10.0)
    v = p.watchdog.verdict(**p.budget)
    assert v["status"] == "degraded" and "drifted" in v["reason"]


def test_the_port_has_no_baseline_without_the_variable(monkeypatch):
    """ROADMAP Queue C: the port reads no recorded TPU baseline; without
    TM_TPU_SILICON_BASELINE_MS there is no drift check."""
    monkeypatch.delenv("TM_TPU_SILICON_BASELINE_MS", raising=False)
    assert pwatchdog.silicon_baseline_ms() is None
    pwatchdog.configure("gpu")
    _rec(PACKAGES["port"], exec_ms=1e6)
    assert pwatchdog.verdict(budget_bytes=1 << 40)["status"] == "ok"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watchdog_hbm_budget(pkg):
    p = PACKAGES[pkg]
    p.ledger.register_hbm("comb_tables", p.sil_dev, 17 * 1024**3)
    v = p.watchdog.verdict(**p.budget)
    assert v["status"] == "degraded" and "HBM over budget" in v["reason"]
    p.ledger.register_hbm("comb_tables", p.sil_dev, 0)
    assert p.watchdog.verdict(**p.budget)["status"] == "ok"
    assert p.ledger.hbm_device_totals() == {}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watchdog_idle_window(pkg):
    p = PACKAGES[pkg]
    p.watchdog.configure(p.promise, 60.0)
    rec = {"mono": -1e9, "device": p.sil_dev, "verdict": "ok",
           "stages_ms": {}}
    assert p.watchdog.classify([rec])["effective_backend"] == "idle"


def test_port_hbm_budget_is_each_cards_memory():
    """Without an explicit budget the port checks each card against its
    own memory; on a machine where CUDA never started no device has a
    budget, so nothing is over."""
    pledger.register_hbm("arena", "cuda:0", 1 << 50)
    assert pwatchdog.hbm_check()["over_budget"] == {}
    assert pwatchdog.hbm_check(1 << 40)["over_budget"] == {"cuda:0": 1 << 50}


# ------------------------------------------------------ dispatch sites


@pytest.fixture
def cpu():
    pdevice.set_default_device("cpu")
    yield
    pdevice.set_mesh(None)
    pdevice.set_default_device(None)


def _triples(n: int, bad=()):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    seeds = [bytes([i % 251, i // 251]) * 16 for i in range(n)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    msgs = [b"ledger %d" % i for i in range(n)]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    for i in bad:
        sigs[i] = sigs[(i + 1) % n]
    return pubs, msgs, sigs


def test_the_cpu_plain_route_is_recorded_as_cpu_fallback(cpu):
    """One real K4 launch of the plain version: one record, kernel
    general, stamped cpu-fallback on "cpu", its lanes and verdicts."""
    from tendermint_tpu_torch.crypto.cuda import verify as tv

    pubs, msgs, sigs = _triples(5, bad=(2,))
    with pledger.workload("light"):
        out = tv.verify_batch(pubs, msgs, sigs)
    assert out.tolist() == [True, True, False, True, True]
    [r] = pledger.snapshot()
    assert (r["kernel"], r["workload"], r["backend"], r["device"]) == \
        ("general", "light", "cpu-fallback", "cpu")
    assert (r["lanes"], r["capacity"], r["ok_lanes"], r["verdict"]) == \
        (5, 128, 4, "invalid")
    assert r["n_devices"] == 1 and r["shard"] is None
    assert r["compile_cache"] is None and r["device_name"] == ""
    assert r["stages_ms"]["exec"] > 0 and r["stages_ms"]["pack"] >= 0
    assert r["bytes_d2h"] == 128 and r["bytes_h2d"] > 0


def _fake_general(calls):
    def fake(ab, sb, msg, nblocks, s_ok, btab):
        calls.append(ab.shape[0])
        return torch.ones(ab.shape[0], dtype=torch.bool)
    return fake


def test_a_kernel_error_propagates_through_a_raised_record(cpu,
                                                            monkeypatch):
    """The fault rule (ROADMAP Queue C): the ledger writes the `raised`
    record, and the KernelError still reaches the caller."""
    from tendermint_tpu_torch.crypto.cuda import kernels
    from tendermint_tpu_torch.crypto.cuda import verify as tv

    def raising(*a, **kw):
        raise kernels.KernelError("illegal address (700)")

    monkeypatch.setattr(tv, "general_verify", raising)
    with pytest.raises(kernels.KernelError):
        tv.verify_batch(*_triples(3))
    [r] = pledger.snapshot()
    assert r["verdict"] == "raised" and "KernelError" in r["error"]
    assert r["kernel"] == "general" and r["capacity"] == 128


@pytest.mark.parametrize("handoff", ["wrap", "bare"])
def test_the_workload_tag_crosses_into_an_executor_thread(cpu, monkeypatch,
                                                          handoff):
    """TRACER.wrap carries the workload tag (with the active span) into
    the worker thread; a bare submit does not, and the record falls back
    to the default tag."""
    from tendermint_tpu_torch.crypto.cuda import verify as tv
    from tendermint_tpu_torch.libs import tracing

    monkeypatch.setattr(tv, "general_verify", _fake_general([]))
    args = _triples(3)
    fn = (lambda: tv.verify_batch(*args))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with pledger.workload("admission"):
            job = tracing.TRACER.wrap(fn) if handoff == "wrap" else fn
            pool.submit(job).result()
    [r] = pledger.snapshot()
    assert r["workload"] == ("admission" if handoff == "wrap"
                             else "consensus")


def test_one_record_per_shard_and_one_device_on_a_logical_mesh(cpu,
                                                                 monkeypatch):
    """Four logical shards of one device: a 2,048-lane K4 call launches
    once per shard, so four records, each with its entry's name, the
    per-entry split, and n_devices 1 — a record never claims four
    devices."""
    from tendermint_tpu_torch.crypto.cuda import verify as tv

    calls = []
    monkeypatch.setattr(tv, "general_verify", _fake_general(calls))
    pdevice.set_mesh(["cpu"] * 4)
    pubs, msgs, sigs = (x * 667 for x in _triples(3))
    n = 2000
    out = tv.verify_batch(pubs[:n], msgs[:n], sigs[:n])
    assert out.all() and calls == [512] * 4
    recs = pledger.snapshot()
    assert [r["shard"] for r in recs] == [f"cpu/{d}" for d in range(4)]
    assert {r["n_devices"] for r in recs} == {1}
    assert all(r["shard_lanes"] == [512] * 4 for r in recs)
    assert [r["lanes"] for r in recs] == [512, 512, 512, n - 1536]
    assert all(r["capacity"] == 512 and r["kernel"] == "general"
               for r in recs)


def test_the_arena_records_delta_bytes_and_its_hbm_bytes(cpu, monkeypatch):
    """ResidentArena.launch: one "resident" record whose bytes_h2d is what
    the splices and templates shipped since the last launch; the arena's
    buffers stand in the HBM registry."""
    from tendermint_tpu_torch.crypto.cuda import resident

    def fake(*args, width):
        return torch.ones(args[0].shape[0], dtype=torch.bool)

    monkeypatch.setattr(resident, "arena_verify", fake)
    arena = resident.ResidentArena(8)
    assert pledger.hbm_snapshot() == {"cpu": {"arena": arena.arena_bytes()}}
    pubs, _msgs, sigs = _triples(3)
    arena.install_keys(pubs)
    sig_rows = np.frombuffer(b"".join(sigs), np.uint8).reshape(3, 64)
    z = np.zeros(3, np.int32)
    arena.splice([1, 2, 3], sig_rows, np.zeros((3, 24), np.uint8), z,
                 z + 8, z + 1)
    b0 = arena.reupload_bytes
    arena.launch()
    arena.launch()
    r1, r2 = pledger.snapshot()
    assert r1["kernel"] == "resident" and r1["bytes_h2d"] == \
        arena.reupload_bytes
    assert r1["bytes_h2d"] > b0 and r2["bytes_h2d"] == 0
    assert r1["lanes"] == 4 and r1["capacity"] == arena.capacity
    assert r1["verdict"] == "ok" and r1["ok_lanes"] == arena.capacity


def test_expanded_records_one_launch_and_the_table_bytes(cpu, monkeypatch):
    """ExpandedKeys.verify: one "expanded" record per K3 launch; the
    set's tables stand in the HBM registry as comb_tables."""
    from tendermint_tpu_torch.crypto.cuda import expanded as ex

    calls = []

    def fake(idx, *a, **kw):
        calls.append(idx.shape[0])
        return torch.ones(idx.shape[0], dtype=torch.bool)

    pubs, msgs, sigs = _triples(4)
    exp = ex.ExpandedKeys(pubs)
    nbytes = sum(t.nbytes for t in (exp.akeys, exp.tables, exp.key_ok))
    assert pledger.hbm_snapshot() == {"cpu": {"comb_tables": nbytes}}
    monkeypatch.setattr(ex, "xverify", fake)
    with pledger.workload("fastsync"):
        assert exp.verify([0, 1, 2, 3], msgs, sigs).all()
    [r] = pledger.snapshot()
    assert (r["kernel"], r["workload"], r["lanes"], r["capacity"]) == \
        ("expanded", "fastsync", 4, 128)
    assert calls == [128] and r["stages_ms"]["pack"] >= 0


def test_sr25519_records_one_launch(cpu, monkeypatch):
    from tendermint_tpu_torch.crypto import sr25519_ref as srr
    from tendermint_tpu_torch.crypto.cuda import sr_verify

    def fake(ab, *a):
        return torch.ones(ab.shape[0], dtype=torch.bool)

    monkeypatch.setattr(sr_verify, "sr_verify", fake)
    minis = [bytes([i]) * 32 for i in range(3)]
    pubs = [srr.public_key_from_mini(m) for m in minis]
    sigs = [srr.sign(m, b"x") for m in minis]
    assert sr_verify.verify_batch_sr(pubs, [b"x"] * 3, sigs).all()
    [r] = pledger.snapshot()
    assert (r["kernel"], r["lanes"], r["ok_lanes"], r["verdict"]) == \
        ("sr25519", 3, 3, "ok")
