"""Port parity: the self-healing fabric against the JAX package — the
device breakers, per-entry eviction and re-admission, the
`device.shard_fail` failpoint, the live reshard of a cached expanded
set, the BatchVerifier's breaker ladder and the degraded sr25519 route.

The port runs on a logical CPU mesh (``set_mesh(["cpu"] * 8)``, entry
names ``cpu/0`` .. ``cpu/7``), the JAX package on the tier-1 run's 8
virtual XLA CPU devices; an entry is compared by its index in the mesh.
Where the reference would compile a kernel the tier-1 run cannot
afford (its half-open probe, its CPU-compiled sr25519 path) the
reference side takes a stand-in and the port side is held against the
oracle. Tolerance: exact everywhere — breaker states, failure counts
and cooldowns, evicted sets, mesh widths and verdicts identical."""

import hashlib
import random

import pytest
import torch

from tendermint_tpu.crypto import batch as jcbatch
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu.crypto import sr25519_ref as jsr
from tendermint_tpu.crypto.tpu import verify as jtv
from tendermint_tpu.libs import clock as jclock
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu_torch.crypto import batch as cbatch
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as psr25519
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.crypto.cuda import kernels
from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import (NoDeviceError, set_default_device,
                                         set_mesh)
from tendermint_tpu_torch.libs import clock, failpoints

D = 8
CPU8 = ["cpu"] * D


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run no faster on more threads at these batch
    sizes; one keeps parallel test workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset():
    cbatch.reset_breakers()
    jcbatch.reset_breakers()
    failpoints.disarm_all()
    jfailpoints.disarm_all()
    clock.uninstall()
    jclock.uninstall()
    ex.set_shard_crossover(None)


@pytest.fixture(autouse=True)
def _cpu_mesh():
    _reset()
    set_default_device("cpu")
    set_mesh(CPU8)
    yield
    _reset()
    set_mesh(None)
    set_default_device(None)


class FakeClock:
    """A clock both packages read (monotonic; the reference's seam also
    asks for time_ns)."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def time_ns(self) -> int:
        return int(self.t * 1e9)


def _jnames() -> list[str]:
    return [str(d) for d in jtv._mesh().devices.flat]


def _pnames() -> list[str]:
    return list(tv._mesh().names)


# -- entry names and the degraded mesh ---------------------------------------


def test_entry_names_are_unique_and_survive_degrading():
    """A repeated device gets '<device>/<index>', a single one its own
    string; the degraded mesh keeps the survivors' names, is cached by
    the evicted set (the `is` fast path holds), and fewer than two
    survivors is no mesh."""
    assert tv.entry_names(["cuda:0"] * 4) == (
        "cuda:0/0", "cuda:0/1", "cuda:0/2", "cuda:0/3")
    assert tv.entry_names([torch.device("cuda", 0), torch.device("cuda", 1)]) \
        == ("cuda:0", "cuda:1")
    assert tv.entry_names(["cuda:0", "cuda:1", "cuda:0"]) == (
        "cuda:0/0", "cuda:1", "cuda:0/2")
    base = tv._mesh()
    assert base is tv._mesh() and base is tv.effective_mesh()
    assert base.names == tuple(f"cpu/{i}" for i in range(D))
    cbatch.mark_device_failed("ed25519", device="cpu/5")
    deg = tv.effective_mesh()
    assert deg is tv.effective_mesh() and len(deg) == D - 1
    assert deg.names == tuple(f"cpu/{i}" for i in range(D) if i != 5)
    cbatch.mark_device_failed("ed25519", device=[f"cpu/{i}" for i in
                                                 range(D) if i not in (0, 5)])
    assert tv.effective_mesh() is None


# -- breakers ------------------------------------------------------------------


def _breaker_trace(mod, clk, make):
    """One event sequence through a package's breaker, with scripted
    probe results; the state, failure count and remaining cooldown after
    each event."""
    results = iter([False, True, False, False, True])
    br = make(mod)
    br._probe = lambda: next(results)
    random.seed(1234)
    trace = []

    def snap(tag):
        trace.append((tag, br.state, br.consecutive_failures,
                      round(br.cooldown_remaining(), 9), br.available()))

    snap("start")
    br.record_failure()
    snap("fail")
    snap(("acquire_cooling", br.acquire()))
    for step in range(5):
        clk.t += br.cooldown_remaining() + 0.5
        snap((f"acquire_{step}", br.acquire()))
        if br.state == "closed":
            br.record_failure()
            br.record_failure()
            snap("fail_twice")
    br.reset()
    snap("reset")
    return trace


@pytest.mark.parametrize("kind", ["backend", "device"])
def test_breaker_state_machine_matches_reference(kind):
    """closed -> open -> (cooling: refused) -> half-open probe -> open
    with a doubled, jittered cooldown or closed, through both packages'
    CircuitBreaker (and DeviceBreaker) with `random` seeded and both
    clocks installed at the same time: identical traces."""
    traces = []
    for mod, clk_mod in ((cbatch, clock), (jcbatch, jclock)):
        clk = FakeClock()
        clk_mod.install(clk)
        try:
            if kind == "backend":
                traces.append(_breaker_trace(
                    mod, clk, lambda m: m.CircuitBreaker("unit", None)))
            else:
                traces.append(_breaker_trace(
                    mod, clk, lambda m: m.DeviceBreaker("ed25519", "dev")))
        finally:
            clk_mod.uninstall()
    assert traces[0] == traces[1]
    states = [t[1] for t in traces[0]]
    assert {"open", "closed"} <= set(states)
    assert traces[0][1][2] == 1 and max(t[2] for t in traces[0]) >= 3


def test_eviction_matches_reference():
    """Per-entry eviction: evicting entries one at a time narrows the
    effective mesh in both packages; the backend breaker stays closed
    until every entry is out, then opens in both."""
    jn, pn = _jnames(), _pnames()
    for k in range(D):
        cbatch.mark_device_failed("ed25519", device=pn[k])
        jcbatch.mark_device_failed("ed25519", device=jn[k])
        pm, jm = tv.effective_mesh(probe=False), jtv.effective_mesh(
            probe=False)
        pw = 0 if pm is None else len(pm)
        jw = 0 if jm is None else int(jm.devices.size)
        assert pw == jw == (D - k - 1 if D - k - 1 >= 2 else 0)
        assert [pn.index(n) for n in cbatch.evicted_devices()] == \
            [jn.index(n) for n in jcbatch.evicted_devices()] == \
            list(range(k + 1))
        assert cbatch.breaker_states() == jcbatch.breaker_states() == {
            "ed25519": "closed" if k < D - 1 else "open",
            "sr25519": "closed"}
    assert sorted(cbatch.device_breaker_states().values()) == \
        sorted(jcbatch.device_breaker_states().values()) == ["open"] * D
    assert cbatch.METRICS["evictions"][(pn[0], "launch_error")] >= 1


def test_shard_fail_failpoint_evicts_one_entry_like_reference():
    """`device.shard_fail` corrupt;nth=3 at dispatch entry evicts the
    third entry (reason failpoint) in both packages, and the same call
    already returns the 7 survivors; the backend breaker stays
    closed."""
    before = dict(cbatch.METRICS["evictions"])
    failpoints.arm("device.shard_fail", "corrupt", nth=3)
    jfailpoints.arm("device.shard_fail", "corrupt", nth=3)
    pm, jm = tv.effective_mesh(), jtv.effective_mesh()
    assert len(pm) == int(jm.devices.size) == D - 1
    assert cbatch.evicted_devices() == ["cpu/2"]
    assert jcbatch.evicted_devices() == [_jnames()[2]]
    assert cbatch.device_breaker_states() == {"cpu/2": "open"}
    assert cbatch.breaker_states()["ed25519"] == "closed"
    assert jcbatch.breaker_states()["ed25519"] == "closed"
    delta = {k: v - before.get(k, 0)
             for k, v in cbatch.METRICS["evictions"].items()
             if v != before.get(k, 0)}
    assert delta == {("cpu/2", "failpoint"): 1}
    # an `error` point evicts the same way; the payload of every other
    # entry passes through untouched
    failpoints.arm("device.shard_fail", "error", nth=D + 5)
    tv.effective_mesh()
    tv.effective_mesh()
    assert cbatch.evicted_devices() == ["cpu/2", "cpu/4"]


# -- the live reshard ---------------------------------------------------------


def _lanes(seeds, n_lanes, tamper):
    """tests/test_multichip.py's lanes: cycling every key, corrupted
    ones named in `tamper`."""
    n_keys = len(seeds)
    idx, msgs, sigs = [], [], []
    for i in range(n_lanes):
        vi = i % n_keys
        msg = b"multichip lane %d" % i
        sig = ref.sign(seeds[vi], msg)
        kind = tamper.get(i)
        if kind == "bad-sig":
            sig = sig[:32] + bytes(32)
        elif kind == "wrong-lane":
            sig = ref.sign(seeds[(vi + 1) % n_keys], msg)
        elif kind == "malformed":
            sig = b"\x07" * 63
        idx.append(vi)
        msgs.append(msg)
        sigs.append(sig)
    return idx, msgs, sigs


def test_live_reshard_keeps_the_cached_set_and_its_verdicts():
    """The reference's 30-key straddle set (crossover 8: 8 shards of 4
    keys, the last holding 2), cached by get_expanded: evicting entry 5
    reshards THE SAME object to 7 ranges, re-admitting it (a passing
    half-open probe, after the clock passes the cooldown) back to 8;
    the verdicts are the same in full, degraded
    and restored form, and the reference oracle's (the reference's own
    sharded kernel is held against the same oracle by
    tests/test_multichip.py, and the port's full-mesh verdicts against
    that kernel by tests/test_torch_fabric.py)."""
    seeds = [hashlib.sha256(b"mc%d" % i).digest() for i in range(30)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    idx, msgs, sigs = _lanes(seeds, 48, {5: "bad-sig", 11: "wrong-lane",
                                         17: "malformed"})
    ex.set_shard_crossover(8)
    want = [jref.verify(pubs[k], m, s) for k, m, s in zip(idx, msgs, sigs)]
    assert [i for i, ok in enumerate(want) if not ok] == [5, 11, 17]
    exp = ex.get_expanded(pubs)
    assert exp.sharded and exp.n_shards == D
    full = exp.verify(idx, msgs, sigs)
    clk = FakeClock()
    clock.install(clk)
    cbatch.mark_device_failed("ed25519", device="cpu/5")
    assert ex.get_expanded(pubs) is exp  # cached by keys + base placement
    deg = exp.verify(idx, msgs, sigs)
    assert exp.n_shards == D - 1 and exp.keys_per_shard == 5
    assert "cpu/5" not in exp.mesh.names
    assert cbatch.breaker_states()["ed25519"] == "closed"
    clk.t += cbatch.device_breaker("ed25519", "cpu/5").cooldown_remaining() + 1
    probes = dict(cbatch.METRICS["probes"])
    back = exp.verify(idx, msgs, sigs)  # the dispatch runs the due probe
    assert cbatch.METRICS["probes"].get(("ed25519", "ok"), 0) == \
        probes.get(("ed25519", "ok"), 0) + 1
    assert cbatch.device_breaker_states() == {"cpu/5": "closed"}
    assert ex.get_expanded(pubs) is exp
    assert exp.n_shards == D and exp.keys_per_shard == 4
    assert full.tolist() == deg.tolist() == back.tolist() == want


# -- BatchVerifier --------------------------------------------------------------


@pytest.fixture(scope="module")
def ed_lanes():
    b = vectors.adversarial_batch(12, 48, seed=31)
    keep = [i for i, s in enumerate(b["sigs"]) if len(s) == 64][:44]
    return ([b["pubkeys"][b["idx"][i]] for i in keep],
            [b["msgs"][i] for i in keep], [b["sigs"][i] for i in keep],
            b["expect"][keep])


def _bv(mod, keymod, pubs, msgs, sigs, **kw):
    bv = mod.BatchVerifier(**kw)
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(keymod.Ed25519PubKey(p), m, s)
    return bv.verify()


def test_batch_verifier_breaker_ladder_matches_reference(ed_lanes):
    """`device.verify` error once under a 44-lane BatchVerifier: host
    verdicts equal to the device's, the backend breaker open in both
    packages and one host fallback; while it cools, the host again; once
    the clock passes the cooldown, the half-open probe (the port's real
    8-lane K4 plain version; a stand-in for the reference's, whose
    compile the tier-1 run cannot afford) closes it and the device
    serves."""
    pubs, msgs, sigs, expect = ed_lanes
    clk = FakeClock()
    clock.install(clk)
    jclock.install(clk)
    jcbatch.breaker("ed25519")._probe = lambda: True
    fb = cbatch.METRICS["host_fallbacks"]
    failpoints.arm("device.verify", "error", count=1)
    jfailpoints.arm("device.verify", "error", count=1)
    got = [_bv(m, k, pubs, msgs, sigs)
           for m, k in ((cbatch, ped25519), (jcbatch, jed25519))]
    assert got[0][1].tolist() == got[1][1].tolist() == expect.tolist()
    assert cbatch.breaker_states() == jcbatch.breaker_states() == {
        "ed25519": "open", "sr25519": "closed"}
    assert cbatch.METRICS["host_fallbacks"] == fb + 1
    calls = []
    real = tv.verify_batch
    tv.verify_batch = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        again = _bv(cbatch, ped25519, pubs, msgs, sigs)  # still cooling
        assert calls == [] and again[1].tolist() == expect.tolist()
        assert cbatch.METRICS["host_fallbacks"] == fb + 2
        clk.t += cbatch.breaker("ed25519").cooldown_remaining() + 1
        done = _bv(cbatch, ped25519, pubs, msgs, sigs)
        jdone = _bv(jcbatch, jed25519, pubs, msgs, sigs, use_device=False)
    finally:
        tv.verify_batch = real
    assert [len(c) for c in calls] == [1, 0]  # the probe, then the batch
    assert done[1].tolist() == jdone[1].tolist() == expect.tolist()
    assert cbatch.breaker_states()["ed25519"] == "closed"
    assert cbatch.METRICS["host_fallbacks"] == fb + 2


def _sr_batch(n):
    minis = [hashlib.sha256(b"deg%d" % i).digest() for i in range(n)]
    msgs = [b"degraded vote %d" % i for i in range(n)]
    sigs = vectors.sr_sign_batch(minis, msgs)
    from tendermint_tpu_torch.crypto import sr25519_ref as psr
    pubs = [psr.public_key_from_mini(m) for m in minis]
    return pubs, msgs, sigs


@pytest.mark.parametrize("n", [24, 15])
def test_sr25519_degraded_route(monkeypatch, n):
    """tests/test_sr_degraded.py's shapes: a failing sr25519 launch
    opens only the sr25519 breaker and a group of at least
    _CPU_JIT_THRESHOLD_SR lanes completes through
    verify_batch_sr(device="cpu") (the reference's cpu=True); a smaller
    group takes the per-signature oracle; use_device=False never calls
    the kernel. Verdicts equal the reference oracle's."""
    assert cbatch._CPU_JIT_THRESHOLD_SR == jcbatch._CPU_JIT_THRESHOLD_SR
    pubs, msgs, sigs = _sr_batch(n)
    sigs[7] = sigs[7][:40] + bytes([sigs[7][40] ^ 1]) + sigs[7][41:]
    want = [jsr.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    calls = []
    real = sv.verify_batch_sr

    def spy(p, m, s, ctx=b"", device=None):
        calls.append(device)
        if device is None:
            raise RuntimeError("simulated device failure")
        return real(p, m, s, ctx, device=device)

    monkeypatch.setattr(sv, "verify_batch_sr", spy)
    bv = cbatch.BatchVerifier()
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(psr25519.Sr25519PubKey(p), m, s)
    ok, lanes = bv.verify()
    assert calls == ([None, "cpu"] if n >= 16 else [None])
    assert not ok and lanes.tolist() == want
    assert not cbatch.device_available("sr25519")
    assert cbatch.device_available("ed25519")
    del calls[:]
    host = cbatch.BatchVerifier(use_device=False)
    for p, m, s in zip(pubs, msgs, sigs):
        host.add(psr25519.Sr25519PubKey(p), m, s)
    assert host.verify()[1].tolist() == want and calls == []


def _expanded_commit():
    """A 130-validator ed25519 set (it takes the expanded path) and a
    commit of zero signatures over it."""
    from tendermint_tpu_torch.types import block as pblock
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    pubs = [ref.public_key_from_seed(b"nd%d" % i) for i in range(130)]
    vs = ValidatorSet([Validator.new(ped25519.Ed25519PubKey(p), 1)
                       for p in pubs])
    bid = pblock.BlockID(b"\x01" * 32, pblock.PartSetHeader(1, b"\x02" * 32))
    commit = pblock.Commit(9, 0, bid, [
        pblock.CommitSig(pblock.BlockIDFlag.COMMIT, v.address, 10 ** 18 + i,
                         b"\x00" * 64) for i, v in enumerate(vs.validators)])
    return pubs, vs, bid, commit


def test_no_device_is_never_swallowed(monkeypatch):
    """Without a GPU and without set_default_device("cpu"), the breaker
    ladders let NoDeviceError through: verify_commit of a set that
    would take the expanded path and a device-sized BatchVerifier
    raise, and no breaker opens."""
    pubs, vs, bid, commit = _expanded_commit()
    set_mesh(None)
    set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        vs.verify_commit("c", bid, 9, commit)
    with pytest.raises(NoDeviceError):
        _bv(cbatch, ped25519, pubs[:40], [b"m"] * 40, [b"\0" * 64] * 40)
    assert cbatch.breaker_states() == {"ed25519": "closed",
                                       "sr25519": "closed"}


@pytest.mark.parametrize("ladder", ["batch_verifier", "probe", "max_keys",
                                    "expanded", "speculation"])
def test_kernel_error_is_never_swallowed(monkeypatch, ed_lanes, ladder):
    """A kernel that fails to build, to launch or to take its tensors
    raises KernelError, a fault of the port and not a device to degrade
    around: every breaker ladder (the BatchVerifier's, its half-open
    probe, _use_expanded's max_keys gate, _batch_verify_lanes' expanded
    path, the speculation plane's) lets it through to the caller, no
    breaker opens or moves, and nothing counts as a host fallback,
    recheck, probe or eviction."""
    from tendermint_tpu_torch.crypto.cuda import resident as rs

    import test_torch_speculation as tts

    def broken(*a, **k):
        raise kernels.KernelError("nvcc failed: simulated")

    pubs, msgs, sigs, _ = ed_lanes
    if ladder == "probe":
        clk = FakeClock()
        clock.install(clk)
        cbatch.mark_device_failed("ed25519")
        clk.t += cbatch.breaker("ed25519").cooldown_remaining() + 1
    states = cbatch.breaker_states()
    before = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in cbatch.METRICS.items()}
    if ladder in ("batch_verifier", "probe"):
        monkeypatch.setattr(tv, "verify_batch", broken)
        with pytest.raises(kernels.KernelError):
            _bv(cbatch, ped25519, pubs, msgs, sigs)
    elif ladder in ("max_keys", "expanded"):
        _, vs, bid, commit = _expanded_commit()
        monkeypatch.setattr(
            ex, "max_keys" if ladder == "max_keys" else "get_expanded",
            broken)
        with pytest.raises(kernels.KernelError):
            vs.verify_commit("c", bid, 9, commit)
    else:
        monkeypatch.setattr(rs.MeshResidentArena, "launch", broken)
        world = tts.World("port")
        plane = world.plane()
        plane.begin_height(tts.CHAIN, world.vs, tts.H, 0, world.bid)
        for i in range(3):
            plane.observe_precommit(world.vote(i, tts._ts(i)))
        with pytest.raises(kernels.KernelError):
            plane.flush_sync()
    assert cbatch.breaker_states() == states
    assert cbatch.device_breaker_states() == {}
    assert cbatch.METRICS == before


@pytest.mark.parametrize("code", [700, 214])
@pytest.mark.parametrize("ladder", ["batch_verifier", "expanded",
                                    "speculation"])
def test_kernel_fault_at_the_sync_is_classified_by_its_code(
        monkeypatch, ed_lanes, ladder, code):
    """A fault inside a running kernel shows at the synchronisation
    before its result is read back (kernels.sync, which every readback
    and every shard gather runs first), not at its launch. The CUDA
    code decides, wherever it is seen: an illegal address (700) raises
    KernelError through every ladder — the BatchVerifier's,
    _batch_verify_lanes' expanded route, the speculation plane's flush
    on a mesh arena — with the breakers closed and the counters
    untouched; an uncorrectable ECC error (214), the device's health,
    is an ordinary error that opens the ed25519 breaker and degrades to
    the host, one host fallback."""
    from tendermint_tpu_torch.types.validator_set import VerificationError

    import test_torch_speculation as tts

    monkeypatch.setattr(kernels, "_stream_sync", lambda device, stream: code)
    before = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in cbatch.METRICS.items()}
    fault = code in kernels.KERNEL_FAULTS
    assert fault != (code in kernels.DEVICE_HEALTH)
    pubs, msgs, sigs, expect = ed_lanes
    if ladder == "batch_verifier":
        if fault:
            with pytest.raises(kernels.KernelError, match="CUDA error 700"):
                _bv(cbatch, ped25519, pubs, msgs, sigs)
        else:
            assert _bv(cbatch, ped25519, pubs, msgs,
                       sigs)[1].tolist() == expect.tolist()
    elif ladder == "expanded":
        _, vs, bid, commit = _expanded_commit()
        assert vs._use_expanded(list(range(len(vs.validators))))
        with pytest.raises(kernels.KernelError if fault
                           else VerificationError):
            vs.verify_commit("c", bid, 9, commit)
    else:
        world = tts.World("port")
        plane = world.plane()
        plane.begin_height(tts.CHAIN, world.vs, tts.H, 0, world.bid)
        for i in range(3):
            plane.observe_precommit(world.vote(i, tts._ts(i)))
        if fault:
            with pytest.raises(kernels.KernelError):
                plane.flush_sync()
        else:
            plane.flush_sync()
            lanes = plane._heights[tts.H].lanes
            assert [lanes[i].verdict for i in range(3)] == [True] * 3
    if fault:
        assert cbatch.breaker_states() == {"ed25519": "closed",
                                           "sr25519": "closed"}
        assert cbatch.device_breaker_states() == {}
        assert cbatch.METRICS == before
    else:
        assert cbatch.breaker_states()["ed25519"] == "open"
        assert cbatch.METRICS["host_fallbacks"] == before["host_fallbacks"] + 1
