"""Port parity for the per-shard speculation arena (K8,
crypto/cuda/resident.py MeshResidentArena) against the JAX package's
MeshResidentArena on its 8 virtual XLA CPU devices; the port on a
logical CPU mesh (``set_mesh(["cpu"] * 8)``), where the eight shards
live in one block and K8's wrappers run K6's and K7's plain versions.

Held: the round-robin routing and the resident buffers through their
(D, per, ...) view, byte for byte, after splices with duplicate slots
and a deactivate_all; the per-shard upload bound; global-order
verdicts and per-shard sentinels (against the oracle, the plain
version over the (D, per) view, and the reference's gather of the same
per-shard verdicts); a lying shard's attribution; ensure_mesh's
replayed key layout after an eviction and a re-admission; the carried-
over state of from_reference_arrays; and the speculation plane naming
one lying entry while the commit still serves. The reference's arena
kernel is not compiled here (its own tests fake it, as does the one
gather check below). Tolerance: exact everywhere."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch as jcbatch
from tendermint_tpu.crypto.tpu import resident as jrs
from tendermint_tpu.crypto.tpu import verify as jtv
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu_torch.crypto import batch as cbatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import kernels
from tendermint_tpu_torch.crypto.cuda import resident as rs
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import set_default_device, set_mesh
from tendermint_tpu_torch.libs import failpoints
from tendermint_tpu_torch.types import sign_batch as sbm

import test_torch_speculation as tts

D = 8
BUFFERS = ("ab", "sb", "s_ok", "patch", "split", "patch_len", "group",
           "active")
TEMPLATE = (b"\x08\x02\x11" + bytes(range(60)), b"\x32\x0bsome-chain")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_mesh():
    set_default_device("cpu")
    set_mesh(["cpu"] * D)
    yield
    for mod in (cbatch, jcbatch):
        mod.reset_breakers()
    failpoints.disarm_all()
    jfailpoints.disarm_all()
    set_mesh(None)
    set_default_device(None)


def _rows(arena, ts, sigs):
    ts = np.asarray(ts, np.int64)
    group = np.ones(len(ts), np.int32)
    patch, split, patch_len = sbm._build_patches(
        arena.pre_len.astype(np.int64), arena.suf_len, group, ts)
    sig_rows = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    return sig_rows, patch, split, patch_len, group


def _assert_same(jarena, parena):
    assert (parena.n_shards, parena.shard_capacity, parena.capacity) == (
        jarena.n_shards, jarena.shard_capacity, jarena.capacity)
    for name in BUFFERS:
        want = np.array(getattr(jarena, f"_{name}"))
        got = parena.view(name).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), name
    for name in ("pre", "pre_len", "suf", "suf_len"):
        assert np.array_equal(getattr(jarena, name), getattr(parena, name))


def _pair(lanes=65):
    jarena = jrs.MeshResidentArena(lanes, mesh=jtv._mesh())
    parena = rs.MeshResidentArena(lanes)
    return jarena, parena


def _keys(n, tag):
    return [ref.public_key_from_seed(tag + bytes([i]) * 31) for i in range(n)]


def test_routing_and_buffers_match_reference():
    """Splices (duplicate slots carrying the same row, as the reference's
    scatter defines them; a full-capacity delta) and a deactivate_all
    through both arenas: after each step the (D, per, ...) buffers are
    equal, no splice moves a buffer, and each shard's upload stays
    within the single arena's bytes / D plus the template bytes."""
    rng = np.random.default_rng(41)
    jarena, parena = _pair()
    assert parena.capacity == 1 + D * 127 and len(parena._blocks) == 1
    pubs = _keys(64, b"r")
    for arena in (jarena, parena):
        arena.install_keys(pubs)
        arena.set_template(1, *TEMPLATE)
    _assert_same(jarena, parena)
    # app lane 0 -> shard 0 slot 1; lane 11 -> shard 3 slot 2
    assert bytes(parena.view("ab")[3, 2].numpy()) == pubs[11]

    def sigs(k):
        return [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(k)]

    def ts(k):
        return rng.integers(0, 1 << 62, k).tolist()

    s3, t3 = sigs(1), ts(1)
    full_s, full_t = sigs(parena.capacity - 1), ts(parena.capacity - 1)
    steps = [(list(range(1, 65)), ts(64), sigs(64)),
             ([3, 11, 3, 19], [t3[0], ts(1)[0], t3[0], ts(1)[0]],
              [s3[0], sigs(1)[0], s3[0], sigs(1)[0]]),
             "clear",
             (list(range(1, parena.capacity)), full_t, full_s),
             "clear",
             ([9, 17], ts(2), sigs(2))]
    ptrs = {n: parena.buffer_pointer(n, shard=2) for n in BUFFERS}
    for step in steps:
        for arena in (jarena, parena):
            if step == "clear":
                arena.deactivate_all()
            else:
                slots, t, s = step
                arena.splice(slots, *_rows(arena, t, s))
        _assert_same(jarena, parena)
        assert {n: parena.buffer_pointer(n, shard=2) for n in BUFFERS} == ptrs
    assert parena.active_lanes == int(np.array(jarena._active).sum()) == D + 2
    single = rs.ResidentArena(65)
    single.set_template(1, *TEMPLATE)
    mesh = rs.MeshResidentArena(65)
    mesh.set_template(1, *TEMPLATE)
    rows = _rows(mesh, ts(64), sigs(64))
    for arena in (single, mesh):
        arena.splice(list(range(1, 65)), *rows)
    single.launch_args()  # each uploads its templates
    mesh.launch_args(0)
    template_bytes = sum(a.nbytes for a in (mesh.pre, mesh.pre_len, mesh.suf,
                                            mesh.suf_len))
    per = mesh.shard_reupload_bytes()
    assert per == [8 * rs.ROW_BYTES + template_bytes] * D
    assert max(per) <= single.reupload_bytes // D + template_bytes


def test_mesh_clear_wrapper_and_plain_version():
    """K8's clear keeps exactly each shard's sentinel in a block, and
    refuses a block that is not whole shards."""
    per = 128
    active = torch.ones(3 * per, dtype=torch.bool)
    rs.mesh_clear(active, per)
    assert active.nonzero()[:, 0].tolist() == [0, per, 2 * per]
    view = torch.ones((3, per), dtype=torch.bool)
    rs.mesh_clear_plain(view)
    assert torch.equal(view.reshape(-1), active)
    with pytest.raises(kernels.KernelError, match="shards of"):
        rs.mesh_clear(active[:-1], per)


@pytest.fixture(scope="module")
def launched():
    """An arena carried over from the reference's state (its buffers
    after installs and a splice of adversarial lanes, some left out),
    launched once through K8's wrappers, and the (D, per) verdicts of
    the plain version over the view."""
    set_default_device("cpu")
    set_mesh(["cpu"] * D)
    try:
        b = vectors.arena_batch(24, 64, seed=43)
        pubs = [b["pubkeys"][k] for k in b["idx"]]
        jarena = jrs.MeshResidentArena(65, mesh=jtv._mesh())
        jarena.install_keys(pubs)
        jarena.set_template(1, b["pre"], b["suf"])
        keep = [i for i, s in enumerate(b["sigs"])
                if len(s) == 64 and i % 9 != 4]
        jarena.splice([i + 1 for i in keep],
                      *_rows(jarena, [b["ts"][i] for i in keep],
                             [b["sigs"][i] for i in keep]))
        arrays = {n: np.array(getattr(jarena, f"_{n}")) for n in BUFFERS}
        parena = rs.MeshResidentArena.from_reference_arrays(
            arrays, (jarena.pre, jarena.pre_len, jarena.suf, jarena.suf_len),
            keys=jarena._keys_host)
        _assert_same(jarena, parena)
        verd = parena.launch()
        v = {n: parena.view(n) for n in BUFFERS}
        templates = parena.launch_args(0)[4:8]
        plain = rs.mesh_arena_verify_plain(
            v["ab"], v["sb"], v["s_ok"], v["active"], *templates, v["patch"],
            v["split"], v["patch_len"], v["group"], tv._btab("cpu")).numpy()
        return b, pubs, keep, jarena, parena, verd, plain
    finally:
        set_mesh(None)
        set_default_device(None)


def test_from_reference_arrays_verdicts_and_sentinels(launched):
    """Global-order verdicts of the carried-over arena equal the oracle
    on every spliced lane and are False on every other; every shard's
    sentinel verifies; the plain version over the (D, per) view gives
    the same verdicts shard by shard; the keys replayed match the
    reference's record."""
    b, pubs, keep, jarena, parena, verd, plain = launched
    assert parena.sentinel_ok == [True] * D and verd[0]
    want = np.zeros(parena.capacity, bool)
    want[0] = True
    for i in keep:
        want[i + 1] = ref.verify(pubs[i], b["msgs"][i], b["sigs"][i])
    assert verd.tolist() == want.tolist()
    assert verd[[i + 1 for i in keep]].tolist() == b["expect"][keep].tolist()
    assert not verd[[i + 1 for i in range(64) if i not in keep]].any()
    assert plain[:, 0].all()
    for d in range(D):
        assert plain[d, 1:].tolist() == verd[1 + d::D].tolist()
    assert parena._keys_host == jarena._keys_host
    kinds = {b["kinds"][i] for i in keep}
    assert {"valid", "bad_sig", "s_ge_l", "undecodable_r"} <= kinds


def test_global_order_matches_reference_gather(launched, monkeypatch):
    """The reference's launch, fed the port's per-shard verdicts through
    a stand-in kernel, gathers them into the same global order and the
    same sentinels; a lying shard 2 (its resident sentinel signature
    flipped) fails its own sentinel only, the aggregate slot 0, and is
    named by failed_shards in both packages."""
    _b, _pubs, _keep, jarena, parena, verd, plain = launched
    fed = {}
    monkeypatch.setattr(jrs, "_mesh_arena_kernel",
                        lambda width: lambda *a: fed["out"])
    fed["out"] = plain
    assert jarena.launch().tolist() == verd.tolist()
    assert jarena.sentinel_ok == parena.sentinel_ok
    set_default_device("cpu")
    blk = parena._blocks[parena._block_of[2]]
    sb = blk["bufs"]["sb"]
    off = int(parena._off_of[2])
    sb[off, 0] ^= 1
    try:
        lying = parena.launch()
    finally:
        sb[off, 0] ^= 1
    assert parena.sentinel_ok == [d != 2 for d in range(D)]
    assert not lying[0] and lying[1:].tolist() == verd[1:].tolist()
    assert parena.failed_shards() == [(2, "cpu/2")]
    out = plain.copy()
    out[2, 0] = False
    fed["out"] = out
    jarena.launch()
    assert jarena.failed_shards()[0][0] == 2


def test_ensure_mesh_replays_keys_like_reference():
    """An eviction (entry 6) rebuilds both arenas over 7 shards with the
    installed keys replayed into the same round-robin layout and the
    templates kept; a second ensure_mesh is a no-op; a re-admission
    rebuilds over 8 again."""
    jarena, parena = _pair()
    pubs = _keys(64, b"m")
    for arena in (jarena, parena):
        arena.install_keys(pubs)
        arena.set_template(1, *TEMPLATE)
    jmesh = jtv._mesh()
    reup = parena.reupload_bytes
    cbatch.mark_device_failed("ed25519", device="cpu/6")
    jcbatch.mark_device_failed("ed25519", device=str(jmesh.devices.flat[6]))
    assert parena.ensure_mesh() and jarena.ensure_mesh()
    assert parena.n_shards == D - 1 and "cpu/6" not in parena.names
    _assert_same(jarena, parena)
    assert parena.reupload_bytes == reup and parena.last_reshard_s >= 0
    assert not parena.ensure_mesh() and not jarena.ensure_mesh()
    cbatch.readmit_device("ed25519", "cpu/6")
    jcbatch.readmit_device("ed25519", str(jmesh.devices.flat[6]))
    assert parena.ensure_mesh() and jarena.ensure_mesh()
    assert parena.n_shards == D
    _assert_same(jarena, parena)


def test_make_arena_follows_the_effective_mesh():
    """make_arena shards the arena over the effective mesh when there
    is one (as the reference's default), over the survivors after an
    eviction, and builds one ResidentArena when fewer than two entries
    are left or no mesh is set."""
    arena = rs.make_arena(8)
    assert isinstance(arena, rs.MeshResidentArena) and arena.n_shards == D
    cbatch.mark_device_failed("ed25519", device="cpu/3")
    arena = rs.make_arena(8)
    assert isinstance(arena, rs.MeshResidentArena)
    assert arena.n_shards == D - 1 and "cpu/3" not in arena.names
    cbatch.mark_device_failed("ed25519", device=[f"cpu/{i}" for i in
                                                 range(D) if i != 5])
    assert tv.effective_mesh() is None
    assert isinstance(rs.make_arena(8), rs.ResidentArena)
    cbatch.reset_breakers()
    set_mesh(None)
    assert isinstance(rs.make_arena(8), rs.ResidentArena)


def test_speculation_names_the_lying_entry():
    """The port's plane on the CPU mesh (device_min=1, so flushes run
    K8's plain path): a first burst verifies on the mesh arena; then
    shard 1's resident sentinel signature is flipped and the next burst
    fails that sentinel only — entry cpu/1's breaker opens alone (the
    backend breaker stays closed), the burst re-verifies on the host
    (one host recheck), the next flush reshards the arena over the 7
    survivors, and the commit serves with the same outcome as the
    reference plane's host path."""
    port, reference = tts.World("port"), tts.World("reference")
    votes = {w.name: [w.vote(i, tts._ts(i)) for i in range(tts.N)]
             for w in (port, reference)}
    plane = port.plane()
    jplane = reference.plane()
    for p, w in ((plane, port), (jplane, reference)):
        p.begin_height(tts.CHAIN, w.vs, tts.H, 0, w.bid)
    for v in votes["port"][:3]:
        plane.observe_precommit(v)
    plane.flush_sync()
    arena = plane._arena
    assert isinstance(arena, rs.MeshResidentArena) and arena.n_shards == D
    assert arena.sentinel_ok == [True] * D
    sb = arena._blocks[0]["bufs"]["sb"]
    sb[int(arena._off_of[1]), 0] ^= 1
    before = dict(cbatch.METRICS["evictions"]), cbatch.METRICS["host_rechecks"]
    for v in votes["port"][3:6]:
        plane.observe_precommit(v)
    plane.flush_sync()
    assert arena.failed_shards() == [(1, "cpu/1")]
    assert cbatch.breaker_states()["ed25519"] == "closed"
    assert cbatch.device_breaker_states() == {"cpu/1": "open"}
    assert cbatch.METRICS["host_rechecks"] == before[1] + 1
    assert cbatch.METRICS["evictions"].get(("cpu/1", "sentinel"), 0) == \
        before[0].get(("cpu/1", "sentinel"), 0) + 1
    for v in votes["port"][6:]:
        plane.observe_precommit(v)
    plane.flush_sync()
    assert plane._arena is arena and arena.n_shards == D - 1
    assert arena.sentinel_ok == [True] * (D - 1)
    for v in votes["reference"]:
        jplane.observe_precommit(v)
    jplane.flush_sync()
    got = port.serve(plane, port.commit(votes["port"]))
    want = reference.serve(jplane, reference.commit(votes["reference"]))
    assert got == want == ("served", True)
    assert plane.hits == jplane.hits == 1 and port.calls == []
    lanes = plane._heights[tts.H].lanes
    assert all(ln.verdict for ln in lanes.values()) and len(lanes) == tts.N
