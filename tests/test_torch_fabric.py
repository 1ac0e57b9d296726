"""Port parity: the multi-device verify fabric against the JAX package.

The port runs its plain PyTorch versions on a logical CPU mesh
(``set_mesh(["cpu"] * 8)``), the JAX package on the tier-1 run's 8
virtual XLA CPU devices; both with ``set_shard_crossover(8)``, so the
30-key set of tests/test_multichip.py (``sharded_keys``: 4 keys a
shard, shard 7 holding keys 28 and 29 and two padding keys) splits by
key range in both. Held: the mesh helpers and _shard_args' odd-bucket
padding; _route's local indices, n_local and slot map; every shard's
table entries (canonical mod p), keys and key_ok; verdicts of verify and
verify_structured on adversarial lanes over every range's first and last
key and with empty shards; K5's plain version shard by shard against
the JAX _skernel_sharded on the same routed lanes; the carried-over
tables of a sharded JAX build; and the lane-sharded general paths.
Tolerance: exact everywhere — limbs canonical mod p, index maps and
verdicts identical.

On the CPU every shard launch runs a plain version (~1 s each whatever
its lanes), so the tests share the few sharded launches they need."""

import hashlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu.crypto import sr25519_ref as jsr
from tendermint_tpu.crypto.tpu import expanded as jex
from tendermint_tpu.crypto.tpu import sr_verify as jsv
from tendermint_tpu.crypto.tpu import verify as jtv
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.sign_batch import CommitSignBatch as JCommitSignBatch
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.crypto.cuda import field as fe
from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import set_default_device, set_mesh
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types.sign_batch import CommitSignBatch

import test_torch_commit as ttc

D = 8
CHAIN = "fabric-chain"
CPU8 = ["cpu"] * D


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run no faster on more threads at these batch
    sizes; one keeps parallel test workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_mesh():
    set_default_device("cpu")
    set_mesh(CPU8)
    ex.set_shard_crossover(8)
    jex.set_shard_crossover(8)
    yield
    ex.set_shard_crossover(None)
    jex.set_shard_crossover(None)
    set_mesh(None)
    set_default_device(None)


def _keys(n, tag=b"mc"):
    seeds = [hashlib.sha256(tag + b"%d" % i).digest() for i in range(n)]
    return seeds, [ref.public_key_from_seed(s) for s in seeds]


@pytest.fixture(scope="module")
def sharded_keys():
    """The 30-key straddle set, built sharded by both packages, and the
    reference's build carried over to the port (from_reference_arrays)."""
    seeds, pubs = _keys(30)
    set_default_device("cpu")
    set_mesh(CPU8)
    ex.set_shard_crossover(8)
    jex.set_shard_crossover(8)
    try:
        shd, jshd = ex.ExpandedKeys(pubs), jex.ExpandedKeys(pubs)
        carried = ex.ExpandedKeys.from_reference_arrays(
            pubs, np.asarray(jshd.tables), np.asarray(jshd.key_ok))
        return seeds, pubs, shd, jshd, carried
    finally:
        ex.set_shard_crossover(None)
        jex.set_shard_crossover(None)
        set_mesh(None)
        set_default_device(None)


def _canon(tables) -> np.ndarray:
    t = tables.reshape(-1, fe.NLIMB).T.to(torch.int64)
    return fe.canonical(t).T.reshape(tables.shape).numpy()


# -- the mesh ----------------------------------------------------------------


def test_set_mesh_and_mesh_helpers(monkeypatch):
    """set_mesh checks entry types against the default device; a mesh
    of fewer than two entries is no mesh; mesh_lane_pad equals the
    reference's on the full 8-device mesh and a 3-device submesh."""
    mesh = tv.effective_mesh()
    assert mesh == tuple(torch.device("cpu") for _ in range(D))
    assert mesh == tv._mesh()
    with pytest.raises(ValueError, match="not of the default device"):
        set_mesh(["cpu", "cuda:0"])
    assert tv._mesh() == mesh  # a refused mesh leaves the old one
    set_mesh(["cpu"])
    assert tv._mesh() is None
    set_mesh(None)
    assert tv._mesh() is None  # the default on the CPU: no mesh
    set_default_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            set_mesh(CPU8)
    set_default_device("cpu")
    jmesh3 = Mesh(np.array(jax.devices()[:3]), ("dp",))
    for bucket in (128, 256, 2048, 10_240, 16_384):
        for d in (3, 8):
            jmesh = jtv._mesh() if d == 8 else jmesh3
            assert tv.mesh_lane_pad(bucket, [None] * d) == \
                jtv.mesh_lane_pad(bucket, jmesh)
    assert tv._SHARD_MIN == jtv._SHARD_MIN


def test_crossover_knobs_match_reference(monkeypatch):
    """set_shard_crossover, the lenient TM_TPU_SHARD_CROSSOVER parse, the
    single-device budget (the reference's CPU cap) and MeshConfig."""
    for pkg in (ex, jex):
        pkg.set_shard_crossover(None)
    assert ex.shard_crossover_keys() == jex.shard_crossover_keys() == 2048
    assert ex._single_chip_max_keys() == jex._single_chip_max_keys()
    for env, want in (("512", 512), ("0", 2048), ("bogus", 2048)):
        monkeypatch.setenv("TM_TPU_SHARD_CROSSOVER", env)
        assert ex.shard_crossover_keys() == jex.shard_crossover_keys() == want
    ex.set_shard_crossover(77)
    assert ex.shard_crossover_keys() == 77
    # a CPU mesh gives no lift: its shards share one memory
    assert ex.max_keys() == jex.max_keys() == 2048
    cfg = pconfig.MeshConfig()
    cfg.validate_basic()
    pconfig.apply_mesh(cfg)
    monkeypatch.delenv("TM_TPU_SHARD_CROSSOVER")
    assert ex.shard_crossover_keys() == 2048
    pconfig.apply_mesh(pconfig.MeshConfig(expanded_shard_crossover_keys=300))
    assert ex.shard_crossover_keys() == 300
    with pytest.raises(ValueError, match="negative mesh"):
        pconfig.MeshConfig(expanded_shard_crossover_keys=-1).validate_basic()


def test_shard_args_pads_odd_bucket_like_reference(monkeypatch):
    """Replicated tables on a 3-entry mesh: a 256-lane bucket pads to
    258 with zero lanes, the replicated fields whole, as the
    reference's _shard_args does on a 3-device submesh."""
    monkeypatch.setattr(tv, "_SHARD_MIN", 128)
    monkeypatch.setattr(jtv, "_SHARD_MIN", 128)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 30, 256).astype(np.int32)
    fields = {"sb": rng.integers(0, 256, (256, 64), dtype=np.uint8),
              "s_ok": rng.integers(0, 2, 256).astype(bool),
              "pre": rng.integers(0, 256, (4, 16), dtype=np.uint8)}
    jdummy = type("E", (), {})()
    jdummy.sharded, jdummy.mesh = False, Mesh(np.array(jax.devices()[:3]),
                                              ("dp",))
    jidx, jfields, _btab = jex.ExpandedKeys._shard_args(
        jdummy, idx, fields, repl_keys=("pre",))
    pdummy = type("E", (), {})()
    pdummy.mesh = tuple(torch.device("cpu") for _ in range(3))
    pidx, pfields, shard = ex.ExpandedKeys._shard_args(
        pdummy, idx, fields, repl_keys=("pre",))
    assert shard and pidx.shape == (258,)
    assert np.array_equal(pidx, np.asarray(jidx))
    for k in fields:
        assert np.array_equal(pfields[k], np.asarray(jfields[k])), k
    assert pfields["pre"].shape == (4, 16)
    pdummy.mesh = None  # no mesh: no padding, no sharding
    assert ex.ExpandedKeys._shard_args(pdummy, idx, fields)[2] is False


# -- key-range-sharded tables ------------------------------------------------


def test_sharded_build_matches_reference(sharded_keys):
    """Every shard's keys, table entries (canonical mod p) and key_ok —
    padding keys' False included — equal the reference's sharded build;
    the carried-over reference build equals the port's own."""
    _seeds, pubs, shd, jshd, carried = sharded_keys
    assert shd.sharded and jshd.sharded
    assert (shd.n_shards, shd.keys_per_shard) == \
        (jshd.n_shards, jshd.keys_per_shard) == (D, 4)
    jrows = np.asarray(jshd.tables)
    jok = np.asarray(jshd.key_ok)
    jkeys = np.asarray(jshd.akeys)
    assert not jok[7, 2:].any()  # the straddle shard's padding keys
    for d, (akeys, tables, key_ok) in enumerate(shd.shards):
        conv = fe.from_radix12(jrows[d, :, :88].reshape(4, 69, 9, 4, 22))
        assert np.array_equal(_canon(tables), conv), d
        assert key_ok.tolist() == jok[d].tolist(), d
        assert np.array_equal(akeys.numpy(), jkeys[d]), d
    assert carried.sharded and carried.n_shards == D
    for (a, t, ok), (a2, t2, ok2) in zip(carried.shards, shd.shards):
        assert torch.equal(a, a2) and torch.equal(ok, ok2)
        assert np.array_equal(_canon(t), _canon(t2))
    set_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="8-shard reference build"):
        ex.ExpandedKeys.from_reference_arrays(pubs, jrows, jok)


@pytest.mark.parametrize("lanes", [
    [i % 30 for i in range(48)],        # every range, the straddle shard
    [3, 4, 27, 28, 29, 0],              # range boundaries, shards empty
    [0, 1, 2, 3, 0, 1],                 # shard 0 only
    [29] * 130,                         # all in one range: n_local 256
])
def test_route_matches_reference(sharded_keys, lanes):
    """_route's local indices, n_local, routed lanes and slot map equal
    the reference's (pad lanes zero, local index 0)."""
    _seeds, _pubs, shd, jshd, _carried = sharded_keys
    idx = np.asarray(lanes, np.int32)
    rng = np.random.default_rng(len(lanes))
    per = {"sb": rng.integers(0, 256, (len(lanes), 64), dtype=np.uint8),
           "s_ok": rng.integers(0, 2, len(lanes)).astype(bool),
           "patch": rng.integers(0, 256, (len(lanes), 24), dtype=np.uint8)}
    lidx, routed, slot = shd._route(idx, per)
    jlidx, jrouted, _btab, _repl, jslot = jshd._route(idx, per)
    assert np.array_equal(lidx, np.asarray(jlidx))
    assert lidx.shape[1] == ex.ExpandedKeys._bucket(
        int(np.bincount(idx // 4).max()))
    assert np.array_equal(slot, jslot)
    for k in per:
        assert np.array_equal(routed[k], np.asarray(jrouted[k])), k
    # the slot map puts every lane back: its own row, in order
    assert np.array_equal(routed["sb"].reshape(-1, 64)[slot], per["sb"])


def _adversarial_lanes(seeds, lanes, tamper):
    """Lane i: key lanes[i], a short message, tampered as `tamper` says."""
    msgs, sigs, expect = [], [], []
    for i, k in enumerate(lanes):
        msg = b"fabric lane %d" % i
        sig = ref.sign(seeds[k], msg)
        kind = tamper.get(i)
        if kind == "bad-sig":
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        elif kind == "wrong-lane":
            sig = ref.sign(seeds[(k + 1) % len(seeds)], msg)
        elif kind == "malformed":
            sig = b"\x07" * 63
        elif kind == "s_ge_l":
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == "r_identity":  # R replaced by y = p + 1 (ZIP-215)
            sig = (ref.P + 1).to_bytes(32, "little") + sig[32:]
        msgs.append(msg)
        sigs.append(sig)
        expect.append(kind is None)
    return msgs, sigs, expect


def test_sharded_verify_bytes_form_matches_reference(sharded_keys):
    """verify() over sharded tables (K5 in the _xkernel_sharded form) on
    lanes of shards 0-2 only — the first and last key of each, a
    tampered lane of every kind — with shards 3-7 empty: verdicts equal
    the reference oracle's, to which the reference's own test_multichip
    holds its _xkernel_sharded on this set (that program takes ~40 s to
    compile on the CPU; _skernel_sharded is compared directly below)."""
    seeds, pubs, shd, _jshd, _carried = sharded_keys
    lanes = [0, 3, 4, 7, 8, 11, 1, 2, 5, 6, 9, 10] * 2
    tamper = {12: "bad-sig", 13: "wrong-lane", 14: "malformed",
              15: "s_ge_l", 16: "r_identity", 23: "bad-sig"}
    msgs, sigs, expect = _adversarial_lanes(seeds, lanes, tamper)
    shards = []
    real_k5 = ex.shard_verify
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "shard_verify", lambda *a, **kw: shards.append(
            (a[0].shape[0], kw["msg"].shape[1])) or real_k5(*a, **kw))
        got = shd.verify(lanes, msgs, sigs)
    assert shards == [(128, 64)] * D
    assert got.tolist() == expect
    oracle = [jref.verify(pubs[k], m, s) for k, m, s in zip(lanes, msgs, sigs)]
    assert got.tolist() == oracle


def _structured_commit(seeds, pubs, n_lanes, tamper):
    """The commit shape of test_multichip's structured sharded parity
    (tests/test_structured_verify.py _mk: nil votes every 7th slot, edge
    timestamps; lane i signed by key i mod the set), over this set, in
    both packages."""
    edge = [0, 1, 999_999_999, 1_000_000_000, 1_753_928_000_123_456_789]
    made = []
    for mod in (pblock, jblock):
        bid = mod.BlockID(bytes(range(32)), mod.PartSetHeader(2, bytes(32)))
        cs = [mod.CommitSig(mod.BlockIDFlag.NIL if i % 7 == 3
                            else mod.BlockIDFlag.COMMIT, bytes([i % 256]) * 20,
                            edge[i % 5] + i, b"") for i in range(n_lanes)]
        made.append(mod.Commit(977, 1, bid, cs))
    pc, jc = made
    lanes, sigs, expect = [], [], []
    for i in range(n_lanes):
        k = i % len(pubs)
        msg = pc.vote_sign_bytes(CHAIN, i)
        kind = tamper.get(i)
        sig = ref.sign(seeds[(k + 1) % len(pubs)] if kind == "wrong-lane"
                       else seeds[k], msg)
        if kind == "ts":
            pc.signatures[i].timestamp += 1
            jc.signatures[i].timestamp += 1
        elif kind == "malformed":
            sig = b"\x07" * 63
        lanes.append(k)
        sigs.append(sig)
        expect.append(kind is None)
    return (CommitSignBatch(CHAIN, pc, list(range(n_lanes))),
            JCommitSignBatch(CHAIN, jc, list(range(n_lanes))),
            lanes, sigs, expect)


def test_carried_structured_and_k5_plain_match_reference(sharded_keys,
                                                         monkeypatch):
    """The carry-across: the reference's sharded build, carried over
    (its tables equal the port's own build mod p, above), through
    verify_structured on 48 lanes cycling every key (every range's
    first and last key, the straddle shard), with a re-timestamped, a
    wrong-key and a malformed lane: the verdicts equal the reference's
    lane for lane, and each shard's K5 (shard_verify_plain, as the CPU
    runs it) equals that shard's row of the reference's
    _skernel_sharded output, pad lanes included."""
    seeds, pubs, _shd, jshd, carried = sharded_keys
    psb, jsb, lanes, sigs, expect = _structured_commit(
        seeds, pubs, 48, {5: "ts", 11: "wrong-lane", 17: "malformed"})
    ours, theirs = [], []
    real_k5 = ex.shard_verify

    def spy(*args, **kw):
        assert kw["templates"] is not None and kw["width"] == 192
        ours.append(real_k5(*args, **kw))
        return ours[-1]

    real_jk = jex._skernel_sharded

    def jspy(wpi):
        kernel = real_jk(wpi)

        def run(**kw):
            out = kernel(**kw)
            theirs.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(ex, "shard_verify", spy)
    monkeypatch.setattr(jex, "_skernel_sharded", jspy)
    got = carried.verify_structured(lanes, psb, sigs)
    want = np.asarray(jshd.verify_structured(lanes, jsb, sigs))
    assert got.tolist() == want.tolist() == expect
    assert len(ours) == D and len(theirs) == 1
    assert theirs[0].shape == (D, 128)
    for d in range(D):
        assert ours[d].tolist() == theirs[0][d].tolist(), d


# -- a sharded 200-validator commit -----------------------------------------


@pytest.fixture(scope="module")
def commits():
    """test_torch_commit's 200-validator sets in both packages: a valid
    commit and one with slot 5's signature corrupted."""
    return {case: ttc._build(case) for case in ("valid", "corrupted")}


@pytest.mark.parametrize("case,entry", [
    ("valid", "verify_commit"), ("valid", "verify_commit_light"),
    ("valid", "verify_commit_light_trusting"),
    ("corrupted", "verify_commit")])
def test_sharded_commit_matches_reference(commits, monkeypatch, case, entry):
    """A 200-validator commit through the three entry points, the port's
    tables split over 8 shards of 25 keys: the same outcome or error
    text as the reference, and where the expanded path runs, one K5
    launch per shard and per-lane verdicts equal to the reference's lane
    for lane. The trusting subset's 67 lanes are below the expanded
    path: they take the general path on one device, the case
    test_torch_commit holds against the reference, so here the outcome
    is held to its table. The reference keeps its tables
    replicated here: its verdicts do not depend on the placement (its
    own test_multichip holds the two placements equal), and its sharded
    programs at this set's table shape take minutes to compile on the
    CPU."""
    jex.set_shard_crossover(None)
    verdicts = {}
    for name, cls in (("port", ex.ExpandedKeys), ("reference",
                                                  jex.ExpandedKeys)):
        real = cls.verify_structured

        def spy(self, lanes, sbatch, sigs, _real=real, _name=name):
            verdicts[_name] = np.asarray(_real(self, lanes, sbatch, sigs))
            verdicts[_name + "_sharded"] = self.sharded
            return verdicts[_name]
        monkeypatch.setattr(cls, "verify_structured", spy)
    shards = []
    real_k5 = ex.shard_verify
    monkeypatch.setattr(ex, "shard_verify", lambda *a, **kw: shards.append(
        a[0].shape[0]) or real_k5(*a, **kw))
    got = ttc._outcome(entry, *commits[case]["port"])
    if entry == "verify_commit_light_trusting":
        # 67 lanes: the general path below _SHARD_MIN, one device, as in
        # test_torch_commit, which holds EXPECTED to the reference
        assert got == ttc.EXPECTED[(case, entry)]
        assert verdicts == {} and shards == []
        return
    want = ttc._outcome(entry, *commits[case]["reference"])
    assert got == want == ttc.EXPECTED[(case, entry)]
    assert verdicts["port_sharded"] and not verdicts["reference_sharded"]
    assert verdicts["port"].tolist() == verdicts["reference"].tolist()
    assert shards == [128] * D  # one launch per shard, n_local lanes each


# -- lane-sharded general paths ----------------------------------------------


def test_lane_sharded_verify_batch_matches_reference(monkeypatch):
    """verify_batch with _SHARD_MIN at 128 in both packages, on a 3-entry
    mesh: a 100-lane batch pads its 128 bucket to 129 and splits it
    43/43/43 (the reference's dispatch, recorded by a fake kernel on a
    3-device submesh, is also 129 lanes sharded); verdicts equal the
    reference oracle's and the port's single-device ones."""
    monkeypatch.setattr(tv, "_SHARD_MIN", 128)
    monkeypatch.setattr(jtv, "_SHARD_MIN", 128)
    b = vectors.adversarial_batch(16, 100, seed=21)
    pubs = [b["pubkeys"][k] for k in b["idx"]]
    set_mesh(["cpu"] * 3)
    before = dict(tv.SHARD_LANES)
    got = tv.verify_batch(pubs, b["msgs"], b["sigs"])
    assert {k: tv.SHARD_LANES[k] - before.get(k, 0)
            for k in ("cpu/0", "cpu/1", "cpu/2")} == {
                "cpu/0": 43, "cpu/1": 43, "cpu/2": 43}
    assert got.tolist() == b["expect"].tolist()
    assert got.tolist() == [jref.verify(p, m, s) for p, m, s in
                            zip(pubs, b["msgs"], b["sigs"])]
    assert got.tolist() == tv.verify_batch(pubs, b["msgs"], b["sigs"],
                                           device="cpu").tolist()
    seen = {}

    def fake_kernel():
        def k(*, btab, ab, sb, msg, nblocks, s_ok):
            seen["bucket"] = ab.shape[0]
            seen["sharded"] = len(ab.sharding.device_set) == 3
            return np.ones(ab.shape[0], bool)
        return k

    monkeypatch.setattr(jtv, "_mesh", lambda: Mesh(
        np.array(jax.devices()[:3]), ("dp",)))
    monkeypatch.setattr(jtv, "_kernel", fake_kernel)
    jtv.verify_batch(pubs, b["msgs"], b["sigs"])
    assert seen == {"bucket": 129, "sharded": True}


def test_lane_sharded_verify_batch_sr_matches_reference(monkeypatch):
    """verify_batch_sr with _SHARD_MIN at 128 in both packages, on a
    3-entry mesh: 100 lanes pad to 129 (the reference's dispatch shape,
    recorded by a fake kernel on a 3-device submesh), one K9 plain
    launch per entry; verdicts equal the reference oracle's and
    device="cpu", which bypasses the mesh."""
    monkeypatch.setattr(tv, "_SHARD_MIN", 128)
    monkeypatch.setattr(jtv, "_SHARD_MIN", 128)
    b = vectors.sr_adversarial_batch(100, seed=23)
    set_mesh(["cpu"] * 3)
    before = dict(tv.SHARD_LANES)
    got = sv.verify_batch_sr(b["pubs"], b["msgs"], b["sigs"])
    assert {k: tv.SHARD_LANES[k] - before.get(k, 0)
            for k in ("cpu/0", "cpu/1", "cpu/2")} == {
                "cpu/0": 43, "cpu/1": 43, "cpu/2": 43}
    assert got.tolist() == b["expect"].tolist()
    assert got.tolist() == [jsr.verify(p, m, s) for p, m, s in
                            zip(b["pubs"], b["msgs"], b["sigs"])]
    before = dict(tv.SHARD_LANES)
    assert got.tolist() == sv.verify_batch_sr(
        b["pubs"], b["msgs"], b["sigs"], device="cpu").tolist()
    assert tv.SHARD_LANES == before
    seen = {}

    def fake_kernel():
        def k(*, btab, ab, rb, kdig, sdig, a_pre, r_pre, s_ok):
            seen["bucket"] = ab.shape[0]
            seen["sharded"] = len(ab.sharding.device_set) == 3
            return np.ones(ab.shape[0], bool)
        return k

    monkeypatch.setattr(jtv, "_mesh", lambda: Mesh(
        np.array(jax.devices()[:3]), ("dp",)))
    monkeypatch.setattr(jsv, "_kernel", fake_kernel)
    jsv.verify_batch_sr(b["pubs"], b["msgs"], b["sigs"])
    assert seen == {"bucket": 129, "sharded": True}
