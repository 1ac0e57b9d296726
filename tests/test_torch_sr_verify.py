"""Port parity: the ristretto plain functions and K9's plain version
(sr_verify_plain, through verify_batch_sr on the CPU) against the JAX
package's ristretto functions and verify_batch_sr on the XLA CPU
backend, and against the sr25519_ref oracle, on numpy-seeded inputs.
Every JAX sr25519 call here has at most 128 lanes, so the reference's
kernel compiles once. Tolerance: exact — canonical field values, ok
masks and verdicts identical."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import edwards as jed
from tendermint_tpu.crypto.tpu import field as jf
from tendermint_tpu.crypto.tpu import ristretto as jrs
from tendermint_tpu.crypto.tpu import sr_verify as jsv
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519_ref as sr
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.batch import BatchVerifier
from tendermint_tpu_torch.crypto.cuda import edwards as ed
from tendermint_tpu_torch.crypto.cuda import field as fe
from tendermint_tpu_torch.crypto.cuda import ristretto as rs
from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
from tendermint_tpu_torch.device import set_default_device

P = fe.P


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run no faster on more threads at these batch
    sizes; one keeps parallel test workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    return vectors.sr_adversarial_batch(3 * len(vectors.SR_KINDS), seed=41)


def _port_ints(t) -> list[int]:
    return fe.from_limbs(fe.canonical(t))


def _jax_ints(t) -> list[int]:
    return [v % P for v in jf.from_limbs(np.asarray(jf.canonical(t)))]


def _port(vals) -> torch.Tensor:
    return torch.stack([torch.from_numpy(fe.to_limbs(v % P)) for v in vals], 1)


def _jax(vals):
    return jnp.asarray(np.stack([jf.to_limbs(v % P) for v in vals], 1))


def _encodings() -> list[bytes]:
    """Adversarial ristretto encodings, canonical ones of random points
    and random bytes."""
    rng = np.random.default_rng(42)
    encs = [bytes(32), b"\xff" * 32, P.to_bytes(32, "little"),
            (P - 1).to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
            b"\x01" + bytes(31), bytes(31) + b"\x80",
            vectors._failing_encoding("flipped_i"),
            vectors._failing_encoding("none"),
            vectors._failing_encoding("odd_t")]
    for _ in range(16):
        k = int.from_bytes(rng.bytes(32), "little") % ref.L
        encs.append(sr.ristretto_encode(ref.base_mult(k)))
    encs += [rng.bytes(32) for _ in range(10)]
    encs += [bytes([b & 0xFE for b in rng.bytes(31)]) + b"\x00"
             for _ in range(10)]
    return encs


def _pre_ok(rows: np.ndarray) -> np.ndarray:
    return sv._lt_words(rows, sv._P_WORDS) & ((rows[:, 0] & 1) == 0)


def test_sqrt_ratio_m1_matches_reference():
    rng = np.random.default_rng(43)
    us = [0, 1, 2, P - 1] + [int.from_bytes(rng.bytes(32), "little") % P
                             for _ in range(28)]
    vs = [1, 0, 1, 1] + [int.from_bytes(rng.bytes(32), "little") % P
                         for _ in range(28)]
    ok, root = rs.sqrt_ratio_m1(_port(us), _port(vs))
    jok, jroot = jrs.sqrt_ratio_m1(_jax(us), _jax(vs), len(us))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert _port_ints(root) == _jax_ints(jroot)
    for u, v, r, w in zip(us, vs, _port_ints(root), ok.tolist()):
        assert (w, r) == sr._sqrt_ratio_m1(u, v)
    _, c, f, fi = rs.sqrt_ratio_m1_branches(_port(us), _port(vs))
    assert ok.tolist() == (c | f).tolist()
    assert c.any() and f.any() and fi.any()


def test_decode_matches_reference_and_oracle():
    encs = _encodings()
    rows = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32).copy()
    pre = _pre_ok(rows)
    assert np.array_equal(pre, jsv._lt_words(rows, jsv._P_WORDS)
                          & ((rows[:, 0] & 1) == 0))
    trows = torch.from_numpy(rows).to(torch.int64).T
    limbs = fe.limbs_from_bytes(torch.cat([trows[:31],
                                           (trows[31] & 0x7F)[None]]))
    pt, ok = rs.decode(limbs, torch.from_numpy(pre))
    jpt, jok = jrs.decode(jf.limbs_from_bytes(jnp.asarray(rows.T.astype(
        np.int32))), pre)
    assert ok.tolist() == np.asarray(jok).tolist()
    for coord in ("x", "y", "z", "t"):
        assert _port_ints(getattr(pt, coord)) == _jax_ints(getattr(jpt, coord))
    want = [sr.ristretto_decode(e) for e in encs]
    assert ok.tolist() == [w is not None for w in want]
    xs, ys = _port_ints(pt.x), _port_ints(pt.y)
    for i, w in enumerate(want):
        assert (xs[i], ys[i]) == ((w[0], w[1]) if w else (0, 1))
    c, f, fi = rs.decode_ratio_branches(limbs)
    branches = [vectors.ratio_branch(e) for e in encs]
    for i in np.nonzero(pre)[0]:
        assert (c[i].item(), f[i].item(), fi[i].item()) == (
            branches[i] == "correct", branches[i] == "flipped",
            branches[i] == "flipped_i")
    assert {"correct", "flipped", "flipped_i", "none"} <= {
        branches[i] for i in np.nonzero(pre)[0]}


def test_equal_matches_reference_on_torsion_shifts():
    """Each point against itself moved by each 4-torsion point (equal
    as ristretto elements; the shifts by (+-i, 0) need the Y1*Y2 ==
    X1*X2 branch) and against another point (not equal)."""
    rng = np.random.default_rng(44)
    i = ref.SQRT_M1
    ps, qs, want, branch = [], [], [], []
    for _ in range(8):
        k = int.from_bytes(rng.bytes(32), "little") % ref.L
        x, y = ref.from_extended(ref.base_mult(k))
        z = int.from_bytes(rng.bytes(32), "little") % P or 1
        other = ref.from_extended(ref.base_mult(k + 1))
        for qx, qy, br in [(x, y, "xy"), (-x, -y, "xy"), (i * y, i * x, "yy"),
                           (-i * y, -i * x, "yy"), (*other, "none")]:
            ps.append((x * z, y * z, z, x * y * z))
            qs.append((qx, qy, 1, qx * qy))
            want.append(br != "none")
            branch.append(br)

    def points(pts, conv):
        return [conv([p[c] for p in pts]) for c in range(4)]

    p, q = ed.Point(*points(ps, _port)), ed.Point(*points(qs, _port))
    jp, jq = jed.Point(*points(ps, _jax)), jed.Point(*points(qs, _jax))
    got = rs.equal(p, q)
    assert got.tolist() == np.asarray(jrs.equal(jp, jq)).tolist() == want
    xy, yy = rs.equal_branches(p, q)
    assert xy.tolist() == [b == "xy" for b in branch]
    assert yy.tolist() == [b == "yy" for b in branch]


def test_verify_batch_sr_matches_reference_and_oracle(batch):
    args = (batch["pubs"], batch["msgs"], batch["sigs"])
    got = sv.verify_batch_sr(*args, device="cpu")
    assert got.tolist() == jsv.verify_batch_sr(*args, cpu=True).tolist()
    assert got.tolist() == [sr.verify(*t) for t in zip(*args)]
    assert got.tolist() == batch["expect"].tolist()
    assert set(batch["kinds"]) == set(vectors.SR_KINDS)


def test_adversarial_batch_takes_every_branch(batch):
    """On sr_points_plain's own values: lanes whose verdict comes from
    each branch of equal, and decodes through each test of
    sqrt_ratio_m1."""
    packed, wf = sv.pack_batch_sr(batch["pubs"], batch["msgs"], batch["sigs"])
    t = sv.tv.to_device(packed, "cpu")
    v, r, a_ok, r_ok = sv.sr_points_plain(
        t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"], t["r_pre"],
        sv.comb_table("cpu"))
    xy, yy = rs.equal_branches(v, r)
    live = a_ok & r_ok & t["s_ok"] & torch.from_numpy(wf)
    kinds = np.array(batch["kinds"])
    assert set(kinds[(xy & ~yy & live).numpy()]) >= {"eq_xy"}
    assert set(kinds[(yy & ~xy & live).numpy()]) >= {"eq_yy"}
    pre = torch.cat([t["a_pre"], t["r_pre"]])
    c, f, fi = rs.decode_ratio_branches(sv.encoding_limbs(t["ab"], t["rb"]))
    assert (c & pre).any() and (f & pre).any() and (fi & pre).any()
    n = len(kinds)
    assert "a_correct" in kinds[(c & pre)[:n].numpy()]
    assert "a_flipped" in kinds[(f & pre)[:n].numpy()]


def test_host_packing_matches_reference(batch):
    packed, wf = sv.pack_batch_sr(batch["pubs"], batch["msgs"], batch["sigs"])
    c = sv.check_bytes(batch["pubs"], batch["sigs"])
    assert np.array_equal(wf, c["well_formed"])
    assert np.array_equal(packed["s_ok"],
                          jsv._lt_words(c["s_raw"], jsv._L_WORDS))
    ks = sv.sr25519_challenges(c["ab"], batch["msgs"], c["rb"])
    assert np.array_equal(packed["kdig"],
                          jsv._nibbles(ks, len(ks)).astype(np.uint8))
    s_ints = [int.from_bytes(row.tobytes(), "little") for row in c["s_raw"]]
    assert np.array_equal(packed["sdig"],
                          jsv._nibbles(s_ints, len(s_ints)).astype(np.uint8))
    assert np.array_equal(sv.comb_table("cpu").numpy(),
                          sv.tv.b_comb_tables()[:64])


def test_batch_verifier_routes_sr25519(monkeypatch):
    """>= _DEVICE_THRESHOLD_SR sr25519 lanes reach K9's wrapper (on
    the CPU its plain version: .launches counts kernel launches only
    and stays put); 3 stay on the host; a mixed batch gives per-lane
    verdicts in add order."""
    calls = []
    real = sv.sr_verify
    monkeypatch.setattr(
        sv, "sr_verify",
        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    launches = real.launches
    minis = [hashlib.sha256(b"route-%d" % i).digest() for i in range(6)]
    msgs = [b"mixed batch %d" % i for i in range(6)]
    sigs = vectors.sr_sign_batch(minis, msgs)
    pubs = [Sr25519PubKey(sr.public_key_from_mini(m)) for m in minis]
    sigs[2] = sigs[2][:32] + bytes(31) + b"\x80"
    assert pbatch._DEVICE_THRESHOLD_SR == 4
    for n, want_calls in ((3, []), (4, [4])):
        calls.clear()
        bv = BatchVerifier()
        for i in range(n):
            bv.add(pubs[i], msgs[i], sigs[i])
        ok, verdicts = bv.verify()
        assert not ok and verdicts.tolist() == [i != 2 for i in range(n)]
        assert calls == want_calls
    seeds = [hashlib.sha256(b"route-ed-%d" % i).digest() for i in range(3)]
    sr_lanes = iter([0, 2, 3, 4, 5, 1])
    bv, want = BatchVerifier(), []
    for i in range(9):
        if i % 3 == 1:
            s = seeds[i // 3]
            pk, m = Ed25519PubKey(ref.public_key_from_seed(s)), b"ed %d" % i
            bv.add(pk, m, ref.sign(s, m if i != 7 else b"other"))
            want.append(i != 7)
        else:
            j = next(sr_lanes)
            bv.add(pubs[j], msgs[j], sigs[j])
            want.append(j != 2)
    calls.clear()
    ok, verdicts = bv.verify()
    assert verdicts.tolist() == want and not ok
    assert calls == [6]
    assert real.launches == launches
