"""Plain models of the order in which K4 and K9 spread a lane over a
block (csrc/verify_x4.cuh, general_verify.cu, sr_verify.cu), against
the port's plain versions and the JAX package's reference, on the CPU.

- The 4-thread chain (csrc/chain_x4.cuh): thread q of a lane holds
  coordinate q of the accumulator and computes one product of each
  round; a doubling is two rounds, an add three (a, b, T1 T2, Z1 Z2;
  then c = T1 T2 2d; then X, Y, Z, T). The models below run those
  rounds thread by thread and must equal ``edwards.double`` and
  ``edwards.add`` limb for limb.
- The signed table: entries 0..8 of j (-A), built by the chain's adds
  in ``build_window_table``'s order, must equal the first nine of the
  plain version's 16-entry table limb for limb; a negative digit takes
  entry |d| with -X and -T, the inverse of entry |d|.
- The role split: the comb warps (C of them) sum contiguous slices of
  the 64 comb windows, the R warp adds their sums in warp order to -R
  (K4) or to the identity (K9), the chain adds that point last. The
  defines allow 8, 16 or 32 lanes a block (1, 2 or 4 chain warps) and
  up to 32 warps, so C runs over 1..29; the model's verdicts for every
  C must equal ``general_verify_plain``'s and ``sr_verify_plain``'s.
  Dead lanes (s >= L; for K9 also an encoding that fails the host's
  byte checks) do no curve work, as in the kernels.
- K9's digits: the host's 64 nibbles of k (< L) recoded to signed
  digits with a 65th, the carry, which is 0 for every k < L (k = L - 1
  included) and keeps the value for any 64 nibbles.

The lanes: the adversarial batches (non-canonical R, s >= L,
undecodable R and keys, small-order keys; for K9 every branch of the
ristretto decode and equality), ed25519 lanes whose A or R carries an
order-8 torsion point, keys encoded non-canonically, and keys whose
decompression takes the x * sqrt(-1) branch. The JAX package's kernels
are held to the plain versions by test_torch_verify.py and
test_torch_sr_verify.py; here the verdicts are also held to the JAX
package's own ed25519 and sr25519 oracles lane by lane, and K4's
digits to its fold. Tolerance: exact (limbs, verdicts)."""

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu.crypto import sr25519_ref as jsr
from tendermint_tpu.crypto.tpu import scalar as jsc
from tendermint_tpu.crypto.tpu import sr_verify as jsv
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import edwards as ed
from tendermint_tpu_torch.crypto.cuda import ristretto as rs
from tendermint_tpu_torch.crypto.cuda import scalar as sc
from tendermint_tpu_torch.crypto.cuda import sha512 as sh
from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.crypto.cuda.fieldsel import F as fe
from tendermint_tpu_torch.device import set_default_device

CPU = torch.device("cpu")
# Comb warps a block may have: TM_X4_WARPS - TM_X4_LANES / 8 - 2 for 8,
# 16 or 32 lanes and at most 32 warps (common.cuh, verify_x4.cuh).
COMB_WARPS = tuple(range(1, 30))
# A point of order 8 (the standard list of ed25519's small-order points).
T8 = bytes.fromhex(
    "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
NONCANONICAL_KEYS = ((ref.P + 1).to_bytes(32, "little"),
                     (1 | 1 << 255).to_bytes(32, "little"))


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


# -- the 4-thread chain -------------------------------------------------------
# A lane's four threads: a (4, NLIMB, N) tensor, row q thread q's value.


def _threads(p: ed.Point) -> torch.Tensor:
    return torch.stack(list(p))


def _point(m: torch.Tensor) -> ed.Point:
    return ed.Point(*m.unbind(0))


def _round2(e, f, g, h) -> torch.Tensor:
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
                        fe.mul(e, h)])


def double_x4(m: torch.Tensor) -> torch.Tensor:
    """ge_double_x4: round one X^2, Y^2, Z^2, (X + Y)^2 (thread q
    squares its own coordinate, thread 3 X + Y from threads 0 and 1),
    the sums every thread forms, round two."""
    ops = (m[0], m[1], m[2], fe.add(m[0], m[1]))
    a, b, t, u = (fe.sqr(o) for o in ops)
    c = fe.add(t, t)
    h = fe.add(a, b)
    e = fe.sub(h, u)
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return _round2(e, f, g, h)


def operand_x4(entry: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """x4_operand: thread q's round-one operand of the point `entry`
    (negated, -X and -T, where neg): Y2 - X2, Y2 + X2, T2, Z2."""
    x = torch.where(neg[None], fe.neg(entry[0]), entry[0])
    t = torch.where(neg[None], fe.neg(entry[3]), entry[3])
    return torch.stack([fe.sub(entry[1], x), fe.add(entry[1], x), t,
                        entry[2]])


def add_x4(m: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """ge_add_x4: each thread takes coordinate q ^ 1 from its neighbour,
    forms Y1 - X1 (thread 0) or Y1 + X1 (thread 1), and multiplies by
    its operand; thread 2's product times 2d; round two."""
    n = m.shape[-1]
    sw = m[[1, 0, 3, 2]]
    m1 = torch.stack([fe.sub(sw[0], m[0]), fe.add(m[1], sw[1]), sw[2], sw[3]])
    r = torch.stack([fe.mul(m1[q], op[q]) for q in range(4)])
    c = fe.mul(r[2], fe.const(fe.D2, n, m.device))
    d = fe.add(r[3], r[3])
    e = fe.sub(r[1], r[0])
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(r[1], r[0])
    return _round2(e, f, g, h)


def entry_x4(table: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x4_entry: entry |d| of a (9, 4, NLIMB, N) table, -X and -T where
    d < 0."""
    lanes = torch.arange(table.shape[-1])
    e = table[d.abs(), :, :, lanes].permute(1, 2, 0)
    neg = (d < 0)[None]
    return torch.stack([torch.where(neg, fe.neg(e[0]), e[0]), e[1], e[2],
                        torch.where(neg, fe.neg(e[3]), e[3])])


def signed_table(neg_a: torch.Tensor) -> torch.Tensor:
    """The chain's table: entry 0 the identity, entry 1 -A, entry j =
    entry j-1 + (-A) by add_x4 with entry 1's operand."""
    n = neg_a.shape[-1]
    op = operand_x4(neg_a, torch.zeros(n, dtype=torch.bool))
    entries = [_threads(ed.identity(n, CPU)), neg_a]
    for _ in range(2, 9):
        entries.append(add_x4(entries[-1], op))
    return torch.stack(entries)


def chain_x4(neg_a: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """x4_chain: the table, then the windows from the top digit down:
    the top entry, then 4 doublings and a signed add a window."""
    table = signed_table(neg_a)
    top = digits.shape[0] - 1
    m = entry_x4(table, digits[top])
    for w in range(top - 1, -1, -1):
        for _ in range(4):
            m = double_x4(m)
        d = digits[w]
        m = add_x4(m, operand_x4(entry_x4(table, d.abs()), d < 0))
    return m


def r_warp_sums(start: ed.Point, comb_entries, live) -> dict:
    """The R warp's slot-0 point for each C in COMB_WARPS: `start` plus
    the comb warps' partial sums in warp order, comb warp c summing
    windows [64c/C, 64(c+1)/C) from the identity (dead lanes sum
    nothing). comb_entries[w]: window w's (x, y, xy) per lane."""
    n = start.x.shape[-1]
    out = {}
    for c_warps in COMB_WARPS:
        acc = start
        for part in range(c_warps):
            p = ed.identity(n, CPU)
            for w in range(part * 64 // c_warps, (part + 1) * 64 // c_warps):
                q = ed.add_z1(p, *comb_entries[w])
                p = ed.Point(*(torch.where(live[None], a, b)
                               for a, b in zip(q, p)))
            acc = ed.add(acc, p)
        out[c_warps] = acc
    return out


# -- K4 --------------------------------------------------------------------


def _seed(i: int) -> bytes:
    return hashlib.sha256(b"gen-order-%d" % i).digest()


def _torsion_lanes(msgs=None):
    """(pub, msg, sig, expected) lanes: A = aB + T8 or R = rB + T8 (both
    valid under the cofactored check), a bad S on each, and the two
    non-canonical identity keys with a good and a bad S; lane k signs
    msgs[k] when msgs (ten messages) are given."""
    t8 = ref.to_extended(ref.decompress(T8))
    a = ref._clamp(hashlib.sha512(_seed(0)).digest())
    a_pt = ref.base_mult(a)
    plain_key = ref.compress(ref.from_extended(a_pt))
    torsion_key = ref.compress(ref.from_extended(ref.pt_add(a_pt, t8)))
    lanes = []
    for i in range(6):
        msg = msgs[i] if msgs else b"torsion lane %d" % i
        r = int.from_bytes(hashlib.sha256(msg).digest(), "little") % ref.L
        r_pt = ref.base_mult(r)
        key = torsion_key if i % 2 else plain_key
        if not i % 2:
            r_pt = ref.pt_add(r_pt, t8)
        r_enc = ref.compress(ref.from_extended(r_pt))
        k = int.from_bytes(hashlib.sha512(r_enc + key + msg).digest(),
                           "little") % ref.L
        s = (r + k * a) % ref.L
        good = i < 4
        lanes.append((key, msg, r_enc + (s if good else s ^ 1).to_bytes(
            32, "little"), good))
    for j, key in enumerate(NONCANONICAL_KEYS):  # A is the identity
        s = 1000 + j
        r_enc = ref.compress(ref.from_extended(ref.base_mult(s)))
        for good in (True, False):
            msg = (msgs[6 + 2 * j + (not good)] if msgs
                   else b"noncanonical key %d" % j)
            lanes.append((key, msg,
                          r_enc + (s + (not good)).to_bytes(32, "little"),
                          good))
    return lanes


def _sqrt_m1_branch(enc: bytes) -> bool:
    """Whether ZIP-215 decompression of enc takes x * sqrt(-1)."""
    p = ref.P
    y = int.from_bytes(enc, "little") & ((1 << 255) - 1)
    u, v = (y * y - 1) % p, (ref.D * y * y + 1) % p
    x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
    return (v * x * x + u) % p == 0


@pytest.fixture(scope="module")
def k4_lanes():
    b = vectors.adversarial_batch(8, 44, seed=17)
    lanes = [(b["pubkeys"][k], m, s, bool(e)) for k, m, s, e in
             zip(b["idx"], b["msgs"], b["sigs"], b["expect"])]
    lanes += _torsion_lanes()
    lanes = [t for t in lanes if len(t[2]) == 64]  # what K4 receives
    assert any(_sqrt_m1_branch(t[0]) for t in lanes)
    assert any(not _sqrt_m1_branch(t[0]) and ref.decompress(t[0])
               for t in lanes)
    pubs, msgs, sigs, expect = (list(x) for x in zip(*lanes))
    packed = tv.pack_batch(pubs, msgs, sigs)
    t = tv.to_device(packed, CPU)
    args = (t["ab"], t["sb"], t["msg"], t["nblocks"], t["s_ok"],
            tv._btab(CPU))
    return dict(pubs=pubs, msgs=msgs, sigs=sigs, expect=expect, args=args,
                plain=tv.general_verify_plain(*args))


def k4_digits(ab, sb, msg, nblocks, live) -> torch.Tensor:
    """The digits warp: k's 69 signed digits LSB first (0 for a dead
    lane)."""
    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    nib = sc.fold_digest(sh.digest_bytes_le(digest)).flip(0)
    return torch.where(live[None], sc.recode_signed(nib), 0)


def k4_model(ab, sb, msg, nblocks, s_ok, btab) -> dict:
    """K4's verdicts for each C in COMB_WARPS, in the block's order."""
    live = s_ok.clone()
    digits = k4_digits(ab, sb, msg, nblocks, live)
    a_pt, a_ok = ed.decompress_bytes(ab.to(torch.int64).T)
    m = chain_x4(_threads(ed.neg(a_pt)), digits)
    s_rows = sb.to(torch.int64).T
    r_pt, r_ok = ed.decompress_bytes(s_rows[:32])
    ident = ed.identity(ab.shape[0], CPU)
    start = ed.Point(*(torch.where(live[None], a, b)
                       for a, b in zip(ed.neg(r_pt), ident)))
    s_nib = sc.bytes_to_nibbles(s_rows[32:])
    comb = [ed.select_const(btab[w], s_nib[w]) for w in range(64)]
    out = {}
    for c_warps, off in r_warp_sums(start, comb, live).items():
        v = add_x4(m, operand_x4(_threads(off), torch.zeros_like(live)))
        for _ in range(3):
            v = double_x4(v)
        out[c_warps] = (ed.is_identity(_point(v)) & a_ok & (r_ok & live)
                        & live)
    return out


def test_chain_ops_equal_double_and_add(k4_lanes):
    ab = k4_lanes["args"][0]
    a_pt, _ok = ed.decompress_bytes(ab.to(torch.int64).T)
    p = _threads(ed.neg(a_pt))
    q = _threads(ed.double(ed.neg(a_pt)))
    neg = torch.arange(ab.shape[0]) % 3 == 0
    for _ in range(4):
        assert torch.equal(double_x4(p), _threads(ed.double(_point(p))))
        signed_q = _point(torch.stack([
            torch.where(neg[None], fe.neg(q[0]), q[0]), q[1], q[2],
            torch.where(neg[None], fe.neg(q[3]), q[3])]))
        got = add_x4(p, operand_x4(q, neg))
        assert torch.equal(got, _threads(ed.add(_point(p), signed_q)))
        p, q = got, double_x4(q)


def test_signed_table_is_the_16_entry_tables_first_nine(k4_lanes):
    ab = k4_lanes["args"][0]
    n = ab.shape[0]
    a_pt, _ok = ed.decompress_bytes(ab.to(torch.int64).T)
    table = signed_table(_threads(ed.neg(a_pt)))
    assert torch.equal(table, ed.build_window_table(ed.neg(a_pt), 16)[:9])
    for d in range(1, 9):
        pos = _point(entry_x4(table, torch.full((n,), d)))
        neg = _point(entry_x4(table, torch.full((n,), -d)))
        assert bool(ed.is_identity(ed.add(pos, neg)).all())


def test_k4_digits_equal_reference_fold(k4_lanes):
    ab, sb, msg, nblocks, s_ok, _btab = k4_lanes["args"]
    full = torch.cat([sb[:, :32], ab, msg], dim=1)
    digest = sh.digest_bytes_le(sh.compress_blocks(sh.bytes_to_words(full),
                                                   nblocks))
    want = np.asarray(jsc.fold_digest(digest.numpy()))
    assert np.array_equal(sc.fold_digest(digest).numpy(), want)
    digits = k4_digits(ab, sb, msg, nblocks, torch.ones_like(s_ok))
    assert int(digits.abs().max()) <= 8 and int(digits[-1].min()) >= 0
    weights = [16**w for w in range(69)]
    nib = torch.from_numpy(want).flip(0)
    for lane in range(ab.shape[0]):
        assert sum(int(d) * w for d, w in zip(digits[:, lane], weights)) == \
            sum(int(x) * w for x, w in zip(nib[:, lane], weights))


def test_k4_order_verdicts_equal_plain_and_reference(k4_lanes):
    plain = k4_lanes["plain"]
    oracle = [jref.verify(*t) for t in zip(k4_lanes["pubs"], k4_lanes["msgs"],
                                           k4_lanes["sigs"])]
    assert plain.tolist() == oracle == k4_lanes["expect"]
    assert not all(oracle) and any(oracle)
    models = k4_model(*k4_lanes["args"])
    assert sorted(models) == list(COMB_WARPS)
    for c_warps, got in models.items():
        assert torch.equal(got, plain), c_warps


# -- K9 --------------------------------------------------------------------


def k9_digits(kdig: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The digits warp: the 64 nibbles recoded, with the carry out of
    window 63 as digit 64 (0 for a dead lane)."""
    nib = torch.cat([kdig.to(torch.int64) & 15,
                     torch.zeros((5, kdig.shape[1]), dtype=torch.int64)])
    digits = sc.recode_signed(nib)
    assert not bool(digits[65:].any())
    return torch.where(live[None], digits[:65], 0)


def _value(digits) -> list[int]:
    return [sum(int(d) << (4 * w) for w, d in enumerate(col))
            for col in digits.T]


def test_k9_recode_keeps_k_and_carries_nothing_below_l():
    rng = np.random.default_rng(29)
    ks = [0, 1, 7, 8, 15, ref.L - 1, ref.L - 2, (ref.L - 1) // 16 * 16 + 8,
          2**252, 2**252 - 1]
    ks += [int.from_bytes(rng.bytes(32), "little") % ref.L
           for _ in range(48)]
    kdig = torch.from_numpy(jsv._nibbles(ks, len(ks)).astype(np.uint8))
    assert torch.equal(kdig, torch.from_numpy(sv._nibbles(ks, len(ks))))
    assert int(kdig[63].max()) <= 1
    digits = k9_digits(kdig, torch.ones(len(ks), dtype=torch.bool))
    assert not bool(digits[64].any())
    assert int(digits.abs().max()) <= 8
    assert _value(digits) == ks
    # any 64 nibbles (k >= 2^255): the carry is kept as digit 64
    big = [2**256 - 1, 15 << 252, 8 << 252]
    digits = k9_digits(torch.from_numpy(sv._nibbles(big, 3)),
                       torch.ones(3, dtype=torch.bool))
    assert digits[64].tolist() == [1, 1, 1] and _value(digits) == big


@pytest.fixture(scope="module")
def k9_lanes():
    b = vectors.sr_adversarial_batch(2 * len(vectors.SR_KINDS), seed=31)
    packed, wf = sv.pack_batch_sr(b["pubs"], b["msgs"], b["sigs"])
    t = tv.to_device(packed, CPU)
    args = (t["ab"], t["rb"], t["kdig"], t["sdig"], t["a_pre"], t["r_pre"],
            t["s_ok"], sv.comb_table(CPU))
    return dict(b, args=args, well_formed=wf, plain=sv.sr_verify_plain(*args))


def k9_model(ab, rb, kdig, sdig, a_pre, r_pre, s_ok, btab) -> dict:
    """K9's verdicts for each C in COMB_WARPS, in the block's order."""
    n = ab.shape[0]
    live = s_ok & a_pre & r_pre
    p2, ok2 = rs.decode(sv.encoding_limbs(ab, rb), torch.cat([a_pre, r_pre]))
    a_pt = ed.Point(*(c[:, :n] for c in p2))
    r_pt = ed.Point(*(c[:, n:] for c in p2))
    a_ok, r_ok = ok2[:n], ok2[n:] & live
    m = chain_x4(_threads(ed.neg(a_pt)), k9_digits(kdig, live))
    sd = sdig.to(torch.int64) & 15
    comb = [ed.select_const(btab[w], sd[w]) for w in range(64)]
    out = {}
    for c_warps, off in r_warp_sums(ed.identity(n, CPU), comb,
                                   live).items():
        v = add_x4(m, operand_x4(_threads(off), torch.zeros_like(live)))
        out[c_warps] = rs.equal(_point(v), r_pt) & a_ok & r_ok & live
    return out


def test_k9_order_verdicts_equal_plain_and_reference(k9_lanes):
    plain = k9_lanes["plain"]
    wf = torch.from_numpy(k9_lanes["well_formed"])
    oracle = [jsr.verify(*t) for t in zip(k9_lanes["pubs"], k9_lanes["msgs"],
                                          k9_lanes["sigs"])]
    assert (plain & wf).tolist() == oracle == k9_lanes["expect"].tolist()
    assert set(k9_lanes["kinds"]) == set(vectors.SR_KINDS)
    models = k9_model(*k9_lanes["args"])
    assert sorted(models) == list(COMB_WARPS)
    for c_warps, got in models.items():
        assert torch.equal(got, plain), c_warps
