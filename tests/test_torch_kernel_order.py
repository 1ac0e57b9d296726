"""Plain models of the order in which K1 and K3/K5 spread their work
over threads, against the port's plain versions and the JAX reference
on the CPU.

- K1 (csrc/build_tables.cu) builds a table in two launches: a chain of
  doublings, four threads a key (each product of a doubling's round on
  its own thread), stores each window's base as entry 1; then one
  thread a (key, window) row adds the base seven times. The model does
  the same in that order and must equal ``build_tables_plain`` limb for
  limb, and the reference's tables mod p.
- K3/K5 (csrc/xverify_lane.cuh) split a lane's windows over W warps:
  -R starts warp 1's sum, warps 2..W-1 sum the comb windows of [S]B and
  warps 0, 2..W-1 the [k]A windows, in contiguous slices; the W partial
  sums meet in a tree (warp w + h into warp w, h = W/2 .. 1). The model
  does the same for W in WARPS and its verdicts must equal
  ``xverify_plain``'s and the reference's, on the adversarial batch plus
  lanes whose R or A carry an order-8 torsion part and keys encoded
  non-canonically.
- ``field.sqr`` takes symmetric column sums (csrc/field.cuh fe_sqr) and
  must equal ``field.mul(a, a)`` limb for limb.
- The named barriers in the sources' inline PTX are the non-aligned
  ``barrier.arrive`` / ``barrier.sync``: each is reached from two role
  branches (K3/K5's barrier 1, K4/K9/K7's barriers 1 and 2).

Tolerance: exact (limbs, verdicts); mod p against the reference's
tables, whose limbs are another radix."""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import expanded as jex
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import edwards as ed
from tendermint_tpu_torch.crypto.cuda import expanded as ex
from tendermint_tpu_torch.crypto.cuda import field
from tendermint_tpu_torch.crypto.cuda import scalar as sc
from tendermint_tpu_torch.crypto.cuda import sha512 as sh
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import set_default_device

N_KEYS = 128
SEED = 11
WARPS = (1, 2, 4, 8, 16)
CPU = torch.device("cpu")
# A point of order 8 (the standard list of ed25519's small-order points).
T8 = bytes.fromhex(
    "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")
# Keys whose encodings are not canonical: y = p + 1 (the identity) and
# x = 0 with the sign bit set (y = 1, the identity).
NONCANONICAL_KEYS = ((ref.P + 1).to_bytes(32, "little"),
                     (1 | 1 << 255).to_bytes(32, "little"))


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _seed(i: int) -> bytes:
    return hashlib.sha256(b"adv-%d-%d" % (SEED, i)).digest()


def _point(enc: bytes):
    return ref.to_extended(ref.decompress(enc))


def _torsion_lanes(keys: list[bytes]):
    """Lanes valid under the cofactored check whose R or A carries T8,
    lanes on the non-canonical keys, and one bad lane of each kind: key
    index, message, signature, expected verdict. Appends the torsion
    key to `keys`."""
    t8 = _point(T8)
    assert ref.is_identity(ref.scalar_mult(8, t8))
    assert not ref.is_identity(ref.scalar_mult(4, t8))
    a = ref._clamp(hashlib.sha512(_seed(2)).digest())
    keys.append(ref.compress(ref.from_extended(
        ref.pt_add(ref.base_mult(a), t8))))
    lanes = []
    for i in range(6):
        msg = b"torsion lane %d" % i
        r = int.from_bytes(hashlib.sha256(msg).digest(), "little") % ref.L
        r_pt = ref.base_mult(r)
        if i % 2:  # A = aB + T8, R = rB
            key = len(keys) - 1
        else:      # A = aB, R = rB + T8
            key = 2
            r_pt = ref.pt_add(r_pt, t8)
        r_enc = ref.compress(ref.from_extended(r_pt))
        k = int.from_bytes(hashlib.sha512(r_enc + keys[key] + msg).digest(),
                           "little") % ref.L
        s = (r + k * a) % ref.L
        good = i < 4
        sig = r_enc + (s if good else s ^ 1).to_bytes(32, "little")
        lanes.append((key, msg, sig, good))
    for j, enc in enumerate(NONCANONICAL_KEYS):  # A is the identity
        keys.append(enc)
        s = 1000 + j
        sig = ref.compress(ref.from_extended(ref.base_mult(s))) + \
            s.to_bytes(32, "little")
        lanes.append((len(keys) - 1, b"noncanonical key %d" % j, sig, True))
        lanes.append((len(keys) - 1, b"noncanonical key %d" % j,
                      sig[:32] + (s + 1).to_bytes(32, "little"), False))
    return lanes


@pytest.fixture(scope="module")
def batch():
    b = vectors.adversarial_batch(N_KEYS, 96, seed=SEED)
    keys = list(b["pubkeys"])
    extra = _torsion_lanes(keys)
    return dict(pubkeys=keys,
                idx=b["idx"] + [k for k, _, _, _ in extra],
                msgs=b["msgs"] + [m for _, m, _, _ in extra],
                sigs=b["sigs"] + [s for _, _, s, _ in extra],
                expect=np.concatenate([b["expect"],
                                       [g for _, _, _, g in extra]]))


@pytest.fixture(scope="module")
def ref_keys(batch):
    return jex.ExpandedKeys(batch["pubkeys"])


@pytest.fixture(scope="module")
def port_keys(batch):
    set_default_device("cpu")
    try:
        return ex.ExpandedKeys(batch["pubkeys"])
    finally:
        set_default_device(None)


# -- K1 -------------------------------------------------------------------


def _double_x4(p: ed.Point) -> ed.Point:
    """dbl-2008-hwcd as K1's chain runs it on a key's four threads: round
    one's products (thread q: X^2, Y^2, Z^2, (X + Y)^2), the sums every
    thread forms from them, round two's (X = ef, Y = gh, Z = fg,
    T = eh)."""
    fe = ex.fe
    ops = (p.x, p.y, p.z, fe.add(p.x, p.y))
    a, b, t, u = (fe.sqr(o) for o in ops)
    c = fe.add(t, t)
    h = fe.add(a, b)
    e = fe.sub(h, u)
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return ed.Point(*(fe.mul(m1, m2) for m1, m2 in ((e, f), (g, h), (f, g),
                                                    (e, h))))


def k1_two_phase(akeys: torch.Tensor):
    """K1's order: the chain stores base_w = 16^w (-A) as entry (w, 1),
    window after window; then each (key, window) row, a lane of its
    own, takes entry 0 = identity and entries 2..8 by adding its stored
    base."""
    fe = ex.fe
    v = akeys.shape[0]
    pt, ok = ed.decompress_bytes(akeys.to(torch.int64).T)
    tables = torch.zeros((v, 69, 9, 4, fe.NLIMB), dtype=fe.TABLE_DTYPE)
    base = ed.neg(pt)
    for w in range(69):
        if w:
            for _ in range(4):
                base = _double_x4(base)
        tables[:, w, 1] = torch.stack(list(base)).permute(2, 0, 1)
    rows = tables[:, :, 1].reshape(v * 69, 4, fe.NLIMB).permute(1, 2, 0)
    b = ed.Point(*rows.to(fe.DTYPE).unbind(0))
    entries = {0: ed.identity(v * 69, CPU)}
    e = b
    for j in range(2, 9):
        e = ed.add(e, b)
        entries[j] = e
    for j, pt_j in entries.items():
        tables[:, :, j] = torch.stack(list(pt_j)).permute(2, 0, 1).reshape(
            v, 69, 4, fe.NLIMB)
    return tables, ok


@pytest.fixture(scope="module")
def two_phase(port_keys):
    return k1_two_phase(port_keys.akeys)


def test_chain_doubling_on_four_threads_equals_double(port_keys):
    fe = ex.fe
    pt, _ok = ed.decompress_bytes(port_keys.akeys.to(torch.int64).T)
    p = ed.neg(pt)
    for _ in range(5):
        q = _double_x4(p)
        assert all(torch.equal(x, y) for x, y in zip(q, ed.double(p)))
        p = q
    assert p.x.dtype == fe.DTYPE


def test_k1_two_phase_equals_plain_limb_for_limb(port_keys, two_phase):
    tab, ok = two_phase
    plain_tab, plain_ok = ex.build_tables_plain(port_keys.akeys)
    assert torch.equal(tab, plain_tab)
    assert torch.equal(ok, plain_ok)
    assert torch.equal(tab, port_keys.tables)
    assert ok.tolist()[:2] == [False, True]
    assert ok.tolist()[-2:] == [True, True]  # the non-canonical keys


def test_k1_two_phase_equals_reference_mod_p(batch, ref_keys, two_phase):
    fe = ex.fe
    tab, ok = two_phase
    n = len(batch["pubkeys"])
    ref_tab = np.asarray(ref_keys.tables)
    conv = field.from_radix12(ref_tab[:, :88].reshape(n, 69, 9, 4, 22))
    canon = fe.canonical(tab.reshape(-1, fe.NLIMB).T.to(fe.DTYPE))
    assert np.array_equal(canon.T.reshape(conv.shape).numpy(), conv)
    assert ok.tolist() == np.asarray(ref_keys.key_ok).tolist()


# -- K3 / K5 ----------------------------------------------------------------


def _slice(part: int, parts: int, n: int) -> range:
    return range(part * n // parts, (part + 1) * n // parts)


def xverify_warps(warps: int, idx, akeys, sb, msg, nblocks, s_ok, key_ok,
                  tables, btab) -> torch.Tensor:
    """xverify_plain's function in the block body's order for `warps`
    warps (csrc/xverify_lane.cuh): -R starts the R warp's sum (warp 1;
    warp 0 when there is one warp), the comb warps (2..W-1; warp 0 below
    three warps) sum contiguous slices of the 64 comb windows, the other
    warps (all but the R warp; warp 0 alone below two) contiguous slices
    of the 69 [k]A windows; then the tree, x8, the identity check."""
    fe = ex.fe
    n = idx.shape[0]
    ki = idx.to(torch.int64)
    full = torch.cat([sb[:, :32], akeys[ki], msg], dim=1)
    digest = sh.compress_blocks(sh.bytes_to_words(full), nblocks)
    digk = sc.recode_signed(sc.fold_digest(sh.digest_bytes_le(digest)).flip(0))
    s_rows = sb.to(torch.int64).T
    digs = sc.bytes_to_nibbles(s_rows[32:])
    r_pt, r_ok = ed.decompress_bytes(s_rows[:32])

    def a_entry(w):
        e = tables[ki, w, digk[w].abs()].to(fe.DTYPE).permute(1, 2, 0)
        neg = (digk[w] < 0)[None]
        return ed.Point(torch.where(neg, fe.neg(e[0]), e[0]), e[1], e[2],
                        torch.where(neg, fe.neg(e[3]), e[3]))

    r_warp = min(1, warps - 1)
    comb_warps = list(range(2, warps)) or [0]
    a_warps = [w for w in range(warps) if w != r_warp] or [0]
    acc = [ed.identity(n, CPU) for _ in range(warps)]
    acc[r_warp] = ed.neg(r_pt)
    for c, w in enumerate(comb_warps):
        for win in _slice(c, len(comb_warps), 64):
            acc[w] = ed.add_z1(acc[w], *ed.select_const(btab[win], digs[win]))
    for m, w in enumerate(a_warps):
        for win in _slice(m, len(a_warps), 69):
            acc[w] = ed.add(acc[w], a_entry(win))
    half = warps // 2
    while half:
        for w in range(half):
            acc[w] = ed.add(acc[w], acc[w + half])
        half //= 2
    v = acc[0]
    for _ in range(3):
        v = ed.double(v)
    return ed.is_identity(v) & r_ok & s_ok & key_ok[ki]


@pytest.fixture(scope="module")
def lane_args(batch, port_keys):
    idx, packed, well_formed = port_keys._prepare(
        batch["idx"], batch["msgs"], batch["sigs"])
    t = tv.to_device(dict(packed, idx=idx), CPU)
    args = (t["idx"], port_keys.akeys, t["sb"], t["msg"], t["nblocks"],
            t["s_ok"], port_keys.key_ok, port_keys.tables, tv._btab(CPU))
    return args, well_formed


@pytest.fixture(scope="module")
def plain_verdicts(lane_args):
    return ex.xverify_plain(*lane_args[0])


def test_plain_and_reference_agree_on_torsion_lanes(batch, ref_keys,
                                                    lane_args, plain_verdicts):
    n = len(batch["idx"])
    got = plain_verdicts.numpy()[:n] & lane_args[1]
    want = ref_keys.verify(batch["idx"], batch["msgs"], batch["sigs"])
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == batch["expect"].tolist()
    oracle = [ref.verify(batch["pubkeys"][k], m, s)
              for k, m, s in zip(batch["idx"], batch["msgs"], batch["sigs"])]
    assert got.tolist() == oracle


@pytest.mark.parametrize("warps", WARPS)
def test_warp_partition_verdicts_equal_plain(warps, batch, lane_args,
                                             plain_verdicts):
    got = xverify_warps(warps, *lane_args[0])
    assert torch.equal(got, plain_verdicts)
    n = len(batch["idx"])
    assert (got.numpy()[:n] & lane_args[1]).tolist() == \
        batch["expect"].tolist()


# -- the symmetric squaring -------------------------------------------------


def _loose_chain(rng, n: int) -> torch.Tensor:
    """Limbs after chains of add and sub of carried values: LOOSE, near
    the (-2^26, 2^26) bounds."""
    def rand():
        return field.carry(torch.from_numpy(
            rng.integers(-(1 << 40), 1 << 40, size=(10, n))))

    x = rand()
    for k in range(12):
        x = field.add(x, rand()) if k % 3 else field.sub(x, rand())
    x[:, : n // 4] = (1 << 26) - 1
    x[1::2, n // 4: n // 2] = -(1 << 25) + 1
    x[::2, n // 4: n // 2] = -(1 << 26) + 1
    return x


@pytest.mark.parametrize("kind", ["random", "loose_chain"])
def test_symmetric_sqr_equals_mul(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        a = torch.from_numpy(rng.integers(-(1 << 26) + 1, 1 << 26,
                                          size=(10, 4096)))
    else:
        a = _loose_chain(rng, 4096)
    assert int(a.abs().max()) < 1 << 26
    assert torch.equal(field.sqr(a), field.mul(a, a))


def test_named_barriers_are_non_aligned():
    """The PTX ISA leaves an aligned bar.arrive / bar.sync undefined when
    the threads of a CTA reach it through different instructions, as
    the role branches of csrc/xverify_lane.cuh and csrc/verify_x4.cuh
    reach their named barriers: no inline PTX in csrc/ may use the
    aligned forms, and both headers use the non-aligned ones."""
    csrc = Path(ex.__file__).resolve().parents[2] / "csrc"
    asm = {f.name: re.findall(r'asm\s+volatile\s*\(\s*"([^"]*)"',
                              f.read_text())
           for f in csrc.iterdir() if f.suffix in (".cu", ".cuh")}
    aligned = {name: ops for name, ops in asm.items()
               if any(re.match(r"\s*bar\.", op) for op in ops)}
    assert not aligned
    for name in ("xverify_lane.cuh", "verify_x4.cuh"):
        ops = [op.split()[0] for op in asm[name]]
        assert sorted(set(ops)) == ["barrier.arrive", "barrier.sync"], name
