"""Port parity: the f32 field's plain version
(tendermint_tpu_torch/crypto/cuda/field_f32.py, the arithmetic of
csrc/field_f32.cuh) against the reference's
tendermint_tpu/crypto/tpu/field_f32.py, op by op, on
tests/test_tpu_field.py's inputs: random REDUCED limbs, the all-max
REDUCED patterns, canonical's signed edges, the mul chain, and the
f32-against-i32 differential (here against the port's own i32 field).

Both field modules are imported directly, not through the selector, so
this file runs in the default (i32) process. Tolerance: 0 — the two
keep the same layout and carry steps on exact float32 integers, so the
limbs are compared limb for limb, and every value mod p against Python
integers."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import field_f32 as jf
from tendermint_tpu_torch.crypto.cuda import field as fi
from tendermint_tpu_torch.crypto.cuda import field_f32 as pf

P = pf.P
MAX_REP = (1 << (pf.BITS * pf.NLIMB)) - 1


def rand_elems(rng, n):
    """Random REDUCED (32, n) limbs, both signs, and their values."""
    bound = pf.REDUCED_BOUND
    limbs = rng.integers(-(bound - 1), bound, size=(pf.NLIMB, n),
                         dtype=np.int64).astype(np.float32)
    return limbs, jf.from_limbs(limbs)


def adversarial_elems():
    """tests/test_tpu_field.py's near-max patterns for the signed rep:
    every limb at +-680, alternating signs, zeros, 255s, p, 2p or p - 2,
    p +- 1, 1, the largest representable value and 19."""
    b = pf.REDUCED_BOUND - 1
    alt = np.full(pf.NLIMB, b)
    alt[::2] *= -1
    cols = [np.full(pf.NLIMB, b), np.zeros(pf.NLIMB), np.full(pf.NLIMB, 255),
            jf.to_limbs(P), jf.to_limbs(2 * P), jf.to_limbs(P - 1),
            jf.to_limbs(P + 1), jf.to_limbs(1), jf.to_limbs(MAX_REP),
            jf.to_limbs(19), np.full(pf.NLIMB, -b), alt]
    limbs = np.stack(cols, axis=1).astype(np.float32)
    return limbs, jf.from_limbs(limbs)


def port(op, *xs):
    return getattr(pf, op)(*(torch.from_numpy(x) for x in xs)).numpy()


def ref(op, *xs):
    return np.asarray(getattr(jf, op)(*xs))


def assert_reduced(out):
    assert np.abs(out).max() < pf.REDUCED_BOUND


def test_constants_and_layout_match_reference():
    assert (pf.NLIMB, pf.BITS, pf.FOLD, pf.REDUCED_BOUND) == (
        jf.NLIMB, jf.BITS, jf.FOLD, jf.REDUCED_BOUND)
    assert (pf.D, pf.D2, pf.SQRT_M1) == (jf.D, jf.D2, jf.SQRT_M1)


def test_to_from_limbs_roundtrip():
    for v in [0, 1, 19, P - 1, P, P + 1, 2**255 - 1, MAX_REP]:
        limbs = pf.to_limbs(v)
        assert np.array_equal(limbs, jf.to_limbs(v))
        assert pf.from_limbs(limbs) == v
        assert pf.from_limbs(torch.from_numpy(limbs)) == v
    assert torch.equal(pf.const(P + 5, 3, "cpu"),
                       torch.from_numpy(jf.to_limbs(5))[:, None].expand(32, 3))


@pytest.mark.parametrize("op,pyop", [("add", lambda a, b: a + b),
                                     ("sub", lambda a, b: a - b)])
def test_add_sub(op, pyop):
    rng = np.random.default_rng(1234)
    a, av = rand_elems(rng, 64)
    b, bv = rand_elems(rng, 64)
    got = port(op, a, b)
    assert np.array_equal(got, ref(op, a, b))
    assert_reduced(got)
    assert [v % P for v in pf.from_limbs(got)] == [
        pyop(x, y) % P for x, y in zip(av, bv)]


def test_mul_random():
    rng = np.random.default_rng(1235)
    a, av = rand_elems(rng, 128)
    b, bv = rand_elems(rng, 128)
    got = port("mul", a, b)
    assert np.array_equal(got, ref("mul", a, b))
    assert_reduced(got)
    assert [v % P for v in pf.from_limbs(got)] == [
        x * y % P for x, y in zip(av, bv)]


def test_mul_adversarial():
    """Every pair of the all-max patterns: the columns reach 32 * 680^2,
    the edge of float32's exact range."""
    a, av = adversarial_elems()
    n = a.shape[1]
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    aa, bb = a[:, ii.ravel()], a[:, jj.ravel()]
    got = port("mul", aa, bb)
    assert np.array_equal(got, ref("mul", aa, bb))
    assert_reduced(got)
    assert [v % P for v in pf.from_limbs(got)] == [
        av[i] * av[j] % P for i, j in zip(ii.ravel(), jj.ravel())]


def test_sqr_adversarial():
    """The reference squares by doubled cross terms; the port's plain
    version by mul(a, a): the same exact columns, so the same limbs."""
    a, av = adversarial_elems()
    got = port("sqr", a)
    assert np.array_equal(got, ref("sqr", a))
    assert np.array_equal(got, port("mul", a, a))
    assert_reduced(got)
    assert [v % P for v in pf.from_limbs(got)] == [v * v % P for v in av]


def test_canonical():
    a, av = adversarial_elems()
    r, rv = rand_elems(np.random.default_rng(1236), 64)
    for limbs, vals in ((a, av), (r, rv)):
        got = port("canonical", limbs)
        assert np.array_equal(got, ref("canonical", limbs))
        assert pf.from_limbs(got) == [v % P for v in vals]
        assert got.min() >= 0 and got.max() < 256


def test_canonical_signed_edges():
    """tests/test_tpu_field.py:137's values that stress the fold-carry
    convergence: small negatives, +-1 around 0 and p, and 1 - 2^256,
    whose top limb is -256."""
    cases = [-1, -19, -38, -39, 1 - (1 << 256), P - 1, 1, 0]
    cols = []
    for v in cases:
        limbs, x = np.zeros(pf.NLIMB), v
        for i in range(pf.NLIMB - 1):
            limbs[i] = x % 256
            x = (x - x % 256) // 256
        limbs[-1] = x
        cols.append(limbs)
    a = np.stack(cols, axis=1).astype(np.float32)
    got = port("canonical", a)
    assert np.array_equal(got, ref("canonical", a))
    assert pf.from_limbs(got) == [v % P for v in cases]


def test_eq_is_zero_parity():
    a, av = adversarial_elems()
    r, rv = rand_elems(np.random.default_rng(1237), 32)
    both = np.concatenate([a, r], axis=1)
    vals = av + rv
    shifted = port("add", both, np.stack([pf.to_limbs(P)] * len(vals), 1))
    assert np.array_equal(port("eq", both, shifted), ref("eq", both, shifted))
    assert port("eq", both, shifted).all()
    assert port("is_zero", both).tolist() == [v % P == 0 for v in vals]
    assert np.array_equal(port("is_zero", both), ref("is_zero", both))
    assert port("parity", both).tolist() == [v % P & 1 for v in vals]
    assert np.array_equal(port("parity", both), ref("parity", both))
    one, p1 = pf.const(1, 4, "cpu"), pf.const(P + 1, 4, "cpu")
    assert pf.eq(one, p1).all() and pf.is_zero(pf.const(P, 3, "cpu")).all()


def test_neg():
    a, av = rand_elems(np.random.default_rng(1238), 32)
    got = port("neg", a)
    assert np.array_equal(got, ref("neg", a))
    assert [v % P for v in pf.from_limbs(got)] == [-v % P for v in av]


def test_pow_2_252_m3():
    a, av = rand_elems(np.random.default_rng(1239), 16)
    got = port("pow_2_252_m3", a)
    assert np.array_equal(got, ref("pow_2_252_m3", a))
    e = (1 << 252) - 3
    assert [v % P for v in pf.from_limbs(got)] == [pow(v % P, e, P)
                                                   for v in av]


def test_mul_chain_stability():
    """50 squarings in a row stay REDUCED and equal the reference's
    limbs at every step (tests/test_tpu_field.py:194)."""
    a, av = rand_elems(np.random.default_rng(1240), 8)
    x, jx, v = torch.from_numpy(a), a, list(av)
    for _ in range(50):
        x, jx = pf.sqr(x), np.asarray(jf.sqr(jx))
        assert np.array_equal(x.numpy(), jx)
        v = [t * t % P for t in v]
    assert_reduced(x.numpy())
    assert [t % P for t in pf.from_limbs(x)] == v


def test_f32_matches_i32_differential():
    """The port's two fields agree mul for mul on canonical values
    (tests/test_tpu_field.py:236, with the port's own i32 field)."""
    rng = np.random.default_rng(1241)
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % P
            for _ in range(32)]
    vals += [0, 1, P - 1, P - 2, 2**255 - 20]
    n = len(vals)
    other = [vals[(i + 7) % n] for i in range(n)]

    def limbs(mod, xs):
        return torch.stack([torch.from_numpy(mod.to_limbs(v)) for v in xs], 1)

    m_i = fi.from_limbs(fi.canonical(fi.mul(limbs(fi, vals), limbs(fi, other))))
    m_f = pf.from_limbs(pf.canonical(pf.mul(limbs(pf, vals), limbs(pf, other))))
    assert m_i == m_f == [x * y % P for x, y in zip(vals, other)]
    by = torch.from_numpy(np.stack(
        [np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals], 1)
        .astype(np.int64))
    assert pf.from_limbs(pf.limbs_from_bytes(by)) == fi.from_limbs(
        fi.limbs_from_bytes(by)) == vals
