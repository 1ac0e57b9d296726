"""Port parity: field, SHA-512 and challenge folding.

The port's plain PyTorch versions (tendermint_tpu_torch/crypto/cuda,
the same arithmetic as the CUDA kernels) against the JAX reference
(tendermint_tpu/crypto/tpu) and hashlib, on the same numpy-seeded
inputs. Tolerance: exact — canonical field values equal mod p,
digests and nibbles identical, decompression verdicts identical."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.tpu import edwards as jed
from tendermint_tpu.crypto.tpu import field as jf
from tendermint_tpu.crypto.tpu import scalar as jsc
from tendermint_tpu.crypto.tpu import sha512 as jsh
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import edwards as ed
from tendermint_tpu_torch.crypto.cuda import field as fe
from tendermint_tpu_torch.crypto.cuda import scalar as sc
from tendermint_tpu_torch.crypto.cuda import sha512 as sh

P = fe.P
EDGE = [0, 1, 2, 19, P - 1, P, P + 1, 2**255 - 20, 2**255 - 1, 2**254]


def _values(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    rnd = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(n)]
    return EDGE + rnd


def _port(vals) -> torch.Tensor:
    return torch.stack([torch.from_numpy(fe.to_limbs(v)) for v in vals], 1)


def _jax(vals):
    return jnp.asarray(np.stack([jf.to_limbs(v) for v in vals], 1))


def _port_ints(t) -> list[int]:
    return [v % P for v in fe.from_limbs(fe.canonical(t))]


def _jax_ints(t) -> list[int]:
    return [v % P for v in jf.from_limbs(np.asarray(jf.canonical(t)))]


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg",
                                "canonical", "pow_2_252_m3"])
def test_field_ops_match_reference(op):
    a, b = _values(1, 40), _values(2, 40)[::-1]
    pa, pb, ja, jb = _port(a), _port(b), _jax(a), _jax(b)
    if op in ("mul", "add", "sub"):
        got = getattr(fe, op)(pa, pb)
        want = getattr(jf, op)(ja, jb)
    elif op == "canonical":
        got, want = pa, ja
    else:
        got, want = getattr(fe, op)(pa), getattr(jf, op)(ja)
    assert _port_ints(got) == _jax_ints(want)
    assert int(got.abs().max()) < 2**26  # LOOSE output bound


def test_canonical_is_unique_representative():
    vals = _values(3, 40)
    got = fe.from_limbs(fe.canonical(_port(vals)))
    assert got == [v % P for v in vals]


def test_mul_at_loose_bound_matches_integers():
    """Limbs at the edge of LOOSE (|limb| < 2^26, both signs): the int64
    columns must not overflow, and canonical must still reduce."""
    rng = np.random.default_rng(4)
    lim = (1 << 26) - 1
    f = rng.integers(-lim, lim + 1, (10, 64), dtype=np.int64)
    g = rng.integers(-lim, lim + 1, (10, 64), dtype=np.int64)
    f[:, :2] = lim
    g[:, :2] = lim
    f[:, 2] = -lim
    g[:, 2] = -lim
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    want = [x * y % P for x, y in zip(fe.from_limbs(f), fe.from_limbs(g))]
    got = fe.mul(tf, tg)
    assert fe.from_limbs(fe.canonical(got)) == want


def _encodings() -> list[bytes]:
    encs = [
        (1).to_bytes(32, "little"),                     # identity
        (1 | 1 << 255).to_bytes(32, "little"),          # x = 0, sign 1
        (P + 1).to_bytes(32, "little"),                 # y >= p
        (P - 1).to_bytes(32, "little"),                 # order 2
        bytes(32),                                      # order 4
        (2**255 - 1).to_bytes(32, "little"),
        vectors.undecodable_encoding(),
    ]
    for i in range(20):
        s = hashlib.sha256(b"enc%d" % i).digest()
        encs.append(ref.public_key_from_seed(s))
        encs.append(hashlib.sha256(b"rnd%d" % i).digest())
    return encs


def test_decompress_matches_reference_and_oracle():
    encs = _encodings()
    rows = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)
    pt, ok = ed.decompress_bytes(torch.from_numpy(rows.copy()).to(torch.int64).T)
    jb = jnp.asarray(rows.astype(np.int32).T)
    jy = jf.limbs_from_bytes(jnp.concatenate([jb[:31], (jb[31] & 0x7F)[None]]))
    jpt, jok = jed.decompress(jy, jb[31] >> 7)
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok.tolist() == [ref.decompress(e) is not None for e in encs]
    for coord in ("x", "y", "z", "t"):
        assert _port_ints(getattr(pt, coord)) == _jax_ints(getattr(jpt, coord))
    for i, e in enumerate(encs):
        if ok[i]:
            x, y = ref.decompress(e)
            assert (_port_ints(pt.x)[i], _port_ints(pt.y)[i]) == (x, y)


def test_compress_blocks_matches_reference_and_hashlib():
    rng = np.random.default_rng(5)
    msgs = [rng.bytes(int(n)) for n in
            [0, 1, 111, 112, 239, 240, 300, 500] + list(rng.integers(0, 400, 24))]
    pad, nblocks = sh.pad_messages(msgs)
    jpad, jnb = jsh.pad_messages(msgs)
    assert np.array_equal(pad, jpad) and np.array_equal(nblocks, jnb)
    state = sh.compress_blocks(sh.bytes_to_words(torch.from_numpy(pad)),
                               torch.from_numpy(nblocks))
    got = sh.digest_bytes_le(state).T.numpy().astype(np.uint8)
    jstate = jsh.compress_blocks(jsh.bytes_to_words(jnp.asarray(pad)),
                                 jnp.asarray(nblocks))
    want = np.asarray(jsh.digest_bytes_le(jstate)).T.astype(np.uint8)
    assert np.array_equal(got, want)
    for m, row in zip(msgs, got):
        assert bytes(row) == hashlib.sha512(m).digest()


def test_fold_digest_nibbles_match_reference():
    rng = np.random.default_rng(6)
    dig = rng.integers(0, 256, (64, 48), dtype=np.int64)
    dig[:, 0] = 255
    dig[:, 1] = 0
    got = sc.fold_digest(torch.from_numpy(dig)).numpy()
    want = np.asarray(jsc.fold_digest(jnp.asarray(dig.astype(np.int32))))
    assert np.array_equal(got, want)
    # the nibbles spell k' = digest (mod L), below 2^271
    for lane in range(dig.shape[1]):
        k = int("".join("%x" % v for v in got[:, lane]), 16)
        d = int.from_bytes(bytes(dig[:, lane].astype(np.uint8)), "little")
        assert k % ref.L == d % ref.L and k < 1 << 271


def test_from_radix12_reencodes_reference_limbs():
    vals = _values(7, 30)
    j = np.stack([jf.to_limbs(v) for v in vals])  # (N, 22)
    # a redundant (non-exact) 12-bit form of the same values
    j2 = j.copy()
    j2[:, 1:21] -= 1
    j2[:, 0:20] += 4096
    got = fe.from_radix12(np.stack([j, j2]))
    for k in range(2):
        assert fe.from_limbs(got[k].T) == [v % P for v in vals]
