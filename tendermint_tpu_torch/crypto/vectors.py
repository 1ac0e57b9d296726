"""Deterministic test material: an ed25519 batch covering the ZIP-215
edge cases, signed with ed25519_ref, and an sr25519 batch covering
schnorrkel's rejections and every branch of the ristretto decode and
equality, signed with the bulk signer ``sr_sign_batch``."""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from . import ed25519_ref as ref
from ..types.sign_batch import StructuredSignBytes


def _challenge(r_enc: bytes, pub: bytes, msg: bytes) -> int:
    return int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(),
                          "little") % ref.L


@functools.cache
def undecodable_encoding() -> bytes:
    """The smallest y whose encoding ZIP-215 decompression rejects."""
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


# Lane kinds of the adversarial batch and whether ZIP-215 accepts them.
KINDS = {
    "valid": True,
    "bad_sig": False,         # one bit of S flipped
    "wrong_msg": False,       # signed over another message
    "s_ge_l": False,          # S + L: non-canonical S
    "noncanon_r": True,       # R = identity encoded as y = p + 1
    "r_x0_sign1": True,       # R = identity with sign bit 1 (x = 0)
    "undecodable_r": False,
    "small_order_key": True,  # A of order 4, R = [S]B
    "undecodable_key": False,
    "short_sig": False,       # 63 bytes
    "long_sig": False,        # 65 bytes
}
_SMALL_ORDER = bytes(32)  # y = 0: a point of order 4


def adversarial_batch(n_keys: int, n_lanes: int, seed: int = 0,
                      msgs: list[bytes] | None = None) -> dict:
    """A batch over n_keys keys (key 0 undecodable, key 1 of small
    order, the rest valid) whose lanes cycle through KINDS, with
    messages of 0..300 random bytes from a numpy generator seeded by
    `seed` (or the given `msgs`, one per lane). Returns pubkeys, idx
    (key per lane), msgs, sigs, kinds and the expected verdicts."""
    if n_keys < 3:
        raise ValueError("need at least 3 keys")
    rng = np.random.default_rng(seed)
    seeds = [hashlib.sha256(b"adv-%d-%d" % (seed, i)).digest()
             for i in range(n_keys)]
    pubkeys = [undecodable_encoding(), _SMALL_ORDER] + [
        ref.public_key_from_seed(s) for s in seeds[2:]]
    names = list(KINDS)
    idx, lane_msgs, sigs, kinds = [], [], [], []
    for i in range(n_lanes):
        kind = names[i % len(names)]
        if msgs is None:
            msg = rng.integers(0, 256, int(rng.integers(0, 301)),
                               dtype=np.uint8).tobytes()
        else:
            msg = msgs[i]
        if kind == "undecodable_key":
            key = 0
        elif kind == "small_order_key":
            key = 1
        else:
            key = 2 + i % (n_keys - 2)
        pub, sd = pubkeys[key], seeds[key]
        if kind == "small_order_key":
            s = int(rng.integers(1, 1 << 62))
            sig = (ref.compress(ref.from_extended(ref.base_mult(s)))
                   + s.to_bytes(32, "little"))
        elif kind in ("noncanon_r", "r_x0_sign1"):
            y = ref.P + 1 if kind == "noncanon_r" else 1 | (1 << 255)
            r_enc = y.to_bytes(32, "little")
            a = ref._clamp(hashlib.sha512(sd).digest())
            s = _challenge(r_enc, pub, msg) * a % ref.L
            sig = r_enc + s.to_bytes(32, "little")
        else:
            sig = ref.sign(sd, msg + (b"!" if kind == "wrong_msg" else b""))
            if kind == "bad_sig":
                sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
            elif kind == "s_ge_l":
                s = int.from_bytes(sig[32:], "little") + ref.L
                sig = sig[:32] + s.to_bytes(32, "little")
            elif kind == "undecodable_r":
                sig = undecodable_encoding() + sig[32:]
            elif kind == "short_sig":
                sig = sig[:63]
            elif kind == "long_sig":
                sig = sig + b"\0"
        idx.append(key)
        lane_msgs.append(msg)
        sigs.append(sig)
        kinds.append(kind)
    return dict(pubkeys=pubkeys, idx=idx, msgs=lane_msgs, sigs=sigs,
                kinds=kinds, expect=np.array([KINDS[k] for k in kinds]))


class LaneSignBatch(StructuredSignBytes):
    """arena_batch's lanes as a structured batch (one template group,
    per-lane timestamp patches): the form ExpandedKeys.verify_structured
    takes."""

    def __init__(self, b: dict):
        self._msgs = list(b["msgs"])
        self._finish([(b["pre"], b["suf"])], np.zeros(len(self._msgs), np.int32),
                     np.asarray(b["ts"], np.int64))

    def __len__(self) -> int:
        return len(self._msgs)

    def anchor_bytes(self) -> bytes:
        return self._msgs[0]

    def materialize(self) -> list[bytes]:
        return list(self._msgs)


def arena_batch(n_keys: int, n_lanes: int, seed: int = 0) -> dict:
    """adversarial_batch over precommit sign bytes of one (height,
    round, block id) with per-lane timestamps (edge values and random
    ones from a numpy generator seeded by `seed`): the lanes a
    speculation arena carries. Adds ts and the template halves pre/suf
    (types/canonical.py vote_sign_parts)."""
    from ..types import canonical
    from ..types.block import BlockID, PartSetHeader
    from ..types.vote import VoteType

    chain, height, round_ = "arena-chain", 977, 1
    bid = BlockID(bytes(range(32)), PartSetHeader(3, bytes(32)))
    rng = np.random.default_rng(seed)
    edge = [0, 1, 999_999_999, 1_000_000_000, (1 << 63) - 1]
    ts = [edge[i] if i < len(edge)
          else int(rng.integers(1, 1 << 62)) for i in range(n_lanes)]
    vt = int(VoteType.PRECOMMIT)
    msgs = [canonical.vote_sign_bytes(chain, vt, height, round_, bid, t)
            for t in ts]
    out = adversarial_batch(n_keys, n_lanes, seed, msgs=msgs)
    pre, suf = canonical.vote_sign_parts(chain, vt, height, round_, bid)
    out.update(ts=ts, pre=pre, suf=suf)
    return out


# -- sr25519 -----------------------------------------------------------


def sr_sign_batch(minis, msgs, ctx: bytes = b"") -> list[bytes]:
    """sr25519_ref.sign over many (mini, msg) pairs: each key expanded
    and its public key computed once, [r]B by ed25519_ref's comb and
    every challenge in one sr25519_challenges pass (the signing
    transcript is the verifying one). The same bytes as sign."""
    from . import sr25519_ref as sr
    from .merlin_batch import sr25519_challenges

    keys = {}
    for mini in minis:
        if mini not in keys:
            key, nonce = sr.expand_ed25519(mini)
            keys[mini] = (key, nonce, sr.ristretto_encode(ref.base_mult(key)))
    n = len(minis)
    rs = [sr.nonce_scalar(keys[mi][1], keys[mi][2], m, ctx)
          for mi, m in zip(minis, msgs)]
    big_rs = [sr.ristretto_encode(ref.base_mult(r)) for r in rs]
    pubs = np.frombuffer(b"".join(keys[mi][2] for mi in minis),
                         np.uint8).reshape(n, 32)
    r_rows = np.frombuffer(b"".join(big_rs), np.uint8).reshape(n, 32)
    ks = sr25519_challenges(pubs, list(msgs), r_rows, ctx)
    return [sr.finish_signature(big_r, int(k), keys[mi][0], r)
            for big_r, k, mi, r in zip(big_rs, ks, minis, rs)]


def ratio_branch(enc: bytes) -> str:
    """Which test of SQRT_RATIO_M1 holds in the ristretto decode of a
    canonical encoding: "correct", "flipped", "flipped_i" (v r^2 = u,
    -u, -u sqrt(-1)) or "none" (v r^2 = u sqrt(-1))."""
    p = ref.P
    s = int.from_bytes(enc, "little")
    u1, u2 = (1 - s * s) % p, (1 + s * s) % p
    v = (-(ref.D * u1 * u1) - u2 * u2) * u2 * u2 % p
    v3 = v * v * v % p
    r = v3 * pow(v3 * v3 * v % p, (p - 5) // 8, p) % p
    check = v * r * r % p
    return {1: "correct", p - 1: "flipped",
            (p - 1) * ref.SQRT_M1 % p: "flipped_i"}.get(check, "none")


def equal_branch(pub: bytes, msg: bytes, sig: bytes, ctx: bytes = b""):
    """For a well-formed lane: which of ristretto equality's tests hold
    between V = [s]B - [k]A and decode(R) — "xy" (X1 Y2 = Y1 X2), "yy"
    (Y1 Y2 = X1 X2), "both" or "none" — by the integer oracle."""
    from . import sr25519_ref as sr

    a, r = sr.ristretto_decode(pub), sr.ristretto_decode(sig[:32])
    k = sr.challenge(pub, sig[:32], msg, ctx)
    s = int.from_bytes(sig[32:], "little") & ((1 << 255) - 1)
    v = ref.pt_add(ref.base_mult(s), ref.scalar_mult(k, ref.pt_neg(a)))
    xy = (v[0] * r[1] - v[1] * r[0]) % ref.P == 0
    yy = (v[1] * r[1] - v[0] * r[0]) % ref.P == 0
    return {(True, False): "xy", (False, True): "yy",
            (True, True): "both"}.get((xy, yy), "none")


@functools.cache
def _failing_encoding(want: str) -> bytes:
    """The smallest even canonical encoding whose ristretto decode
    fails in the named way: "flipped_i" / "none" (not a square) or
    "odd_t" (a square, but x*y is odd)."""
    from . import sr25519_ref as sr

    s = 2
    while True:
        enc = s.to_bytes(32, "little")
        branch = ratio_branch(enc)
        if sr.ristretto_decode(enc) is None and (
                branch == want or (want == "odd_t" and branch in
                                   ("correct", "flipped"))):
            return enc
        s += 2


# Lane kinds of the sr25519 adversarial batch and whether schnorrkel
# accepts them.
SR_KINDS = {
    "valid": True,
    "eq_xy": True,            # V, R meet X1*Y2 == Y1*X2 only
    "eq_yy": True,            # V, R meet Y1*Y2 == X1*X2 only
    "a_correct": True,        # A's decode takes sqrt_ratio's correct test
    "a_flipped": True,        # A's decode takes the flipped test
    "s_zero": False,
    "wrong_msg": False,
    "r_identity": False,      # R = the identity's encoding
    "marker_off": False,
    "noncanon_key": False,    # A = 0xff...ff (>= p)
    "odd_r": False,           # R's encoding odd (non-canonical)
    "s_eq_l": False,          # s = L with the marker bit on
    "nonsquare_key": False,   # A's decode: flipped_i (not a square)
    "nonsquare_r": False,     # R's decode: neither test (not a square)
    "odd_t_r": False,         # R's decode: a square but x*y odd
    "short_key": False,       # 31 bytes
    "short_sig": False,       # 63 bytes
}


def sr_adversarial_batch(n: int, seed: int = 0) -> dict:
    """n sr25519 lanes cycling through SR_KINDS, over a small pool of
    keys ordered so that key 0's decode takes sqrt_ratio's correct test
    and key 1's the flipped one, with messages of 0..300 random bytes
    from a numpy generator seeded by `seed`. eq_xy / eq_yy lanes append
    a counter to their message until the oracle sees that branch.
    Returns pubs, msgs, sigs, kinds and the expected verdicts."""
    from . import sr25519_ref as sr

    rng = np.random.default_rng(seed)
    pool = [hashlib.sha256(b"sr-adv-%d-%d" % (seed, i)).digest()
            for i in range(8)]
    pool_pubs = [sr.public_key_from_mini(m) for m in pool]
    first = {}
    for i, pub in enumerate(pool_pubs):
        first.setdefault(ratio_branch(pub), i)
    order = [first["correct"], first["flipped"]]
    order += [i for i in range(len(pool)) if i not in order]
    minis = [pool[i] for i in order]
    names = list(SR_KINDS)
    kinds = [names[i % len(names)] for i in range(n)]
    lane_keys = [0 if kind == "a_correct" else 1 if kind == "a_flipped"
                 else 2 + i % (len(minis) - 2) for i, kind in enumerate(kinds)]
    msgs = [rng.integers(0, 256, int(rng.integers(0, 301)),
                         dtype=np.uint8).tobytes() for _ in range(n)]
    sign_msgs = [m + b"!" if k == "wrong_msg" else m
                 for m, k in zip(msgs, kinds)]
    sigs = sr_sign_batch([minis[k] for k in lane_keys], sign_msgs)
    pubs = [sr.public_key_from_mini(m) for m in minis]
    lane_pubs = []
    for i, kind in enumerate(kinds):
        pub, sig = pubs[lane_keys[i]], sigs[i]
        if kind in ("eq_xy", "eq_yy"):
            want, base = kind[3:], msgs[i]
            for j in range(64):
                if equal_branch(pub, msgs[i], sig) == want:
                    break
                msgs[i] = base + b"#%d" % j
                sig = sr_sign_batch([minis[lane_keys[i]]], [msgs[i]])[0]
            else:
                raise RuntimeError(f"no {kind} lane found")
        elif kind == "s_zero":
            sig = sig[:32] + bytes(31) + b"\x80"
        elif kind == "r_identity":
            sig = bytes(32) + sig[32:]
        elif kind == "marker_off":
            sig = sig[:63] + bytes([sig[63] & 0x7F])
        elif kind == "noncanon_key":
            pub = b"\xff" * 32
        elif kind == "odd_r":
            sig = bytes([sig[0] | 1]) + sig[1:]
        elif kind == "s_eq_l":
            s_eq_l = bytearray(ref.L.to_bytes(32, "little"))
            s_eq_l[31] |= 0x80
            sig = sig[:32] + bytes(s_eq_l)
        elif kind == "nonsquare_key":
            pub = _failing_encoding("flipped_i")
        elif kind == "nonsquare_r":
            sig = _failing_encoding("none") + sig[32:]
        elif kind == "odd_t_r":
            sig = _failing_encoding("odd_t") + sig[32:]
        elif kind == "short_key":
            pub = pub[:31]
        elif kind == "short_sig":
            sig = sig[:63]
        lane_pubs.append(pub)
        sigs[i] = sig
    return dict(pubs=lane_pubs, msgs=msgs, sigs=sigs, kinds=kinds,
                expect=np.array([SR_KINDS[k] for k in kinds]))
