"""Deterministic ed25519 test material: an adversarial batch covering
the ZIP-215 edge cases, signed with ed25519_ref."""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from . import ed25519_ref as ref


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


def adversarial_batch(n_keys: int, n_lanes: int, seed: int = 0) -> dict:
    """A batch over n_keys keys (key 0 undecodable, key 1 of small
    order, the rest valid) whose lanes cycle through KINDS, with
    messages of 0..300 random bytes from a numpy generator seeded by
    `seed`. Returns pubkeys, idx (key per lane), msgs, sigs, kinds and
    the expected verdicts."""
    if n_keys < 3:
        raise ValueError("need at least 3 keys")
    rng = np.random.default_rng(seed)
    seeds = [hashlib.sha256(b"adv-%d-%d" % (seed, i)).digest()
             for i in range(n_keys)]
    pubkeys = [undecodable_encoding(), _SMALL_ORDER] + [
        ref.public_key_from_seed(s) for s in seeds[2:]]
    names = list(KINDS)
    idx, msgs, sigs, kinds = [], [], [], []
    for i in range(n_lanes):
        kind = names[i % len(names)]
        msg = rng.integers(0, 256, int(rng.integers(0, 301)),
                           dtype=np.uint8).tobytes()
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
        msgs.append(msg)
        sigs.append(sig)
        kinds.append(kind)
    return dict(pubkeys=pubkeys, idx=idx, msgs=msgs, sigs=sigs, kinds=kinds,
                expect=np.array([KINDS[k] for k in kinds]))
