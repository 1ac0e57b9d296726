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
