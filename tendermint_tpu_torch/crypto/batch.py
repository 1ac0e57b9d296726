"""BatchVerifier: accumulate (pubkey, msg, sig) triples and verify them
as one wide batch with per-lane verdicts.

Per-lane verdicts are load-bearing: evidence handling must know which
signature failed, and one bad vote must not poison the others. Lanes
are grouped by key type. An ed25519 group of ``_DEVICE_THRESHOLD`` or
more runs the general kernel (K4, crypto/cuda/verify.py); an sr25519
group of ``_DEVICE_THRESHOLD_SR`` or more runs the sr25519 group
equation (K9, crypto/cuda/sr_verify.py) after the host's Merlin
challenges; smaller groups verify on the host, key by key. A device
failure raises: the port has no breaker and no host degrade yet (nor
the reference's CPU-compiled sr25519 path that comes with them).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from . import PubKey

# Below this many sigs, host verification beats a launch (the
# reference's crossover, kept so both route at the same points).
_DEVICE_THRESHOLD = 40
# sr25519 has no OpenSSL fast path: the host oracle costs milliseconds
# a signature, so its device crossover is a handful of lanes (the
# reference's value).
_DEVICE_THRESHOLD_SR = 4


@functools.cache
def _ed_probe_triple() -> tuple[bytes, bytes, bytes]:
    """A fixed known-answer (pub, msg, sig): the reference's breaker
    probe triple, carried by the speculation arena's sentinel lane 0."""
    from . import ed25519_ref as edr

    seed = hashlib.sha256(b"tendermint_tpu ed25519 breaker probe").digest()
    msg = b"breaker probe"
    return edr.public_key_from_seed(seed), msg, edr.sign(seed, msg)


def host_verify(items) -> np.ndarray:
    """Per-lane verdicts of (pub_key, msg, sig) triples on the host: the
    per-key verify (ed25519: OpenSSL strict accept, else the ZIP-215
    oracle, crypto/ed25519.py; sr25519: the oracle, crypto/sr25519.py)."""
    return np.fromiter(
        (len(s) == 64 and pk.verify_signature(m, s) for pk, m, s in items),
        bool, count=len(items))


class BatchVerifier:
    """Accumulate signatures, verify them all at once.

    Usage:
        bv = BatchVerifier()
        bv.add(pk, msg, sig)
        all_ok, lane_ok = bv.verify()
    """

    def __init__(self):
        self._items: list[tuple[PubKey, bytes, bytes]] = []

    def __len__(self) -> int:
        return len(self._items)

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        self._items.append((pub_key, msg, sig))

    def verify(self) -> tuple[bool, np.ndarray]:
        """Returns (all_valid, per-lane verdicts in add order)."""
        n = len(self._items)
        if n == 0:
            return True, np.zeros(0, bool)
        verdicts = np.zeros(n, bool)
        by_type: dict[str, list[int]] = {}
        for i, (pk, _, _) in enumerate(self._items):
            by_type.setdefault(pk.type_name, []).append(i)
        for type_name, idxs in by_type.items():
            items = [self._items[i] for i in idxs]
            verdicts[np.asarray(idxs)] = self._verify_group(type_name, items)
        return bool(verdicts.all()), verdicts

    def _verify_group(self, type_name, items) -> np.ndarray:
        if type_name == "ed25519" and len(items) >= _DEVICE_THRESHOLD:
            from .cuda.verify import verify_batch as device_verify
        elif type_name == "sr25519" and len(items) >= _DEVICE_THRESHOLD_SR:
            from .cuda.sr_verify import verify_batch_sr as device_verify
        else:
            return host_verify(items)
        return device_verify([pk.bytes() for pk, _, _ in items],
                             [m for _, m, _ in items],
                             [s for _, _, s in items])
