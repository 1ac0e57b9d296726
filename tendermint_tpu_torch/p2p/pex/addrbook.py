"""Persisted peer address book (reference: p2p/pex/addrbook.py; Go
p2p/pex/addrbook.go). The JSON file is the reference's: a book saved
by either package loads in the other.

The reference keeps addresses in hashed old/new buckets to resist
poisoning: an attacker feeding us addresses can only influence a
bounded slice of the book, and addresses only graduate to "old"
(trusted) after a successful connection. Same design here, with the
bucket index keyed by a per-book random salt.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass

NEW_BUCKETS = 256
OLD_BUCKETS = 64
BUCKET_SIZE = 64


@dataclass
class KnownAddress:
    addr: str                       # "id@host:port"
    src: str = ""                   # node id that told us
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"        # "new" | "old"

    def to_json(self) -> dict:
        return {"addr": self.addr, "src": self.src,
                "attempts": self.attempts,
                "last_attempt": self.last_attempt,
                "last_success": self.last_success,
                "bucket_type": self.bucket_type}

    @classmethod
    def from_json(cls, d: dict) -> "KnownAddress":
        return cls(**d)

    @property
    def node_id(self) -> str:
        return self.addr.split("@", 1)[0] if "@" in self.addr else ""

    def is_bad(self) -> bool:
        """Too many failed attempts with no success (addrbook isBad)."""
        return self.attempts >= 3 and self.last_success == 0


class AddrBook:
    def __init__(self, path: str | None = None, salt: bytes | None = None):
        self.path = path
        self.salt = salt or os.urandom(8)
        self._addrs: dict[str, KnownAddress] = {}    # node_id -> ka
        self._our_ids: set[str] = set()
        if path and os.path.exists(path):
            self._load()

    def add_our_address(self, node_id: str) -> None:
        self._our_ids.add(node_id)
        self._addrs.pop(node_id, None)

    def _bucket(self, ka: KnownAddress) -> int:
        h = hashlib.sha256(self.salt + ka.addr.encode()).digest()
        n = int.from_bytes(h[:4], "big")
        return n % (OLD_BUCKETS if ka.bucket_type == "old" else NEW_BUCKETS)

    def add_address(self, addr: str, src: str = "") -> bool:
        nid = addr.split("@", 1)[0] if "@" in addr else ""
        if not nid or nid in self._our_ids:
            return False
        if nid in self._addrs:
            return False
        ka = KnownAddress(addr=addr, src=src)
        # enforce per-bucket capacity: evict the worst "new" entry
        bucket = self._bucket(ka)
        mates = [a for a in self._addrs.values()
                 if a.bucket_type == "new" and self._bucket(a) == bucket]
        if len(mates) >= BUCKET_SIZE:
            worst = max(mates, key=lambda a: (a.is_bad(), a.attempts,
                                              -a.last_success))
            self._addrs.pop(worst.node_id, None)
        self._addrs[nid] = ka
        return True

    def remove_address(self, node_id: str) -> None:
        self._addrs.pop(node_id, None)

    def mark_attempt(self, node_id: str) -> None:
        ka = self._addrs.get(node_id)
        if ka:
            ka.attempts += 1
            ka.last_attempt = time.time()

    def mark_good(self, node_id: str) -> None:
        """Graduate to the old (vetted) buckets (reference MarkGood)."""
        ka = self._addrs.get(node_id)
        if ka:
            ka.attempts = 0
            ka.last_success = time.time()
            ka.bucket_type = "old"

    def mark_bad(self, node_id: str) -> None:
        self._addrs.pop(node_id, None)

    def has(self, node_id: str) -> bool:
        return node_id in self._addrs

    def size(self) -> int:
        return len(self._addrs)

    def is_empty(self) -> bool:
        return not self._addrs

    def pick_address(self, new_bias_pct: int = 30,
                     exclude: set[str] | None = None) -> str | None:
        """Random address, biased between old/new buckets
        (reference PickAddress)."""
        exclude = exclude or set()
        cands = [a for a in self._addrs.values()
                 if a.node_id not in exclude and not a.is_bad()]
        if not cands:
            return None
        old = [a for a in cands if a.bucket_type == "old"]
        new = [a for a in cands if a.bucket_type == "new"]
        pool = new if (random.randrange(100) < new_bias_pct and new) \
            else (old or new)
        return random.choice(pool).addr

    def get_selection(self, n: int = 10) -> list[str]:
        """Random sample to answer a PEX request."""
        cands = [a.addr for a in self._addrs.values() if not a.is_bad()]
        random.shuffle(cands)
        return cands[:n]

    # -- persistence --

    def save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"salt": self.salt.hex(),
                       "addrs": [a.to_json() for a in self._addrs.values()]},
                      f)
        os.replace(tmp, self.path)

    def _load(self) -> None:
        with open(self.path) as f:
            d = json.load(f)
        self.salt = bytes.fromhex(d["salt"])
        for ad in d["addrs"]:
            ka = KnownAddress.from_json(ad)
            if ka.node_id:
                self._addrs[ka.node_id] = ka
