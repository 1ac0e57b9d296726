"""Node identity (reference: p2p/key.py; Go p2p/key.go).

A node's identity is an ed25519 key; its ID is the lowercase hex of
the pubkey's 20-byte address. The key persists as JSON so a node keeps
its identity across restarts.
"""

from __future__ import annotations

import json
import os

from ..crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey


def node_id_from_pubkey(pub: Ed25519PubKey) -> str:
    return pub.address().hex()


class NodeKey:
    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @property
    def pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    @property
    def id(self) -> str:
        return node_id_from_pubkey(self.pub_key)

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.generate())

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls.generate()
        nk.save(path)
        return nk

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        """Accepts repo flat-hex AND the reference's tmjson node key
        (p2p/key.go: {'priv_key': {'type': 'tendermint/PrivKeyEd25519',
        'value': base64}}) — node identity migrates unchanged."""
        from ..crypto import ed25519_privkey_from_json

        with open(path) as f:
            d = json.load(f)
        return cls(ed25519_privkey_from_json(d["priv_key"], "node"))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({"type": "ed25519",
                       "priv_key": self.priv_key.bytes().hex()}, f)
        os.replace(tmp, path)
