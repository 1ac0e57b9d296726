"""Example apps (reference: abci/kvstore.py; Go
abci/example/kvstore/kvstore.go:66, persistent_kvstore.go:27,108).

KVStoreApp: in-memory "key=value" store; app hash = 8-byte big-endian
tx count (matching the reference's size-as-apphash trick).
PersistentKVStoreApp adds durable state, height tracking for crash
replay (the Handshaker relies on Info.last_block_height), validator
updates via "val:<pubkey-hex>!<power>" txs, and statesync snapshots.
MerkleKVStoreApp makes the app hash a merkle root over the kv pairs and
answers `query(prove=True)` with the proof ops of abci/kv_proofs.py,
which the light proxy's verified abci_query checks.
"""

from __future__ import annotations

import json
import struct

from ..crypto import merkle
from ..libs.db import DB, MemDB
from . import types as t

VALIDATOR_TX_PREFIX = b"val:"
_STATE_KEY = b"__appstate__"


def encode_validator_tx(pub_key_hex: str, power: int) -> bytes:
    return VALIDATOR_TX_PREFIX + f"{pub_key_hex}!{power}".encode()


class KVStoreApp(t.Application):
    """DeliverTx applies immediately (reference kvstore.go behavior —
    queries see uncommitted writes, as the abci-cli goldens capture)
    but every write is journaled, and BeginBlock ROLLS BACK any
    journal left by a block that never reached Commit. This makes
    block replay idempotent: if a node dies mid-block while its
    external app process lives on (observed: a graceful restart
    interrupting delivery — randomized campaign seed 131), the
    handshake's BeginBlock for the same height undoes the
    half-applied writes instead of double-applying them — the
    deliverState-reset semantics production ABCI apps implement."""

    def __init__(self):
        self.db: DB = MemDB()
        self.size = 0
        self.height = 0
        self.app_hash = b""
        self._undo: list[tuple[bytes, bytes | None]] = []
        self._committed_size = 0

    def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return t.ResponseInfo(
            data=json.dumps({"size": self.size}),
            version="kvstore/1",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        return t.ResponseCheckTx(code=t.CODE_TYPE_OK, gas_wanted=1)

    def _rollback_partial(self) -> None:
        if not self._undo:
            return
        for k, old in reversed(self._undo):
            if old is None:
                self.db.delete(k)
            else:
                self.db.set(k, old)
        self._undo.clear()
        self.size = self._committed_size

    def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        self._rollback_partial()
        return t.ResponseBeginBlock()

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        key, sep, value = req.tx.partition(b"=")
        if not sep:
            key = value = req.tx
        k = b"kv:" + key
        self._undo.append((k, self.db.get(k)))
        self.db.set(k, value)
        self.size += 1
        return t.ResponseDeliverTx(
            code=t.CODE_TYPE_OK,
            events=[{
                "type": "app",
                "attributes": [
                    {"key": "creator", "value": "kvstore"},
                    {"key": "key", "value": key.decode(errors="replace")},
                ],
            }],
        )

    def _mark_committed(self) -> None:
        """Seal the journal: current state is now the rollback point.
        Called at Commit AND after a statesync restore (a stale
        journal replayed into freshly restored state would corrupt
        it)."""
        self._undo.clear()
        self._committed_size = self.size

    def commit(self, req: t.RequestCommit) -> t.ResponseCommit:
        self._mark_committed()
        self.app_hash = struct.pack(">Q", self.size)
        self.height += 1
        return t.ResponseCommit(data=self.app_hash)

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        v = self.db.get(b"kv:" + req.data)
        return t.ResponseQuery(
            key=req.data,
            value=v or b"",
            log="exists" if v is not None else "does not exist",
            height=self.height,
        )


class PersistentKVStoreApp(KVStoreApp):
    """Adds persistence + validator-update txs + snapshots."""

    SNAPSHOT_CHUNK_SIZE = 1 << 16

    def __init__(self, db: DB | None = None, snapshot_interval: int = 0,
                 keep_snapshots: int = 4):
        super().__init__()
        self.db = db or MemDB()
        self.val_updates: list[t.ValidatorUpdate] = []
        self._undo_vals: list[tuple[str, int | None]] = []
        self.validators: dict[str, int] = {}  # pubkey hex -> power
        self.retain_blocks = 0
        # taken every snapshot_interval heights, last keep_snapshots
        # retained (reference: test/e2e/app snapshot_interval); 0 =
        # advertise only the live head state
        self.snapshot_interval = snapshot_interval
        self.keep_snapshots = keep_snapshots
        st = self.db.get(_STATE_KEY)
        if st is not None:
            d = json.loads(st)
            self.size = d["size"]
            self.height = d["height"]
            self.app_hash = bytes.fromhex(d["app_hash"])
            self.validators = d.get("validators", {})
            self._mark_committed()

    def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        for vu in req.validators:
            self._update_validator(vu)
        return t.ResponseInitChain()

    def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        super().begin_block(req)  # roll back any half-applied kv block
        for hx, old in reversed(self._undo_vals):
            if old is None:
                self.validators.pop(hx, None)
            else:
                self.validators[hx] = old
        self._undo_vals.clear()
        self.val_updates = []
        return t.ResponseBeginBlock()

    def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        if req.tx.startswith(VALIDATOR_TX_PREFIX):
            return self._deliver_validator_tx(req.tx)
        return super().deliver_tx(req)

    def _deliver_validator_tx(self, tx: bytes) -> t.ResponseDeliverTx:
        body = tx[len(VALIDATOR_TX_PREFIX):]
        pk_hex, _, power_s = body.partition(b"!")
        try:
            pub_key = bytes.fromhex(pk_hex.decode())
            power = int(power_s)
            if len(pub_key) != 32 or power < 0:
                raise ValueError
        except ValueError:
            return t.ResponseDeliverTx(
                code=1, log=f"invalid validator tx {tx!r}"
            )
        vu = t.ValidatorUpdate("ed25519", pub_key, power)
        # journaled like the kv writes: a replayed half-block rolls
        # the set back before re-applying
        self._undo_vals.append(
            (pub_key.hex(), self.validators.get(pub_key.hex())))
        self._update_validator(vu)
        self.val_updates.append(vu)
        return t.ResponseDeliverTx(code=t.CODE_TYPE_OK)

    def _update_validator(self, vu: t.ValidatorUpdate) -> None:
        hx = vu.pub_key.hex()
        if vu.power == 0:
            self.validators.pop(hx, None)
        else:
            self.validators[hx] = vu.power

    def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return t.ResponseEndBlock(validator_updates=self.val_updates)

    def _compute_app_hash(self) -> bytes:
        return struct.pack(">Q", self.size)

    def _mark_committed(self) -> None:
        super()._mark_committed()
        self._undo_vals.clear()

    def commit(self, req: t.RequestCommit) -> t.ResponseCommit:
        self._mark_committed()
        self.app_hash = self._compute_app_hash()
        self.height += 1
        self.db.set(_STATE_KEY, json.dumps({
            "size": self.size,
            "height": self.height,
            "app_hash": self.app_hash.hex(),
            "validators": self.validators,
        }).encode())
        if self.snapshot_interval and \
                self.height % self.snapshot_interval == 0:
            self.db.set(b"snap:%016x" % self.height,
                        self._snapshot_payload())
            snaps = [k for k, _ in self.db.iterate_prefix(b"snap:")]
            for k in snaps[:-self.keep_snapshots]:
                self.db.delete(k)
        resp = t.ResponseCommit(data=self.app_hash)
        if self.retain_blocks > 0 and self.height > self.retain_blocks:
            resp.retain_height = self.height - self.retain_blocks
        return resp

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "/val":
            hx = req.data.decode()
            power = self.validators.get(hx, 0)
            return t.ResponseQuery(key=req.data, value=str(power).encode())
        return super().query(req)

    # -- snapshots: one snapshot of the full kv state per height kept --

    def _snapshot_payload(self) -> bytes:
        kvs = {
            k.hex(): v.hex()
            for k, v in self.db.iterate_prefix(b"kv:")
        }
        return json.dumps({
            "kvs": kvs, "size": self.size, "height": self.height,
            "app_hash": self.app_hash.hex(), "validators": self.validators,
        }, sort_keys=True).encode()

    def _stored_snapshots(self) -> list[tuple[int, bytes]]:
        out = [(int(k[len(b"snap:"):], 16), v)
               for k, v in self.db.iterate_prefix(b"snap:")]
        if not out and self.height > 0:
            out = [(self.height, self._snapshot_payload())]
        return out

    def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        from ..crypto import tmhash

        snaps = []
        for height, payload in self._stored_snapshots():
            n = max(1, -(-len(payload) // self.SNAPSHOT_CHUNK_SIZE))
            snaps.append(t.Snapshot(height, 1, n, tmhash.sum256(payload)))
        return t.ResponseListSnapshots(snaps)

    def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        payload = None
        for height, p in self._stored_snapshots():
            if height == req.height:
                payload = p
                break
        if payload is None:
            return t.ResponseLoadSnapshotChunk(b"")
        start = req.chunk * self.SNAPSHOT_CHUNK_SIZE
        return t.ResponseLoadSnapshotChunk(
            payload[start : start + self.SNAPSHOT_CHUNK_SIZE]
        )

    def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        if req.snapshot is None or req.snapshot.format != 1:
            return t.ResponseOfferSnapshot(t.OfferSnapshotResult.REJECT_FORMAT)
        self._restore_chunks: list[bytes] = []
        self._restore_senders: list[str] = []
        self._restore_snapshot = req.snapshot
        return t.ResponseOfferSnapshot(t.OfferSnapshotResult.ACCEPT)

    def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        from ..crypto import tmhash

        self._restore_chunks.append(req.chunk)
        self._restore_senders.append(req.sender)
        if len(self._restore_chunks) < self._restore_snapshot.chunks:
            return t.ResponseApplySnapshotChunk(t.ApplySnapshotChunkResult.ACCEPT)
        payload = b"".join(self._restore_chunks)
        if tmhash.sum256(payload) != self._restore_snapshot.hash:
            # The assembled payload is not what the advertised hash
            # promised: at least one chunk is poisoned. Never parse it.
            # When every chunk came from ONE sender the app can convict
            # it by name (reject_senders); otherwise attribution is the
            # syncer's job (single-source retries) and the app just
            # asks for a snapshot retry with its partial state cleared.
            senders = {s for s in self._restore_senders if s}
            self._restore_chunks = []
            self._restore_senders = []
            return t.ResponseApplySnapshotChunk(
                t.ApplySnapshotChunkResult.RETRY_SNAPSHOT,
                reject_senders=sorted(senders) if len(senders) == 1
                else [])
        d = json.loads(payload)
        ops: list[tuple[bytes, bytes | None]] = [
            (bytes.fromhex(k), bytes.fromhex(v)) for k, v in d["kvs"].items()
        ]
        self.size = d["size"]
        self.height = d["height"]
        self.app_hash = bytes.fromhex(d["app_hash"])
        self.validators = d["validators"]
        # restored state is the new rollback point; a stale journal
        # from a block interrupted before the restore must never
        # replay into it
        self._mark_committed()
        ops.append((_STATE_KEY, json.dumps({
            "size": self.size, "height": self.height,
            "app_hash": self.app_hash.hex(), "validators": self.validators,
        }).encode()))
        self.db.write_batch(ops)
        return t.ResponseApplySnapshotChunk(t.ApplySnapshotChunkResult.ACCEPT)


class MerkleKVStoreApp(PersistentKVStoreApp):
    """Proof-capable kvstore: the app hash is an RFC-6962 merkle root
    over the kv pairs sorted by key, and `query(prove=True)` returns
    value/absence proof ops verifiable against a light-verified
    header's app_hash (the capability the reference's light RPC
    client consumes, light/rpc/client.go:104-151 — its example apps
    delegate the proof format to the application, as here; formats in
    abci/kv_proofs.py). Rebuilds the tree per commit — O(n log n) per
    block, fine for an example app."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # Snapshot at construction: nothing is mid-block yet, so the
        # db IS the committed state (a lazy first-query rebuild could
        # race a half-applied block and cache an unprovable tree).
        self._snapshot_committed()

    def _sorted_pairs(self) -> list[tuple[bytes, bytes]]:
        return sorted(
            (k[len(b"kv:"):], v) for k, v in self.db.iterate_prefix(b"kv:")
        )

    def _snapshot_committed(self) -> bytes:
        """Queries must prove against the last COMMITTED state —
        deliver_tx writes the live db mid-block, and a proof over
        half-applied state matches no header's app_hash. The proof
        tree is built once here, not per query."""
        from . import kv_proofs

        self._committed_pairs = self._sorted_pairs()
        root, proofs = merkle.proofs_from_byte_slices(
            [kv_proofs.kv_leaf(k, v) for k, v in self._committed_pairs])
        self._committed_proofs = proofs
        return root

    def _compute_app_hash(self) -> bytes:
        return self._snapshot_committed()

    def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        if req.path == "/val" or not req.prove:
            return super().query(req)
        from . import kv_proofs

        pairs, proofs = self._committed_pairs, self._committed_proofs
        keys = [k for k, _ in pairs]
        import bisect

        j = bisect.bisect_left(keys, req.data)
        total = len(pairs)
        if j < total and keys[j] == req.data:
            op = kv_proofs.KVValueOp.encode(req.data, total, proofs[j])
            value, log = pairs[j][1], "exists"
        else:
            left = (pairs[j - 1][0], pairs[j - 1][1], proofs[j - 1]) \
                if j > 0 else None
            right = (pairs[j][0], pairs[j][1], proofs[j]) \
                if j < total else None
            op = kv_proofs.KVAbsenceOp.encode(req.data, total, left, right)
            value, log = b"", "does not exist"
        return t.ResponseQuery(
            key=req.data, value=value, log=log, height=self.height,
            proof_ops=[op],
        )

    def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        resp = super().apply_snapshot_chunk(req)
        if len(self._restore_chunks) >= self._restore_snapshot.chunks:
            self._snapshot_committed()  # restored db is the new state
        return resp
