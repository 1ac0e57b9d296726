"""The state-sync engine (reference: statesync/syncer.py; Go
statesync/syncer.go).

Pure-ish core: peer IO goes through two callables the reactor wires in
(`request_snapshots(peer)` and `request_chunk(peer_id, snapshot, idx)`)
so the whole flow is unit-testable without sockets. Chunks are held in
memory (a redesign of the reference's temp-file chunkQueue — snapshot
chunks are bounded at 16MB and restore is transient).

Byzantine peers are ATTRIBUTABLE: every chunk records the peer that
supplied it (the provenance feeds `sender=` on ApplySnapshotChunk, so
the app's `reject_senders` channel is live), and a restored-app-hash
mismatch does not reject the snapshot the honest peers are also
serving. Instead the restore RETRIES: the first attempt fetches
round-robin for throughput; after a poisoned attempt, each retry
fetches the full chunk set from ONE peer (rotating deterministically
over the non-quarantined holders), so a failing attempt convicts its
single source by name and a succeeding attempt convicts the original
poisoners by byte-diffing their recorded chunks against the verified
set. Convicted peers are quarantined (pool-banned + behaviour strike);
the snapshot itself is rejected only once RESTORE_ATTEMPTS are
exhausted or no untried peer mix remains — a poisoner costs bandwidth,
never liveness.

Progress records into the reference's statesync family
(libs/metrics.py statesync_metrics) and the consensus family's
state_syncing gauge.

Divergence, the port's rule for its own faults (crypto/batch.py
UNCAUGHT): a KernelError or NoDeviceError raised under the state
provider's light check (or anywhere else in a restore) ends
``sync_any`` with that fault. No snapshot is rejected for it and no
other snapshot is tried. The reference takes a failed light check's
LightClientError as snapshot-local; the port's faults are not
LightClientErrors, and ``sync_any`` re-raises them before that
clause.
"""

from __future__ import annotations

import asyncio
import logging

from ..abci import types as abci
from ..crypto.batch import UNCAUGHT
from ..libs import failpoints
from ..libs.net import jittered_backoff
from ..light.errors import LightClientError
from .snapshots import Snapshot, SnapshotPool

logger = logging.getLogger("statesync")

CHUNK_TIMEOUT = 10.0       # reference chunkTimeout (10s)
DISCOVERY_TIME = 2.0       # reference defaultDiscoveryTime scaled for tests
CHUNK_FETCHERS = 4         # reference cfg.ChunkFetchers
# Per-chunk retry policy: requeued/re-requested chunks back off
# (capped, jittered) instead of re-dialing the instant a peer says
# "missing" — the old immediate retry was a hot request loop against
# peers that just pruned the snapshot. A chunk that exhausts its
# attempts fails the SNAPSHOT (sync_any moves on to a fresher one)
# instead of spinning forever.
CHUNK_RETRIES = 8
CHUNK_BACKOFF_BASE = 0.2
CHUNK_BACKOFF_MAX = 5.0
# Restore attempts per snapshot: the round-robin first try plus up to
# three single-source retries. With one poisoner among >= 2 honest
# holders the second attempt already has a 1/2 chance of an honest
# source and the third is certain (the failing source is quarantined
# between attempts).
RESTORE_ATTEMPTS = 4

def count(name: str, reason: str | None = None, n: int = 1) -> None:
    """Add `n` to a counter of the statesync family (to its `reason`
    label where it is counted by reason)."""
    from ..libs.metrics import statesync_metrics

    c = getattr(statesync_metrics(), name)
    if reason is None:
        c.inc(n)
    else:
        c.inc(n, reason=reason)


def _chunk_backoff(attempt: int) -> float:
    """Capped exponential backoff with jitter for chunk re-requests."""
    return jittered_backoff(max(attempt - 1, 0), CHUNK_BACKOFF_BASE,
                            CHUNK_BACKOFF_MAX)


class StateSyncError(Exception):
    pass


class _AbortSync(StateSyncError):
    pass


class _RejectSnapshot(StateSyncError):
    pass


class _RejectFormat(StateSyncError):
    pass


class _PoisonedRestore(StateSyncError):
    """A restore attempt produced state the trusted app hash refutes
    (or the app itself refused the assembled payload): retryable with
    a different peer mix, never a verdict on the snapshot."""


# Process-global registry for the /status statesync check
# (libs/debugsrv.py consults it via sys.modules.get, so nodes that
# never state-sync pay nothing).
_ACTIVE_SYNCER: "Syncer | None" = None


def active_syncer() -> "Syncer | None":
    return _ACTIVE_SYNCER


class Syncer:
    def __init__(self, app_snapshot_conn, state_provider,
                 request_chunk, discovery_time: float = DISCOVERY_TIME,
                 request_snapshots=None, on_strike=None,
                 chunk_fetchers: int = CHUNK_FETCHERS,
                 chunk_timeout: float = CHUNK_TIMEOUT):
        self.app = app_snapshot_conn
        self.state_provider = state_provider
        self.request_chunk = request_chunk  # async (peer_id, snapshot, idx)
        # sync callable: re-broadcast SnapshotsRequest (re-discovery
        # after a snapshot goes stale under us)
        self.request_snapshots = request_snapshots
        # sync callable (peer_id, reason): route a provable fault to
        # the behaviour reporter (trust strike); wired by the reactor
        self.on_strike = on_strike
        self.discovery_time = discovery_time
        # the chunks in flight at once, and the seconds before a chunk
        # not yet answered is asked again (statesync.chunk_fetchers,
        # statesync.chunk_request_timeout_s)
        self.chunk_fetchers = chunk_fetchers
        self.chunk_timeout = chunk_timeout
        self.pool = SnapshotPool(on_peer_overflow=self._on_pool_overflow)
        self._chunks: dict[int, bytes] = {}
        self._chunk_senders: dict[int, str] = {}
        self._chunk_event = asyncio.Event()
        self._active: Snapshot | None = None
        self._requeue: set[int] = set()  # chunks whose peer said "missing"
        self._quarantined: set[str] = set()
        self.quarantine_kinds: dict[str, int] = {}  # kind -> peers
        self._restore_attempt = 0
        self._applied_count = 0

    # -- inbound from reactor --

    def add_snapshot(self, peer_id: str, snapshot: Snapshot) -> bool:
        new = self.pool.add(peer_id, snapshot)
        if new:
            logger.info("discovered snapshot h=%d format=%d from %s",
                        snapshot.height, snapshot.format, peer_id[:8])
        return new

    def add_chunk(self, msg, peer_id: str = "") -> None:
        if self._active is None or msg.height != self._active.height or \
                msg.format != self._active.format:
            return
        if peer_id and peer_id in self._quarantined:
            return  # a quarantined peer's late chunks are dead on arrival
        if msg.missing:
            # THIS peer advertised the snapshot but no longer has it
            # (pruned while we were verifying/offering — common when
            # the chain outpaces the fetch). Drop only the peer's
            # association; other peers keep serving the snapshot, and
            # the fetch loop re-requests the chunk from them at once.
            # When no peers remain, _fetch_and_apply fails the snapshot
            # and sync_any moves on to a fresher one.
            if peer_id:
                self.pool.remove_peer_snapshot(peer_id, self._active)
            self._requeue.add(msg.index)
            self._chunk_event.set()
            return
        if msg.index in self._chunks:
            return
        if not 0 <= msg.index < self._active.chunks:
            return
        # chaos: `corrupt` delivers garbled chunk bytes — restore must
        # end in a poisoned-attempt retry, never in silently applied
        # garbage
        self._chunks[msg.index] = failpoints.hit("statesync.chunk",
                                                 payload=msg.chunk)
        self._chunk_senders[msg.index] = peer_id
        self._chunk_event.set()

    def remove_peer(self, peer_id: str) -> None:
        self.pool.remove_peer(peer_id)

    # -- quarantine --

    def _on_pool_overflow(self, peer_id: str) -> None:
        self._strike(peer_id, "snapshot advertisement flood")

    def _strike(self, peer_id: str, reason: str) -> None:
        if self.on_strike is None or not peer_id:
            return
        try:
            self.on_strike(peer_id, reason)
        except Exception:  # a broken reporter must not fail the sync
            logger.exception("statesync behaviour strike failed")

    def _quarantine(self, peer_id: str, reason: str,
                    kind: str | None = None) -> None:
        """Ban a provably-lying snapshot peer: evict it from the pool
        (its advertisements and chunks are dead from here) and strike
        its trust score. Quarantine is BY NAME and permanent for this
        syncer's life — visible in /status and
        statesync_peers_quarantined_total; the log names its `kind`
        (the reason by default)."""
        if not peer_id or peer_id in self._quarantined:
            return
        self._quarantined.add(peer_id)
        self.pool.reject_peer(peer_id)
        count("peers_quarantined")
        k = kind or reason
        self.quarantine_kinds[k] = self.quarantine_kinds.get(k, 0) + 1
        logger.warning("statesync peer %s quarantined (%s): %s",
                       peer_id[:8], kind or reason, reason)
        self._strike(peer_id, f"quarantined: {reason}")

    def quarantined_peers(self) -> list[str]:
        return sorted(self._quarantined)

    def status_check(self) -> dict:
        """The /status `statesync` check body (libs/debugsrv.py):
        restore progress + the quarantine ledger. Quarantined peers
        mark the check degraded — the restore is healthy, but an
        active poisoning attempt is something an operator must see."""
        snap = self._active
        c: dict = {
            "status": "ok",
            "height": snap.height if snap is not None else 0,
            "chunks_applied": self._applied_count,
            "chunks_total": snap.chunks if snap is not None else 0,
            "restore_attempt": self._restore_attempt,
            "quarantined_peers": sorted(self._quarantined),
        }
        if self._quarantined:
            c["status"] = "degraded"
            c["detail"] = (f"{len(self._quarantined)} snapshot peer(s) "
                           "quarantined for serving bad data")
        return c

    # -- main flow --

    async def sync_any(self):
        """Try snapshots best-first until one restores and verifies.
        Returns (state, commit) for node bootstrap
        (reference: syncer.go:141 SyncAny)."""
        global _ACTIVE_SYNCER
        _ACTIVE_SYNCER = self
        deadline = asyncio.get_running_loop().time() + self.discovery_time
        while True:
            snapshot = self.pool.best()
            if snapshot is None:
                if asyncio.get_running_loop().time() > deadline:
                    raise StateSyncError("no viable snapshots discovered")
                await asyncio.sleep(0.1)
                continue
            try:
                return await self._sync(snapshot)
            except UNCAUGHT:
                raise  # the port's own fault (module docstring)
            except _AbortSync:
                raise StateSyncError("app aborted state sync")
            except _RejectFormat:
                logger.info("app rejected snapshot format %d",
                            snapshot.format)
                self.pool.reject_format(snapshot.format)
            except _RejectSnapshot:
                logger.info("snapshot h=%d rejected", snapshot.height)
                self.pool.reject(snapshot)
            except (StateSyncError, LightClientError) as e:
                # StateSyncError: chunk fetch/restore failed (e.g. the
                # peer pruned the snapshot under us). LightClientError:
                # the state provider could not — or will no longer,
                # once the trusted head moved past a stale snapshot's
                # height — verify its state. Both are snapshot-local.
                logger.warning("snapshot h=%d failed: %s; trying next",
                               snapshot.height, e)
                self.pool.reject(snapshot)
                if self.request_snapshots is not None:
                    # Peers may have taken fresher snapshots since the
                    # initial discovery; ask again so the pool does not
                    # drain to stale entries.
                    self.request_snapshots()
                    deadline = (asyncio.get_running_loop().time()
                                + self.discovery_time)

    async def _sync(self, snapshot: Snapshot):
        # 1) the app hash we must end up with — light-verified FIRST so
        # an unverifiable height fails before any restore work
        app_hash = await self.state_provider.app_hash(snapshot.height)

        # 2/3) offer + restore, retrying with a rotated peer mix after
        # a poisoned attempt (each re-offer resets the app's partial
        # restore state, so no attempt leaks into the next)
        # failed attempts' provenance: [{index: (bytes, sender)}]
        failed: list[dict[int, tuple[bytes, str]]] = []
        tried_sources: set[str] = set()
        source: str | None = None  # None = round-robin first attempt
        for attempt in range(1, RESTORE_ATTEMPTS + 1):
            self._restore_attempt = attempt
            count("restore_attempts")
            # chaos: a crash here (between discovery and the app
            # accepting the offer) must restart into clean discovery
            failpoints.hit("statesync.offer")
            res = await self.app.offer_snapshot(abci.RequestOfferSnapshot(
                snapshot=abci.Snapshot(
                    height=snapshot.height, format=snapshot.format,
                    chunks=snapshot.chunks, hash=snapshot.hash,
                    metadata=snapshot.metadata),
                app_hash=app_hash))
            self._dispatch_offer_result(res.result)

            self._active = snapshot
            self._chunks = {}
            self._chunk_senders = {}
            self._requeue = set()
            self._applied_count = 0
            try:
                await self._fetch_and_apply(snapshot, source)
                # 4) confirm the restored app
                info = await self.app.info(abci.RequestInfo())
                if info.last_block_height != snapshot.height:
                    raise StateSyncError(
                        f"restored app height {info.last_block_height} "
                        f"!= snapshot height {snapshot.height}")
                if info.last_block_app_hash != app_hash:
                    raise _PoisonedRestore(
                        f"restored app hash "
                        f"{info.last_block_app_hash.hex()} != trusted "
                        f"{app_hash.hex()}")
            except _PoisonedRestore as e:
                failed.append({
                    i: (self._chunks[i], self._chunk_senders.get(i, ""))
                    for i in self._chunks})
                count("chunks_refetched", "poisoned", len(self._chunks))
                if source is not None:
                    # single-source attempt: every chunk came from this
                    # one peer and the trusted app hash refutes the
                    # result — conviction by name
                    self._quarantine(source,
                                     "single-source restore attempt "
                                     "refuted by trusted app hash",
                                     kind="single_source")
                logger.warning(
                    "restore attempt %d/%d for snapshot h=%d poisoned "
                    "(%s); rotating peer mix", attempt, RESTORE_ATTEMPTS,
                    snapshot.height, e)
                if attempt >= RESTORE_ATTEMPTS:
                    raise _RejectSnapshot(
                        f"{RESTORE_ATTEMPTS} restore attempts exhausted")
                candidates = [p for p in self.pool.peers_of(snapshot)
                              if p not in tried_sources]
                if not candidates:
                    raise _RejectSnapshot(
                        "no untried peer mix left for snapshot")
                source = candidates[0]
                tried_sources.add(source)
                continue
            finally:
                self._active = None
            break

        # a succeeding attempt convicts the original poisoners: any
        # sender whose recorded chunk bytes differ from the verified
        # set provably served garbage
        if failed:
            for rec in failed:
                for idx, (bad_bytes, sender) in rec.items():
                    if sender and self._chunks.get(idx) != bad_bytes:
                        self._quarantine(
                            sender,
                            f"chunk {idx} diverges from the verified "
                            "restore", kind="diverged_chunk")

        state = await self.state_provider.state(snapshot.height)
        commit = await self.state_provider.commit(snapshot.height)
        logger.info("snapshot restored and verified at height %d",
                    snapshot.height)
        return state, commit

    def _dispatch_offer_result(self, result: int) -> None:
        R = abci.OfferSnapshotResult
        if result == R.ACCEPT:
            return
        if result == R.ABORT:
            raise _AbortSync()
        if result == R.REJECT_FORMAT:
            raise _RejectFormat()
        if result in (R.REJECT, R.REJECT_SENDER, R.UNKNOWN):
            raise _RejectSnapshot()
        raise StateSyncError(f"unknown offer result {result}")

    async def _fetch_and_apply(self, snapshot: Snapshot,
                               source: str | None = None) -> None:
        """Fetch + apply the chunk set. `source=None` round-robins over
        every holder (throughput); a named `source` fetches EVERY chunk
        from that one peer (the attribution mode after a poisoned
        attempt — see _sync)."""
        applied = 0
        requested: dict[int, float] = {}
        attempts: dict[int, int] = {}    # fetch attempts per chunk
        not_before: dict[int, float] = {}  # backoff gate per chunk
        loop = asyncio.get_running_loop()
        while applied < snapshot.chunks:
            while self._requeue:
                # the serving peer said "missing": retry WITH backoff
                # (capped, jittered) — the old immediate retry was a
                # hot loop against peers that just pruned the snapshot
                idx = self._requeue.pop()
                requested[idx] = 0.0
                not_before[idx] = loop.time() + _chunk_backoff(
                    attempts.get(idx, 0))
            peers = self.pool.peers_of(snapshot)
            if source is not None:
                peers = [p for p in peers if p == source]
            if not peers:
                raise StateSyncError("no peers hold the snapshot")
            # (re-)request missing chunks, round-robin over peers
            now = loop.time()
            outstanding = 0
            for idx in range(applied, snapshot.chunks):
                if idx in self._chunks:
                    continue
                if outstanding >= self.chunk_fetchers:
                    break
                last = requested.get(idx, 0.0)
                due = last == 0.0 or now - last > self.chunk_timeout
                if due and now >= not_before.get(idx, 0.0):
                    n = attempts.get(idx, 0)
                    if n >= CHUNK_RETRIES:
                        # exhausted: a fetch FAILURE for the whole
                        # snapshot, surfaced to sync_any (which moves
                        # on / re-discovers) — never a silent spin
                        raise StateSyncError(
                            f"chunk {idx} exhausted after {n} fetch "
                            "attempts")
                    attempts[idx] = n + 1
                    if n:
                        count("chunk_retries")
                    peer = peers[idx % len(peers)] if last == 0.0 else \
                        peers[(idx + 1) % len(peers)]
                    await self.request_chunk(peer, snapshot, idx)
                    requested[idx] = now
                outstanding += 1
            # apply whatever is ready, in order
            progressed = False
            while applied in self._chunks:
                # chaos: `corrupt` garbles the chunk AT the apply
                # boundary (poisoned-peer shape), `crash` dies
                # mid-restore — the restart must re-enter discovery
                # with no partial state served
                chunk = failpoints.hit("statesync.apply",
                                       payload=self._chunks[applied])
                res = await self.app.apply_snapshot_chunk(
                    abci.RequestApplySnapshotChunk(
                        index=applied, chunk=chunk,
                        sender=self._chunk_senders.get(applied, "")))
                applied = self._dispatch_apply_result(res, applied,
                                                      requested)
                self._applied_count = applied
                progressed = True
            if applied >= snapshot.chunks:
                return
            if not progressed:
                self._chunk_event.clear()
                if applied in self._chunks or self._requeue:
                    continue  # work arrived before the clear: no wait
                # wake early if a backed-off chunk comes due before the
                # fetch timeout — backoff must not turn into a stall
                wait = self.chunk_timeout
                now = loop.time()
                for idx, nb in not_before.items():
                    if idx not in self._chunks and nb > now:
                        wait = min(wait, max(nb - now, 0.05))
                try:
                    await asyncio.wait_for(self._chunk_event.wait(),
                                           wait)
                except asyncio.TimeoutError:
                    # force re-requests next loop
                    for idx in list(requested):
                        if idx not in self._chunks:
                            requested[idx] = 0.0

    def _drop_chunk(self, idx: int, requested: dict, reason: str) -> None:
        self._chunks.pop(idx, None)
        self._chunk_senders.pop(idx, None)
        requested[idx] = 0.0
        count("chunks_refetched", reason)

    def _dispatch_apply_result(self, res, applied: int,
                               requested: dict) -> int:
        # the app's sender ban channel (reference syncer.go:352): a
        # named sender is quarantined and every unapplied chunk it
        # supplied is discarded for re-fetch from surviving peers
        for sender in res.reject_senders:
            self._quarantine(sender, "app rejected sender",
                             kind="app_rejected_sender")
            for idx in [i for i, s in self._chunk_senders.items()
                        if s == sender and i > applied]:
                self._drop_chunk(idx, requested, "rejected_sender")
        R = abci.ApplySnapshotChunkResult
        if res.result == R.ACCEPT:
            for idx in res.refetch_chunks:
                self._drop_chunk(idx, requested, "app_refetch")
            return applied + 1
        if res.result == R.RETRY:
            self._drop_chunk(applied, requested, "app_retry")
            return applied
        if res.result == R.ABORT:
            raise _AbortSync()
        if res.result == R.RETRY_SNAPSHOT:
            # the app refused the assembled payload (e.g. its hash
            # check failed): a poisoned attempt, retried with a new
            # peer mix — NOT a verdict on the snapshot
            raise _PoisonedRestore("app requested snapshot retry")
        if res.result == R.REJECT_SNAPSHOT:
            raise _RejectSnapshot()
        raise StateSyncError(f"unknown apply result {res.result}")
