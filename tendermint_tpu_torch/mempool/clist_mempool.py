"""Concurrent-list mempool (reference: mempool/clist_mempool.py; Go
mempool/clist_mempool.go:37).

Validated transactions sit in FIFO order on a CList that per-peer
broadcast routines iterate with blocking waits; a bounded first-seen
cache short-circuits duplicate CheckTx work; after every commit the
pool drops committed txs and re-runs CheckTx on the remainder
("recheck", reference :577,639). An optional write-ahead log persists
accepted txs so a restarted node can refill its pool (reference :140).

Differences from the reference are deliberate asyncio redesigns:
CheckTx is awaited through the pipelined ABCI client rather than a
callback chain, and the commit-window lock is an event the executor
toggles around ApplyBlock's Commit (reference updateMtx).

The reference's mempool metrics (size, tx bytes, failed txs, recheck
counts) are the port's ``METRICS`` dict for the two counters (the
gauges are ``size()`` and ``tx_bytes()``); its observability family
waits for ROADMAP Queue A item 10. The p2p reactor is
mempool/reactor.py.

A fix beyond the reference (a recorded divergence): a tx that commits
while its CheckTx waits in the admission plane's pre-verify is dropped
when the wait ends, as one that commits while the app checks it is. The
reference opens that window only after the pre-verify, so such a tx,
gossiped to a node just as a block carrying it commits there, is put
back in the pool and committed a second time.
"""

from __future__ import annotations

import asyncio
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass, field

from ..abci import types as abci
from ..config import MempoolConfig
from ..libs.clist import CList
from ..libs.overload import CONTROLLER
from ..types import tx_envelope
from ..types.tx import tx_hash
from . import Mempool


logger = logging.getLogger("mempool")

METRICS: dict = {"failed_txs": 0, "recheck_times": 0}


class TxInMempoolError(Exception):
    pass


class MempoolFullError(Exception):
    def __init__(self, n_txs: int, tx_bytes: int):
        super().__init__(f"mempool full: {n_txs} txs, {tx_bytes} bytes")


class MempoolBusyError(Exception):
    """Admission shed: the ABCI mempool connection's in-flight window
    is saturated — the app cannot keep up with CheckTx arrivals, so
    new txs are rejected EXPLICITLY (429-style at the RPC layer)
    instead of queueing behind a backlog that only grows."""

    def __init__(self, in_flight: int, limit: int):
        super().__init__(
            f"mempool busy: {in_flight} CheckTx in flight "
            f"(limit {limit}); retry later")


class TxTooLargeError(Exception):
    pass


@dataclass
class MempoolTx:
    """reference: mempoolTx (clist_mempool.go:765)."""

    tx: bytes
    height: int              # height when validated
    gas_wanted: int
    senders: set[str] = field(default_factory=set)  # peers that sent it


class TxCache:
    """Bounded FIFO-eviction cache of seen tx hashes
    (reference: mapTxCache, clist_mempool.go:697)."""

    def __init__(self, size: int):
        self.size = size
        self._m: OrderedDict[bytes, None] = OrderedDict()

    def push(self, key: bytes) -> bool:
        """Returns False if already present."""
        if key in self._m:
            self._m.move_to_end(key)
            return False
        self._m[key] = None
        while len(self._m) > self.size:
            self._m.popitem(last=False)
        return True

    def remove(self, key: bytes) -> None:
        self._m.pop(key, None)

    def reset(self) -> None:
        self._m.clear()


class CListMempool(Mempool):
    def __init__(self, config: MempoolConfig, client, height: int = 0,
                 precheck=None, postcheck=None, logger=None):
        self.config = config
        self.client = client          # ABCI client (mempool connection)
        self.height = height
        self.precheck = precheck
        self.postcheck = postcheck
        self.txs = CList()
        self.tx_map: dict[bytes, object] = {}   # hash -> CElement
        self.cache = TxCache(config.cache_size)
        self._tx_bytes = 0
        self._unlocked = asyncio.Event()
        self._unlocked.set()
        # tx key → update generation at commit time: an in-flight CheckTx
        # drops its tx only if the tx committed at a generation >= the one
        # snapshotted before the app call, so old commits never blackhole
        # a fresh resubmission
        self._update_gen = 0
        self._recently_committed: OrderedDict[bytes, int] = OrderedDict()
        self._wal = None
        self._notify_available: asyncio.Event = asyncio.Event()
        if config.wal_dir:
            self._open_wal(config.wal_dir)
        # Device-offloaded signature pre-verification in front of
        # CheckTx (mempool/admission.py): EVERY entry path — RPC
        # broadcast, p2p gossip, WAL replay — converges on check_tx,
        # so wiring the plane here covers them all.
        self.admission = None
        if getattr(config, "admission", "off") not in ("", "off"):
            from .admission import AdmissionPlane

            self.admission = AdmissionPlane(config)
        CONTROLLER.register("mempool.pool", self.size,
                            lambda: self.config.size, owner=self)

    # --- sizes ---------------------------------------------------------------

    def size(self) -> int:
        return len(self.txs)

    def tx_bytes(self) -> int:
        return self._tx_bytes

    def admission_error(self, tx_len: int = 0,
                        tx: bytes | None = None) -> Exception | None:
        """The exception admission control would raise for a tx of
        `tx_len` bytes right now, or None to admit — the ONE place
        the full/busy distinction is made (check_tx raises it; the
        RPC broadcast preflight maps it to a 429). With the tx bytes
        in hand, the pre-verify-backlog check applies only to
        ENVELOPED txs: an unsigned tx never enters that queue, so a
        garbage-envelope flood pinning the backlog full must not 429
        legitimate unsigned traffic whose own path is idle."""
        if (self.size() >= self.config.size
                or self._tx_bytes + tx_len > self.config.max_txs_bytes):
            return MempoolFullError(self.size(), self._tx_bytes)
        max_if = self.config.checktx_max_inflight
        if max_if > 0:
            in_flight = getattr(self.client, "in_flight", lambda: 0)()
            if in_flight >= max_if:
                # the pool has room but the app window is saturated:
                # shed EXPLICITLY instead of queueing behind a CheckTx
                # backlog the device-bound host cannot drain
                return MempoolBusyError(in_flight, max_if)
        if (self.admission is not None and self.admission.saturated()
                and (tx is None or tx_envelope.is_enveloped(tx))):
            from .admission import AdmissionQueueFullError

            c = self.admission.collector
            return AdmissionQueueFullError(c.depth(), c.queue_max)
        return None

    def shed_admission_error(self, err: Exception) -> None:
        """Controller/metrics bookkeeping for a tx shed on an
        admission_error() verdict — one routing for the sync
        (check_tx) and fire-and-forget (RPC preflight) paths, so both
        move identical counters: a pre-verify-backlog shed charges
        `mempool.preverify` (and the plane's queue_full tally), every
        other reject charges `mempool.pool`."""
        from .admission import AdmissionQueueFullError

        if isinstance(err, AdmissionQueueFullError):
            if self.admission is not None:
                self.admission.count_queue_full_shed()
            CONTROLLER.shed("mempool.preverify")
        else:
            CONTROLLER.shed("mempool.pool")

    def overloaded(self) -> bool:
        return self.admission_error() is not None

    # --- commit-window lock --------------------------------------------------

    def lock(self) -> None:
        self._unlocked.clear()

    def unlock(self) -> None:
        self._unlocked.set()

    async def flush_app_conn(self) -> None:
        await self.client.flush()

    # --- WAL -----------------------------------------------------------------

    def _open_wal(self, wal_dir: str) -> None:
        os.makedirs(wal_dir, exist_ok=True)
        self._wal_path = os.path.join(wal_dir, "mempool.wal")
        self._wal = open(self._wal_path, "ab")

    def wal_pending_txs(self) -> list[bytes]:
        """Txs recorded in the WAL, for refill on restart."""
        if not self.config.wal_dir:
            return []
        path = os.path.join(self.config.wal_dir, "mempool.wal")
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i + 4 <= len(data):
            ln = int.from_bytes(data[i:i + 4], "big")
            if i + 4 + ln > len(data):
                break  # torn tail
            out.append(data[i + 4:i + 4 + ln])
            i += 4 + ln
        return out

    async def refill_from_wal(self) -> dict:
        """Re-admit WAL-recorded txs through the FULL check_tx path —
        admission pre-verification included — so a restart can never
        re-admit a tx that would now fail signature verification (or
        the strict unsigned policy). Rejected txs are compacted out of
        the WAL at the end; the report feeds the startup log."""
        txs = self.wal_pending_txs()
        report = {"pending": len(txs), "readmitted": 0, "rejected": 0}
        # bounded-concurrency re-admission: serial awaits would make
        # every enveloped tx pay its own admission flush deadline and
        # a 1-lane host verify — concurrent submissions coalesce into
        # the wide device batches the plane exists for, and overlap
        # the ABCI round trips. The cap stays safely below the
        # pre-verify queue bound and the CheckTx in-flight window so
        # the refill can never shed ITSELF as transient overload.
        conc = 64
        if self.admission is not None:
            conc = min(conc, self.admission.collector.queue_max)
        if self.config.checktx_max_inflight:
            conc = min(conc, self.config.checktx_max_inflight)
        sem = asyncio.Semaphore(max(1, conc))

        async def readmit(tx: bytes) -> bool:
            async with sem:
                try:
                    res = await self.check_tx(tx)
                    return getattr(res, "code", 1) == abci.CODE_TYPE_OK
                except Exception as e:
                    logger.debug("WAL refill tx rejected: %s", e)
                    return False

        for ok in await asyncio.gather(*(readmit(tx) for tx in txs)):
            report["readmitted" if ok else "rejected"] += 1
        if txs:
            # compact: the on-disk pending set must match the pool, so
            # a rejected tx does not resurface on the NEXT restart
            self._rewrite_wal()
        return report

    def _rewrite_wal(self) -> None:
        """Compact the WAL to the current pending set (runs per block,
        not per tx — so the file is the pending set, not a history).
        Best-effort: a disk error here must not take down the commit
        path, only the refill-after-crash convenience."""
        if not self._wal:
            return
        try:
            tmp = self._wal_path + ".tmp"
            with open(tmp, "wb") as f:
                for mtx in self.txs:
                    f.write(len(mtx.tx).to_bytes(4, "big") + mtx.tx)
            self._wal.close()
            os.replace(tmp, self._wal_path)
            self._wal = open(self._wal_path, "ab")
        except OSError:
            logger.exception("mempool WAL rewrite failed; disabling WAL")
            try:
                self._wal.close()
            except OSError:
                pass
            self._wal = None

    def close_wal(self) -> None:
        if self._wal:
            self._wal.close()
            self._wal = None

    def close(self) -> None:
        """Teardown: drop the WAL handle and the overload
        registration (owner-checked — a newer pool's entry survives)."""
        self.close_wal()
        if self.admission is not None:
            self.admission.close()
        CONTROLLER.unregister("mempool.pool", owner=self)

    # --- CheckTx admission ---------------------------------------------------

    async def check_tx(self, tx: bytes, tx_info: dict | None = None):
        """Admit a tx: guards → cache → ABCI CheckTx → insert.
        reference: CheckTx (clist_mempool.go:235) + resCbFirstTime (:367).
        """
        await self._unlocked.wait()

        if len(tx) > self.config.max_tx_bytes:
            raise TxTooLargeError(
                f"tx {len(tx)}B > max {self.config.max_tx_bytes}B")
        if self.precheck is not None:
            err = self.precheck(tx)
            if err is not None:
                raise ValueError(f"precheck: {err}")
        admission_err = self.admission_error(len(tx), tx)
        if admission_err is not None:
            self.shed_admission_error(admission_err)
            raise admission_err

        key = tx_hash(tx)
        # a commit of this tx from here on drops it at the end (the
        # admission pre-verify and the app's CheckTx both await)
        gen_before = self._update_gen
        if not self.cache.push(key):
            # Record the extra sender for dedup in broadcast
            # (reference clist_mempool.go:257-266).
            e = self.tx_map.get(key)
            if e is not None and tx_info and tx_info.get("sender"):
                e.value.senders.add(tx_info["sender"])
            raise TxInMempoolError("tx already in cache")

        # Signature pre-verification BEFORE the app round trip: a tx
        # shed here costs the app NOTHING (the acceptance test counts
        # the app's CheckTx calls under a garbage flood: zero). The
        # cache key above is the hash of the FULL envelope bytes, so a
        # bad-signature shed can never poison a later, correctly
        # signed envelope carrying the same payload — but the shed
        # entry itself is dropped (unless the operator keeps invalid
        # txs cached) so the identical envelope re-verifies.
        if self.admission is not None:
            from .admission import (CODE_ADMISSION_REJECT,
                                    AdmissionQueueFullError)

            try:
                shed_reason = await self.admission.admit(tx)
            except AdmissionQueueFullError:
                # transient backpressure, not a verdict: never leave a
                # cache entry that would blackhole the retry
                self.cache.remove(key)
                raise
            if shed_reason is not None:
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(key)
                METRICS["failed_txs"] += 1
                return abci.ResponseCheckTx(
                    code=CODE_ADMISSION_REJECT,
                    log=f"admission: {shed_reason}")

        res = await self.client.check_tx(abci.RequestCheckTx(tx=tx))

        # The commit window may have opened while we awaited the
        # pre-verify or the app: wait it out, and drop the tx only if it
        # committed during this CheckTx's in-flight window — an older
        # commit of the same tx must not blackhole a legitimate
        # resubmission (reference holds updateMtx.RLock across all of
        # CheckTx).
        await self._unlocked.wait()
        if self._recently_committed.get(key, -1) > gen_before:
            return res

        if self.postcheck is not None and res.code == abci.CODE_TYPE_OK:
            err = self.postcheck(tx, res)
            if err is not None:
                res = abci.ResponseCheckTx(code=1, log=f"postcheck: {err}",
                                           gas_wanted=res.gas_wanted)
        if res.code != abci.CODE_TYPE_OK:
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            METRICS["failed_txs"] += 1
            return res

        # Re-check capacity: it may have filled while awaiting the app.
        if (self.size() >= self.config.size
                or self._tx_bytes + len(tx) > self.config.max_txs_bytes):
            self.cache.remove(key)
            raise MempoolFullError(self.size(), self._tx_bytes)
        if key in self.tx_map:
            return res  # raced duplicate

        mtx = MempoolTx(tx=tx, height=self.height,
                        gas_wanted=res.gas_wanted)
        if tx_info and tx_info.get("sender"):
            mtx.senders.add(tx_info["sender"])
        e = self.txs.push_back(mtx)
        self.tx_map[key] = e
        self._tx_bytes += len(tx)
        if self._wal:
            # buffered; flushed per block in _rewrite_wal (a hard crash
            # loses at most the buffer — the WAL is best-effort refill,
            # not consensus-critical, matching the reference)
            self._wal.write(len(tx).to_bytes(4, "big") + tx)
        self._notify_available.set()
        return res

    def txs_available(self) -> asyncio.Event:
        """Event set when txs enter an empty pool (reference:
        TxsAvailable channel, consensus waits on it before proposing)."""
        return self._notify_available

    # --- reaping -------------------------------------------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        """reference: ReapMaxBytesMaxGas (clist_mempool.go:526)."""
        out, total_bytes, total_gas = [], 0, 0
        for mtx in self.txs:
            if max_bytes > -1 and total_bytes + len(mtx.tx) > max_bytes:
                break
            if max_gas > -1 and total_gas + mtx.gas_wanted > max_gas:
                break
            total_bytes += len(mtx.tx)
            total_gas += mtx.gas_wanted
            out.append(mtx.tx)
        return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        out = []
        for mtx in self.txs:
            if 0 <= n <= len(out):
                break
            out.append(mtx.tx)
        return out

    # --- post-commit update --------------------------------------------------

    async def update(self, height: int, txs: list[bytes], results: list,
                     precheck=None, postcheck=None) -> None:
        """Drop committed txs and recheck the rest.
        reference: Update (clist_mempool.go:577). Caller holds lock()."""
        self.height = height
        if precheck is not None:
            self.precheck = precheck
        if postcheck is not None:
            self.postcheck = postcheck

        self._update_gen += 1
        for tx, res in zip(txs, results):
            key = tx_hash(tx)
            self._recently_committed[key] = self._update_gen
            while len(self._recently_committed) > self.config.cache_size:
                self._recently_committed.popitem(last=False)
            if getattr(res, "code", 0) == abci.CODE_TYPE_OK:
                # Committed-valid stays in cache to reject replays.
                self.cache.push(key)
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            e = self.tx_map.pop(key, None)
            if e is not None:
                self.txs.remove(e)
                self._tx_bytes -= len(tx)

        if self.config.recheck and self.size() > 0:
            METRICS["recheck_times"] += self.size()
            await self._recheck_txs()
        self._rewrite_wal()
        if self.size() == 0:
            self._notify_available.clear()
        else:
            self._notify_available.set()

    async def _recheck_txs(self) -> None:
        """Re-run CheckTx on every remaining tx; drop the now-invalid
        (reference: recheckTxs :639 + resCbRecheck :430)."""
        snapshot = list(self.txs)
        tasks = [self.client.submit(
            abci.RequestCheckTx(tx=mtx.tx, type=abci.CheckTxType.RECHECK))
            for mtx in snapshot]
        results = await asyncio.gather(*tasks)
        stale = []
        for mtx, res in zip(snapshot, results):
            ok = res.code == abci.CODE_TYPE_OK
            if ok and self.postcheck is not None:
                ok = self.postcheck(mtx.tx, res) is None
            if not ok:
                stale.append(mtx.tx)
        for tx in stale:
            key = tx_hash(tx)
            e = self.tx_map.pop(key, None)
            if e is not None:
                self.txs.remove(e)
                self._tx_bytes -= len(tx)
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)

    async def flush(self) -> None:
        """Drop everything (RPC unsafe_flush_mempool)."""
        for mtx in list(self.txs):
            e = self.tx_map.pop(tx_hash(mtx.tx), None)
            if e is not None:
                self.txs.remove(e)
        self._tx_bytes = 0
        self.cache.reset()
        self._notify_available.clear()
        self._rewrite_wal()
