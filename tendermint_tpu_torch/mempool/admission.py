"""Device-offloaded tx admission plane: batched ed25519 signature
pre-verification in front of CheckTx (reference: mempool/admission.py;
the Go reference pays a full ABCI round trip per tx).

Every tx entering the mempool — RPC ``broadcast_tx_*``, p2p gossip,
mempool-WAL replay — funnels through ``CListMempool.check_tx``, which
hands it to the AdmissionPlane here BEFORE the app sees it:

  * txs carrying a types/tx_envelope.py signature envelope are
    coalesced by a micro-batching collector (flush on size or
    deadline, like the consensus vote scheduler) into ONE wide
    ed25519 verify launch (K4, crypto/cuda/verify.py); only
    signature-valid txs proceed to the ABCI CheckTx round trip, the
    rest are shed with a counter and a deterministic reject — a
    garbage-signature flood dies at the device, not in the app;
  * unsigned txs pass through under ``mempool.admission=permissive``
    and are shed under ``strict``;
  * the pending+in-verify backlog is a tracked bounded queue
    (``mempool.preverify`` in libs/overload.py's controller): when
    full the NEWEST arrival is shed with a 429-style error, so a flood
    can never grow an unbounded verify backlog.

Verification is breaker-aware (crypto/batch.py): batches below the
device crossover — or any batch while the ed25519 breaker is open —
run on the host oracle; a raising device launch opens the breaker and
degrades to host. Every device batch carries one extra known-answer
sentinel lane (the breaker probe's triple): a kernel giving wrong
verdicts fails the sentinel, which opens the breaker and re-verifies
the batch on host instead of mass-rejecting possibly-valid txs — while
an honest all-garbage batch (sentinel verifies) is trusted and dies at
the device without ever paying a per-signature host re-check. The
port's own faults (``crypto.batch.UNCAUGHT``: ``KernelError``,
``NoDeviceError``) are never degraded: they land on every future of
the batch, so ``check_tx`` raises them (the reference degrades every
exception; ROADMAP Queue C).

The blocking verify work runs in an executor thread, as the light
verify collector's does (light/serving.py), so a slow device (or an
armed ``mempool.admission.verify`` delay) backs up the bounded queue
and sheds instead of stalling the event loop.

Counts go into ``METRICS``, a plain dict (crypto/batch.py's
convention): verify launches and lanes by backend ("device", "host",
"host_recheck"), sheds by reason, admitted txs by signed "yes"/"no".
The degrades also move crypto.batch.METRICS (host_fallbacks,
host_rechecks). The reference's ``tpu_ledger.workload("admission")``
tag around the launch waits for the port's observability layer
(ROADMAP Queue A item 10).
"""

from __future__ import annotations

import asyncio
import collections
import logging

import numpy as np

from ..libs.overload import CONTROLLER
from ..types import tx_envelope

logger = logging.getLogger("mempool.admission")

PREVERIFY_QUEUE = "mempool.preverify"

# ResponseCheckTx.code for txs rejected at admission (deterministic,
# app never consulted). 429 on the nose: load generators distinguish
# "bad envelope, don't retry" from app-level rejects.
CODE_ADMISSION_REJECT = 429

# Shed reasons — the closed label set of the shed tally.
SHED_BAD_SIGNATURE = "bad_signature"
SHED_MALFORMED = "malformed"
SHED_UNSIGNED = "unsigned"
SHED_QUEUE_FULL = "queue_full"
SHED_REASONS = (SHED_BAD_SIGNATURE, SHED_MALFORMED, SHED_UNSIGNED,
                SHED_QUEUE_FULL)

METRICS: dict = {"verify_launches": {}, "batch_lanes": {}, "sheds": {},
                 "admitted": {}}


def _bump(key: str, sub: str, n: int = 1) -> None:
    m = METRICS[key]
    m[sub] = m.get(sub, 0) + n


def _count(backend: str, lanes: int | None) -> None:
    """One verify launch on `backend`, and its lanes (None: none
    counted, as for the sentinel's host recheck)."""
    _bump("verify_launches", backend)
    if lanes is not None:
        _bump("batch_lanes", backend, lanes)


class AdmissionQueueFullError(Exception):
    """Pre-verify backlog full: the newest tx is shed (429 at RPC) —
    transient backpressure, NOT a verdict on the tx itself."""

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"admission pre-verify queue full: {depth} txs pending "
            f"(limit {limit}); retry later")


class AdmissionCollector:
    """Micro-batching signature-verify collector.

    ``verify(env)`` parks the envelope on the pending deque and awaits
    its per-lane verdict; a single flusher task cuts batches at
    ``batch_max`` txs or ``flush_ms`` after the first pending arrival
    (whichever first) and runs them through one verify launch in an
    executor thread. Mirrors the consensus vote scheduler's
    size-or-deadline shape, but for mempool admission."""

    def __init__(self, batch_max: int = 256, flush_ms: float = 2.0,
                 queue_max: int = 2048, device_threshold: int | None = None,
                 controller=None):
        from ..crypto import batch as cbatch

        self.batch_max = max(1, batch_max)
        self.flush_ms = flush_ms
        self.queue_max = max(1, queue_max)
        self.device_threshold = cbatch._DEVICE_THRESHOLD \
            if device_threshold is None else device_threshold
        self._controller = controller or CONTROLLER
        # (envelope, future) pairs awaiting a flush
        self._pending: collections.deque = collections.deque()
        self._in_flight = 0
        self._item_evt = asyncio.Event()   # set on every enqueue
        self._full_evt = asyncio.Event()   # set when batch_max reached
        self._flusher: asyncio.Task | None = None
        self._controller.register(PREVERIFY_QUEUE, self.depth,
                                  lambda: self.queue_max, owner=self)

    # -- sizes ---------------------------------------------------------

    def depth(self) -> int:
        """Backlog the bound applies to: parked + currently verifying."""
        return len(self._pending) + self._in_flight

    def saturated(self) -> bool:
        return self.depth() >= self.queue_max

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        for _, fut in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        self._controller.unregister(PREVERIFY_QUEUE, owner=self)

    def _ensure_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_running_loop().create_task(
                self._flush_loop(), name="mempool-admission-flusher")

    # -- the await-a-verdict entry point -------------------------------

    async def verify(self, env: tx_envelope.TxEnvelope) -> bool:
        """Queue `env` for the next batch; returns its lane verdict.
        Raises AdmissionQueueFullError (shed-newest) when the backlog
        is at its bound."""
        if self.depth() >= self.queue_max:
            self._controller.shed(PREVERIFY_QUEUE)
            _bump("sheds", SHED_QUEUE_FULL)
            raise AdmissionQueueFullError(self.depth(), self.queue_max)
        self._ensure_flusher()
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((env, fut))
        self._item_evt.set()
        if len(self._pending) >= self.batch_max:
            self._full_evt.set()
        return await fut

    # -- flusher -------------------------------------------------------

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            while not self._pending:
                self._item_evt.clear()
                await self._item_evt.wait()
            # first tx arrived: hold the batch open until the deadline
            # or until it fills, whichever comes first
            deadline = loop.time() + self.flush_ms / 1000.0
            while len(self._pending) < self.batch_max:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                self._full_evt.clear()
                try:
                    await asyncio.wait_for(self._full_evt.wait(),
                                           remaining)
                except asyncio.TimeoutError:
                    break
            batch = [self._pending.popleft()
                     for _ in range(min(len(self._pending),
                                        self.batch_max))]
            self._in_flight = len(batch)
            try:
                envs = [env for env, _ in batch]
                verdicts = await loop.run_in_executor(
                    None, self._verify_batch, envs)
                for (_, fut), ok in zip(batch, verdicts):
                    if not fut.done():
                        fut.set_result(bool(ok))
            except asyncio.CancelledError:
                for _, fut in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            except Exception as e:  # a verdict (or the error) must land
                logger.exception("admission verify batch died")
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                self._in_flight = 0

    # -- the batched verify launch (executor thread) -------------------

    def _verify_batch(self, envs: list) -> np.ndarray:
        # Dispatch is deliberately NOT BatchVerifier._verify_group:
        # admission policy differs (known-answer sentinel lane,
        # host_recheck on a suspect verdict, its own failpoint). Bad
        # admission signatures stay out of any invalid-signature count
        # on purpose: a garbage flood is expected bulk (the
        # bad_signature shed tally).
        from ..crypto import batch as cbatch
        from ..libs import failpoints

        n = len(envs)
        try:
            failpoints.hit("mempool.admission.verify")
        except failpoints.FailpointError:
            # injected launch failure: degrade to the host oracle,
            # exactly like a raising device launch
            _count("host", n)
            return self._host_verify(envs)
        want_dev = n >= self.device_threshold
        use_dev = want_dev and cbatch.breaker("ed25519").acquire()
        if use_dev:
            try:
                from ..crypto.cuda import verify as tv

                failpoints.hit("device.verify")
                # one extra known-answer sentinel lane rides last: a
                # kernel giving wrong verdicts fails it, so a suspect
                # verdict is detected POSITIVELY — an honest all-garbage
                # flood (sentinel verifies, every real lane invalid) is
                # trusted and dies at the device
                spub, smsg, ssig = cbatch._ed_probe_triple()
                out = np.asarray(tv.verify_batch(
                    [e.pub_key for e in envs] + [spub],
                    [tx_envelope.sign_bytes(e.payload) for e in envs]
                    + [smsg],
                    [e.signature for e in envs] + [ssig]), bool)
                # the launch landed: only now does it count as a device
                # verify (a raising launch counts as one host launch)
                _count("device", n)
                if out[-1]:
                    return out[:n]
                # sentinel mismatch: wrong-verdict device — open the
                # breaker and re-verify on host rather than
                # mass-rejecting possibly-valid txs
                cbatch.mark_device_failed("ed25519")
                logger.error(
                    "admission device batch (%d lanes) failed its "
                    "known-answer sentinel; breaker open %.1fs, "
                    "re-verifying on host", n,
                    cbatch.breaker("ed25519").cooldown_remaining())
                _count("host_recheck", None)
                cbatch.count("host_rechecks")
                cbatch.count("host_fallbacks")
                return self._host_verify(envs)
            except cbatch.UNCAUGHT:
                raise
            except Exception:
                cbatch.mark_device_failed("ed25519")
                logger.exception(
                    "admission device batch failed (%d lanes); "
                    "breaker open %.1fs, degrading to host", n,
                    cbatch.breaker("ed25519").cooldown_remaining())
        if want_dev:
            # device wanted (threshold met) but breaker-refused or
            # raised: the same fallback signal as BatchVerifier's
            cbatch.count("host_fallbacks")
        _count("host", n)
        return self._host_verify(envs)

    @staticmethod
    def _host_verify(envs: list) -> np.ndarray:
        from ..crypto.ed25519 import Ed25519PubKey

        out = np.zeros(len(envs), bool)
        for i, e in enumerate(envs):
            try:
                out[i] = Ed25519PubKey(e.pub_key).verify_signature(
                    tx_envelope.sign_bytes(e.payload), e.signature)
            except Exception:
                out[i] = False
        return out


class AdmissionPlane:
    """Policy wrapper the mempool calls per tx: parse the (optional)
    envelope, route enveloped txs through the collector, apply the
    permissive/strict unsigned policy, keep /status-visible tallies."""

    def __init__(self, config):
        self.mode = config.admission
        self.collector = AdmissionCollector(
            batch_max=config.admission_batch,
            flush_ms=config.admission_flush_ms,
            queue_max=config.admission_queue)
        # running tallies for the /status admission check (METRICS
        # keeps the process totals)
        self.admitted_signed = 0
        self.admitted_unsigned = 0
        self.sheds: dict[str, int] = {r: 0 for r in SHED_REASONS}

    def close(self) -> None:
        self.collector.close()

    def saturated(self) -> bool:
        return self.collector.saturated()

    def count_queue_full_shed(self) -> None:
        """Tally a queue_full shed decided OUTSIDE the collector (the
        check_tx / RPC admission_error preflights), so every shed
        moves the same counters no matter which guard caught it."""
        self._shed(SHED_QUEUE_FULL)

    def _shed(self, reason: str) -> str:
        self.sheds[reason] += 1
        _bump("sheds", reason)
        return reason

    async def admit(self, tx: bytes) -> str | None:
        """None = proceed to CheckTx; a SHED_* reason string = reject
        deterministically before the app. Raises
        AdmissionQueueFullError when the pre-verify backlog sheds the
        tx (transient, 429 at RPC)."""
        try:
            env = tx_envelope.parse(tx)
        except tx_envelope.MalformedEnvelopeError:
            return self._shed(SHED_MALFORMED)
        if env is None:
            if self.mode == "strict":
                return self._shed(SHED_UNSIGNED)
            self.admitted_unsigned += 1
            _bump("admitted", "no")
            return None
        try:
            ok = await self.collector.verify(env)
        except AdmissionQueueFullError:
            # counted in the collector (queue_full); tally here too so
            # /status shows one coherent shed breakdown
            self.sheds[SHED_QUEUE_FULL] += 1
            raise
        if not ok:
            return self._shed(SHED_BAD_SIGNATURE)
        self.admitted_signed += 1
        _bump("admitted", "yes")
        return None

    # -- /status -------------------------------------------------------

    def status_check(self) -> dict:
        """The GET /status `admission` check body: mode, backlog fill,
        shed/admit tallies, verify-backend split (process totals, from
        METRICS). Shedding is designed behavior — only a saturated
        backlog degrades the check."""
        from ..crypto import batch as cbatch

        launches = METRICS["verify_launches"]
        depth = self.collector.depth()
        cap = self.collector.queue_max
        out: dict = {
            "mode": self.mode,
            "queue_depth": depth,
            "queue_capacity": cap,
            "admitted": {"signed": self.admitted_signed,
                         "unsigned": self.admitted_unsigned},
            "shed": {r: n for r, n in self.sheds.items() if n},
            "verify_launches": {
                b: launches[b] for b in ("device", "host", "host_recheck")
                if launches.get(b)},
        }
        fill = depth / cap if cap else 0.0
        if fill >= 0.8:
            out["status"] = "degraded"
            out["detail"] = (f"pre-verify backlog at {fill:.0%}; "
                             "shedding newest arrivals soon")
        else:
            out["status"] = "ok"
            if not cbatch.device_available("ed25519"):
                out["detail"] = ("ed25519 breaker open: admission "
                                 "verifying on host")
        return out
