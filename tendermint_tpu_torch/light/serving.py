"""The light-client serving plane's verify layer (reference:
light/serving.py): the verified-header cache, the micro-batching verify
collector, and the pooled form of one verification step.

A skipping verify is two >1/3-power commit checks. A proxy serving N
concurrent clients would pay N independent verification walks; the
collector here takes ``types/validator_set.py`` CommitVerifyPlans from
independent requests AND from both checks of one skipping step and
verifies them as single wide ed25519 launches (K4,
crypto/cuda/verify.py) — breaker-aware with host fallback, with one
known-answer sentinel lane a device batch (a kernel giving wrong
verdicts fails the sentinel and the batch re-runs on the host instead
of failing requests on wrong verdicts). Its parked and in-verify
checks are the ``light.pending_verify`` entry of libs/overload.py: at
the bound the NEWEST request is shed with LightServingShedError.

The ServingPlane sits in front of one light ``Client`` and turns N
concurrent requests into few wide launches: a singleflight map keyed
by height makes concurrent requests for one height pay ONE
verification, a trusting-period-aware LRU over the trusted
``LightStore`` makes the second client of a verified height cost a
dict lookup, and the commit checks of every in-flight bisection go
through the plane's collector. It keeps the Client's semantics: the
same pivots, error taxonomy, witness cross-checking and trusted-store
writes.

Counts go into the reference's light family (libs/metrics.py): verify
launches by backend ("device", "host", "host_recheck"), lanes and
verify time per flush, cache hits and misses, coalesced requests and
sheds; the plane also keeps its tallies on itself (read by
``status_check``). The degrades move tpu_host_fallbacks_total as every
device path does. The device launch is tagged ``workload("light")`` in
the launch ledger.
ServingPool puts N LightProxy workers (light/proxy.py) in front of one
plane.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from fractions import Fraction

import numpy as np

from ..crypto.cuda import ledger as _ledger
from ..libs import tracing
from ..libs.metrics import crypto_metrics, light_metrics
from ..libs.overload import CONTROLLER
from ..types.validator_set import CommitVerifyPlan, VerificationError
from .errors import (
    DivergenceError,
    LightClientError,
    NewValSetCantBeTrustedError,
    OutsideTrustingPeriodError,
    VerificationFailedError,
)
from .types import LightBlock
from .verifier import DEFAULT_TRUST_LEVEL, _common_checks

logger = logging.getLogger("light.serving")

PENDING_VERIFY_QUEUE = "light.pending_verify"

# Shed reasons: the closed label set of the plane's shed tally.
SHED_QUEUE_FULL = "queue_full"
SHED_REASONS = (SHED_QUEUE_FULL,)

def _count(backend: str, lanes: int | None) -> None:
    """One verify launch on `backend` (light_verify_launches_total), and
    its lanes in crypto_batch_lanes_total (None: none counted, as for
    the sentinel's host recheck)."""
    light_metrics().verify_launches.inc(backend=backend)
    if lanes is not None:
        crypto_metrics().batch_lanes.inc(
            lanes, backend="gpu" if backend == "device" else backend)


class LightServingShedError(LightClientError):
    """Pending-verify backlog full: the newest request is shed (429 at
    the proxy) — transient backpressure, NOT a verification verdict."""

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"light serving plane overloaded: {depth} commit checks "
            f"pending (limit {limit}); retry later")


# -- the process-global active plane (the /status `light` check) ------

_ACTIVE_PLANE: "ServingPlane | None" = None


def active_plane() -> "ServingPlane | None":
    """The most recently built (not yet closed) plane in this process.
    Several in-process planes replace each other, as the controller
    singleton's registrations do."""
    return _ACTIVE_PLANE


class VerifiedHeaderCache:
    """Trusting-period-aware LRU over verified LightBlocks.

    Entries whose header time has left the trusting period are evicted
    on read — a block outside its period must not be served as trusted
    (its valset may have long unbonded), even though it still sits in
    the persistent store."""

    def __init__(self, max_entries: int, period_ns: int):
        self.max_entries = max(1, max_entries)
        self.period_ns = period_ns
        self._d: collections.OrderedDict[int, LightBlock] = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def get(self, height: int, now_ns: int) -> LightBlock | None:
        lb = self._d.get(height)
        if lb is None:
            return None
        if lb.time() + self.period_ns <= now_ns:
            del self._d[height]
            return None
        self._d.move_to_end(height)
        return lb

    def put(self, lb: LightBlock, now_ns: int) -> None:
        if lb.time() + self.period_ns <= now_ns:
            return  # already expired: never cache
        self._d[lb.height()] = lb
        self._d.move_to_end(lb.height())
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()


class _VerifyJob:
    __slots__ = ("plan", "future")

    def __init__(self, plan: CommitVerifyPlan, future: asyncio.Future):
        self.plan = plan
        self.future = future


class LightVerifyCollector:
    """Micro-batching commit-check collector (the unit of work is a
    CommitVerifyPlan of several signature lanes).

    ``check(plan)`` parks the plan and awaits its verdict; a single
    flusher cuts batches once ``batch_max`` LANES have accumulated (or
    ``flush_ms`` after the first pending plan) and runs every plan's
    triples through ONE wide verify launch in an executor thread,
    scattering per-lane verdicts back per plan. A plan with any invalid
    lane gets the same VerificationError its inline execute() would
    raise — one request's lying provider never poisons the verdicts of
    the batchmates. The backlog registers as ``light.pending_verify``
    with `controller` (default: the process-global CONTROLLER; a
    ServingPlane passes its own)."""

    def __init__(self, batch_max: int = 1024, flush_ms: float = 2.0,
                 pending_max: int = 1024,
                 device_threshold: int | None = None, controller=None):
        from ..crypto import batch as cbatch

        self.batch_max = max(1, batch_max)
        self.flush_ms = flush_ms
        self.pending_max = max(1, pending_max)
        self.device_threshold = cbatch._DEVICE_THRESHOLD \
            if device_threshold is None else device_threshold
        self._controller = controller or CONTROLLER
        self._pending: collections.deque[_VerifyJob] = collections.deque()
        self._pending_lane_count = 0
        self._in_flight = 0
        self._item_evt = asyncio.Event()
        self._full_evt = asyncio.Event()
        self._flusher: asyncio.Task | None = None
        self._controller.register(PENDING_VERIFY_QUEUE, self.depth,
                                  lambda: self.pending_max, owner=self)

    # -- sizes ---------------------------------------------------------

    def depth(self) -> int:
        """Backlog the bound applies to: parked + in-verify checks."""
        return len(self._pending) + self._in_flight

    def pending_lanes(self) -> int:
        # maintained incrementally: a scan of a deep backlog per
        # enqueue would make admission quadratic exactly under load
        return self._pending_lane_count

    def saturated(self) -> bool:
        return self.depth() >= self.pending_max

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        for job in self._pending:
            if not job.future.done():
                job.future.cancel()
        self._pending.clear()
        self._pending_lane_count = 0
        self._controller.unregister(PENDING_VERIFY_QUEUE, owner=self)

    def _ensure_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_running_loop().create_task(
                self._flush_loop(), name="light-verify-flusher")

    # -- the await-a-verdict entry point -------------------------------

    async def check(self, plan: CommitVerifyPlan) -> None:
        """Queue `plan` for the next coalesced launch; returns when
        every lane verified, raises VerificationError (bad slots named
        exactly like the inline path) otherwise. Raises
        LightServingShedError (shed-newest) at the backlog bound —
        uncounted: one shed REQUEST may park two plans, so the plane
        counts sheds once per request, not here per plan."""
        if self.depth() >= self.pending_max:
            raise LightServingShedError(self.depth(), self.pending_max)
        self._ensure_flusher()
        fut = asyncio.get_running_loop().create_future()
        self._pending.append(_VerifyJob(plan, fut))
        self._pending_lane_count += len(plan)
        self._item_evt.set()
        if self.pending_lanes() >= self.batch_max:
            self._full_evt.set()
        verdicts = await fut
        plan.raise_invalid(verdicts)

    # -- flusher -------------------------------------------------------

    async def _flush_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            while not self._pending:
                self._item_evt.clear()
                await self._item_evt.wait()
            deadline = loop.time() + self.flush_ms / 1000.0
            while self.pending_lanes() < self.batch_max:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                self._full_evt.clear()
                try:
                    await asyncio.wait_for(self._full_evt.wait(),
                                           remaining)
                except asyncio.TimeoutError:
                    break
            batch: list[_VerifyJob] = []
            lanes = 0
            while self._pending and (not batch or lanes < self.batch_max):
                job = self._pending.popleft()
                self._pending_lane_count -= len(job.plan)
                batch.append(job)
                lanes += len(job.plan)
            self._in_flight = len(batch)
            try:
                verdicts = await loop.run_in_executor(
                    None, tracing.TRACER.wrap(self._verify_jobs),
                    [j.plan for j in batch])
                for job, v in zip(batch, verdicts):
                    if not job.future.done():
                        job.future.set_result(v)
            except asyncio.CancelledError:
                for job in batch:
                    if not job.future.done():
                        job.future.cancel()
                raise
            except Exception as e:  # a verdict (or the error) must land
                logger.exception("light verify batch died")
                for job in batch:
                    if not job.future.done():
                        job.future.set_exception(e)
            finally:
                self._in_flight = 0

    # -- the coalesced verify launch (executor thread) -----------------

    def _verify_jobs(self, plans: list[CommitVerifyPlan]
                     ) -> list[np.ndarray]:
        """Flatten every plan's triples into one launch, scatter the
        per-lane verdicts back per plan."""
        triples: list[tuple] = []
        spans: list[tuple[int, int]] = []
        for plan in plans:
            t = plan.triples()
            spans.append((len(triples), len(t)))
            triples.extend(t)
        verdicts = self._verify_triples(triples)
        return [verdicts[off:off + n] for off, n in spans]

    def _verify_triples(self, triples: list[tuple]) -> np.ndarray:
        # One wide general-kernel launch with a known-answer sentinel
        # lane, breaker-aware, host fallback. Cross-plan batches mix
        # validator sets, so the general kernel (per-lane keys) is the
        # right tool, not any one set's expanded tables.
        met = light_metrics()
        met.batch_lanes.observe(len(triples))
        t0 = time.perf_counter()
        try:
            return self._verify_flush(triples)
        finally:
            met.verify_seconds.observe(time.perf_counter() - t0)

    def _verify_flush(self, triples: list[tuple]) -> np.ndarray:
        from ..crypto import batch as cbatch
        from ..libs import failpoints

        n = len(triples)
        try:
            failpoints.hit("light.verify")
        except failpoints.FailpointError:
            # injected launch failure: degrade to the host oracle,
            # exactly like a raising device launch
            _count("host", n)
            return self._host_verify(triples)
        ed = [i for i, (pk, _, _) in enumerate(triples)
              if pk.type_name == "ed25519"]
        ed_set = set(ed)
        out = np.zeros(n, bool)
        # non-ed25519 lanes (sr25519 validators) verify on the host per
        # key — rare in practice, never worth a second kernel here
        for i in range(n):
            if i not in ed_set:
                pk, m, s = triples[i]
                try:
                    out[i] = pk.verify_signature(m, s)
                except Exception:
                    out[i] = False
        if not ed:
            _count("host", None)
            return out
        want_dev = len(ed) >= self.device_threshold
        use_dev = want_dev and cbatch.breaker("ed25519").acquire()
        if use_dev:
            try:
                from ..crypto.cuda import verify as tv

                failpoints.hit("device.verify")
                # the known-answer sentinel lane rides last: a kernel
                # giving wrong verdicts fails it, so they are detected
                # POSITIVELY and the batch re-verifies on the host
                spub, smsg, ssig = cbatch._ed_probe_triple()
                crypto_metrics().device_launches.inc()
                with _ledger.workload("light"):
                    dv = np.asarray(tv.verify_batch(
                        [triples[i][0].bytes() for i in ed] + [spub],
                        [triples[i][1] for i in ed] + [smsg],
                        [triples[i][2] for i in ed] + [ssig]), bool)
                # the launch landed: only now does it count as a device
                # verify (a raising launch counts as one host launch)
                _count("device", len(ed))
                if dv[-1]:
                    out[np.asarray(ed)] = dv[:-1]
                    return out
                cbatch.mark_device_failed("ed25519")
                logger.error(
                    "light verify batch (%d lanes) failed its known-answer "
                    "sentinel; breaker open %.1fs, re-verifying on host",
                    len(ed), cbatch.breaker("ed25519").cooldown_remaining())
                _count("host_recheck", None)
                cbatch.host_fallback()
                return self._host_verify(triples, into=out, only=ed)
            except cbatch.UNCAUGHT:
                raise
            except Exception:
                cbatch.mark_device_failed("ed25519")
                logger.exception(
                    "light device batch failed (%d lanes); breaker open "
                    "%.1fs, degrading to host", len(ed),
                    cbatch.breaker("ed25519").cooldown_remaining())
        if want_dev:
            cbatch.host_fallback()
        _count("host", len(ed))
        return self._host_verify(triples, into=out, only=ed)

    @staticmethod
    def _host_verify(triples: list[tuple], into: np.ndarray | None = None,
                     only: list[int] | None = None) -> np.ndarray:
        out = np.zeros(len(triples), bool) if into is None else into
        idxs = range(len(triples)) if only is None else only
        for i in idxs:
            pk, m, s = triples[i]
            try:
                out[i] = len(s) == 64 and pk.verify_signature(m, s)
            except Exception:
                out[i] = False
        return out


async def verify_through(collector: LightVerifyCollector, chain_id: str,
                         trusted: LightBlock, untrusted: LightBlock,
                         trusting_period_ns: int, now_ns: int,
                         trust_level: Fraction = DEFAULT_TRUST_LEVEL) -> None:
    """verifier.verify with the signature work pooled (the reference's
    ServingPlane._verify_one): the non-crypto checks run inline, the
    commit check(s) become CommitVerifyPlans awaited through the
    collector — the two checks of a non-adjacent step verify
    CONCURRENTLY, so they coalesce with each other and with every other
    in-flight request's checks into the same wide launches. Raises what
    verifier.verify raises, or LightServingShedError."""
    sh = untrusted.signed_header
    if untrusted.height() == trusted.height() + 1:
        _common_checks(chain_id, trusted, untrusted, trusting_period_ns,
                       now_ns)
        if sh.header.validators_hash != \
                trusted.signed_header.header.next_validators_hash:
            raise VerificationFailedError(
                "new validators_hash != trusted next_validators_hash")
        try:
            plan = untrusted.validator_set.plan_commit_light(
                chain_id, sh.commit.block_id, sh.header.height, sh.commit)
        except VerificationError as e:
            raise VerificationFailedError(f"invalid commit: {e}") from e
        try:
            await collector.check(plan)
        except VerificationError as e:
            raise VerificationFailedError(f"invalid commit: {e}") from e
        return
    _common_checks(chain_id, trusted, untrusted, trusting_period_ns, now_ns)
    try:
        plan_trusting = trusted.validator_set.plan_commit_trusting(
            chain_id, sh.commit, trust_level.numerator,
            trust_level.denominator)
    except VerificationError as e:
        raise NewValSetCantBeTrustedError(str(e)) from e
    try:
        plan_light = untrusted.validator_set.plan_commit_light(
            chain_id, sh.commit.block_id, sh.header.height, sh.commit)
    except VerificationError as e:
        # own-commit cannot even reach 2/3 — but the reference order
        # gives the TRUSTING check its verdict first, and a failed
        # overlap drives bisection, not rejection
        try:
            await collector.check(plan_trusting)
        except VerificationError as e2:
            raise NewValSetCantBeTrustedError(str(e2)) from e2
        raise VerificationFailedError(f"invalid commit: {e}") from e
    # both-or-neither admission for the gathered pair: if only ONE slot
    # remains, parking the trusting check and shedding its twin would
    # delay the shed until the admitted launch completes — shed
    # promptly instead (the per-check gate in check() stays the bound)
    if collector.depth() + 2 > collector.pending_max:
        raise LightServingShedError(collector.depth(),
                                    collector.pending_max)
    res_t, res_l = await asyncio.gather(
        collector.check(plan_trusting), collector.check(plan_light),
        return_exceptions=True)
    # error taxonomy parity with verifier.verify_non_adjacent: a failed
    # TRUSTING check (insufficient overlap OR bad overlap signature)
    # drives bisection; a failed own-commit check is a definitive
    # rejection; anything else (shed, cancellation) propagates
    if isinstance(res_t, VerificationError):
        raise NewValSetCantBeTrustedError(str(res_t)) from res_t
    if isinstance(res_t, BaseException):
        raise res_t
    if isinstance(res_l, VerificationError):
        raise VerificationFailedError(f"invalid commit: {res_l}") from res_l
    if isinstance(res_l, BaseException):
        raise res_l


class ServingPlane:
    """The shared verification plane requests run through. One plane
    owns one light Client (and its trusted store); requests enter via
    get_verified()."""

    def __init__(self, client, config=None, controller=None):
        from ..config import LightConfig

        cfg = config or LightConfig()
        cfg.validate_basic()
        self.client = client
        self.config = cfg
        self.cache = VerifiedHeaderCache(
            cfg.cache_size, client.trust_options.period_ns)
        self.collector = LightVerifyCollector(
            batch_max=cfg.batch_max, flush_ms=cfg.flush_ms,
            pending_max=cfg.pending_max, controller=controller)
        self._inflight: dict[int, asyncio.Task] = {}
        # running tallies for the /status `light` check
        self.requests = 0
        self.coalesced = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.sheds: dict[str, int] = {r: 0 for r in SHED_REASONS}
        global _ACTIVE_PLANE
        _ACTIVE_PLANE = self

    def close(self) -> None:
        self.collector.close()
        for task in self._inflight.values():
            task.cancel()
        self._inflight.clear()
        global _ACTIVE_PLANE
        if _ACTIVE_PLANE is self:
            _ACTIVE_PLANE = None

    # -- the request entry point ---------------------------------------

    async def get_verified(self, height: int = 0) -> LightBlock:
        """Verified LightBlock at `height` (0 = the primary's latest).
        Coalesces with any in-flight verification of the same height;
        sheds (LightServingShedError) when the pending-verify backlog
        is at its bound and this request would start a NEW
        verification."""
        self.requests += 1
        now_ns = self.client.now_fn()
        if height:
            lb = self.cache.get(height, now_ns)
            if lb is not None:
                self.cache_hits += 1
                light_metrics().cache_hits.inc()
                return lb
            self.cache_misses += 1
            light_metrics().cache_misses.inc()
            # trusted-store probe BEFORE the admission gate: a height
            # already verified and inside its period is a READ, not new
            # verification work — it serves even on a saturated plane
            stored = self.client.store.get(height)
            if stored is not None and stored.time() + \
                    self.client.trust_options.period_ns > now_ns:
                self.cache.put(stored, now_ns)
                return stored
        task = self._inflight.get(height)
        if task is not None and not task.done():
            # join the in-flight verification: no new device work, no
            # queue growth — the whole point of the singleflight map
            self.coalesced += 1
            light_metrics().requests_coalesced.inc()
            return await self._await_counted(task)
        if self.collector.saturated():
            # shed at ADMISSION: a flood of distinct heights dies here,
            # not deep inside a bisection. Backwards walks shed too:
            # each is new work (primary fetches per uncached interim).
            self._count_shed(SHED_QUEUE_FULL)
            raise LightServingShedError(self.collector.depth(),
                                        self.collector.pending_max)
        task = asyncio.get_running_loop().create_task(
            self._verify_height(height, now_ns),
            name=f"light-verify-h{height}")
        self._inflight[height] = task

        def _done(t, h=height):
            if self._inflight.get(h) is t:
                del self._inflight[h]
            # every waiter may have been cancelled while the shielded
            # task ran on: retrieve the exception so asyncio does not
            # log it as never retrieved
            if not t.cancelled():
                t.exception()

        task.add_done_callback(_done)
        return await self._await_counted(task)

    async def _await_counted(self, task: asyncio.Task) -> LightBlock:
        """Await the shared verification (shielded: a cancelled waiter
        must not cancel the task other coalesced waiters are parked on)
        and count a mid-verification shed once PER AFFECTED REQUEST."""
        try:
            return await asyncio.shield(task)
        except LightServingShedError:
            self._count_shed(SHED_QUEUE_FULL)
            raise

    def _count_shed(self, reason: str) -> None:
        """ONE shed request: the tally and the controller tracking the
        pending-verify queue (the collector's, never unconditionally
        the process-global one)."""
        self.sheds[reason] += 1
        light_metrics().shed.inc(reason=reason)
        self.collector._controller.shed(PENDING_VERIFY_QUEUE)

    # -- the singleflight body -----------------------------------------

    async def _verify_height(self, height: int,
                             now_ns: int) -> LightBlock:
        cl = self.client
        if not cl._initialized:
            await cl.initialize()
        period = cl.trust_options.period_ns
        if height:
            stored = cl.store.get(height)
            if stored is not None:
                if stored.time() + period > now_ns:
                    self.cache.put(stored, now_ns)
                    return stored
                # outside its trusting period the old verification no
                # longer makes it servable: below the trusted head the
                # backwards walk re-proves it from an in-period anchor;
                # at the head there is nothing to anchor on
                latest = cl.store.latest()
                if latest is None or height >= latest.height():
                    raise OutsideTrustingPeriodError(
                        f"stored header {height} outside trusting "
                        "period")
                return await cl._verify_backwards(height, now_ns)
            latest = cl.store.latest()
            if latest is not None and height < latest.height():
                # hash-chain walk down — no commit signatures to batch
                lb = await cl._verify_backwards(height, now_ns)
                self.cache.put(lb, now_ns)
                return lb
            target = await cl._from_primary(height)
        else:
            target = await cl._from_primary(0)
            latest = cl.store.latest()
            if latest is not None and \
                    target.height() <= latest.height():
                if latest.time() + period <= now_ns:
                    raise OutsideTrustingPeriodError(
                        f"trusted head {latest.height()} outside "
                        "trusting period")
                self.cache.put(latest, now_ns)
                return latest
        # verify from the head captured BEFORE the fetch (the serial
        # client's order): a concurrent task may have advanced
        # store.latest() past `height` while _from_primary awaited
        trusted = latest
        assert trusted is not None
        try:
            await self._verify_skipping(trusted, target, now_ns)
            await cl._detect_divergence(target, now_ns)
        except DivergenceError:
            # a PROVEN fork purged the trusted store above the common
            # height — the LRU may still hold the attacker's chain
            self.cache.clear()
            raise
        # a mid-verification LightServingShedError propagates uncounted
        # from here: _await_counted counts it once per affected waiter
        self.cache.put(target, now_ns)
        return target

    # -- batched skipping verification ---------------------------------

    async def _verify_skipping(self, trusted: LightBlock,
                               target: LightBlock,
                               now_ns: int) -> None:
        """Client._verify_skipping with the commit checks routed
        through the coalescing collector: same pivots, same error
        taxonomy, same store writes."""
        cl = self.client
        pending: list[LightBlock] = [target]
        seen: set[int] = {target.height()}
        steps = 0
        while pending:
            steps += 1
            if steps > 200:  # 2^200 heights — unreachable honestly
                raise LightClientError("bisection did not converge")
            block = pending[-1]
            try:
                await self._verify_one(trusted, block, now_ns)
            except NewValSetCantBeTrustedError:
                pivot_h = (trusted.height() + block.height()) // 2
                if pivot_h in (trusted.height(), block.height()) or \
                        pivot_h in seen:
                    raise  # can't split further: genuine failure
                pivot = await cl._from_primary(pivot_h)
                seen.add(pivot_h)
                pending.append(pivot)
                continue
            cl.store.save(block)
            self.cache.put(block, now_ns)
            trusted = block
            pending.pop()

    async def _verify_one(self, trusted: LightBlock,
                          untrusted: LightBlock, now_ns: int) -> None:
        """verifier.verify with the signature work pooled through the
        plane's collector (verify_through)."""
        cl = self.client
        await verify_through(self.collector, cl.chain_id, trusted,
                             untrusted, cl.trust_options.period_ns, now_ns,
                             cl.trust_level)

    # -- /status -------------------------------------------------------

    def status_check(self) -> dict:
        """The `light` check body: backlog fill, request/coalesce/cache
        tallies, shed breakdown, verify-backend split (this process's
        light family). Shedding is designed behavior — only a saturated
        pending-verify backlog degrades the check."""
        from ..crypto import batch as cbatch

        launches = light_metrics().verify_launches
        depth = self.collector.depth()
        cap = self.collector.pending_max
        out: dict = {
            "requests": self.requests,
            "coalesced": self.coalesced,
            "cache": {"entries": len(self.cache),
                      "hits": self.cache_hits,
                      "misses": self.cache_misses},
            "queue_depth": depth,
            "queue_capacity": cap,
            "shed": {r: n for r, n in self.sheds.items() if n},
            "trusted_height": self.client.store.latest_height(),
            "verify_launches": {
                b: int(launches.value(backend=b))
                for b in ("device", "host", "host_recheck")
                if launches.value(backend=b)},
        }
        fill = depth / cap if cap else 0.0
        if fill >= 0.8:
            out["status"] = "degraded"
            out["detail"] = (f"pending-verify backlog at {fill:.0%}; "
                             "shedding newest requests soon")
        else:
            out["status"] = "ok"
            if not cbatch.device_available("ed25519"):
                out["detail"] = ("ed25519 breaker open: light plane "
                                 "verifying on host")
        return out


class ServingPool:
    """N LightProxy workers sharing ONE plane (one client, one trusted
    store, one verify collector, one cache) — the horizontally
    scalable serving face: more workers add RPC accept/parse
    capacity, while every verification still coalesces in the shared
    plane. A port fault (UNCAUGHT) met under any worker's request is
    the pool's `fault` and goes to `on_fault` (light/proxy.py)."""

    def __init__(self, client, workers: int | None = None, config=None,
                 forward_clients=None, proof_runtime=None, on_fault=None):
        from ..config import LightConfig
        from .proxy import LightProxy

        cfg = config or LightConfig()
        n = cfg.workers if workers is None else workers
        if n < 1:
            raise ValueError("serving pool needs at least one worker")
        self.plane = ServingPlane(client, cfg)
        fwds = forward_clients or [None] * n
        if len(fwds) != n:
            raise ValueError(
                f"{len(fwds)} forward clients for {n} workers")
        self.fault: BaseException | None = None
        self._on_fault = on_fault
        self.proxies = [
            LightProxy(client, forward_client=fwds[i],
                       proof_runtime=proof_runtime, plane=self.plane,
                       on_fault=self._fault)
            for i in range(n)
        ]
        self.ports: list[int] = []

    def _fault(self, exc: BaseException) -> None:
        if self.fault is None:
            self.fault = exc
        if self._on_fault is not None:
            self._on_fault(exc)

    async def listen(self, host: str,
                     ports: list[int] | None = None) -> list[int]:
        ports = ports or [0] * len(self.proxies)
        if len(ports) != len(self.proxies):
            raise ValueError(
                f"{len(ports)} ports for {len(self.proxies)} workers")
        self.ports = [await proxy.listen(host, port)
                      for proxy, port in zip(self.proxies, ports)]
        logger.info("light serving pool: %d workers on %s:%s",
                    len(self.proxies), host, self.ports)
        return self.ports

    def close(self) -> None:
        for proxy in self.proxies:
            proxy.close()
        self.plane.close()
