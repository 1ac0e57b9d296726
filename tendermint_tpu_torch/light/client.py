"""Light client core (reference: light/client.py; Go
light/client.go:114).

Tracks one primary provider and N witnesses. Headers from the primary
are verified sequentially (adjacent, height by height) or by skipping
with bisection (Go verifySkipping :683): try the target directly
against the latest trusted block; when the trusted valset's overlap is
below the trust level, pivot to the midpoint and recurse. Each
verified header is cross-checked against every witness (Go
detector.go:28); a witness that proves a conflicting header raises
DivergenceError carrying the LightClientAttackEvidence of both sides.
Every commit check is one batch on ValidatorSet's verify surfaces: at
a 150-validator set, one K4 launch (crypto/cuda/verify.py).

The port's own faults (crypto.batch.UNCAUGHT: KernelError,
NoDeviceError) end the call. Where the reference takes any exception
of a witness as "unreachable" (the cross-check's gather, the common
block's walk, the evidence report), the port re-raises these: the
first one among the witnesses' results, in witness order, before any
divergence is examined, so that no examination launches on a faulted
device and no witness is dropped for the device's sake."""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from fractions import Fraction

from ..crypto.batch import UNCAUGHT
from .errors import (
    DivergenceError,
    LightClientError,
    NewValSetCantBeTrustedError,
)
from .provider import BlockNotFoundError, Provider, ProviderError
from .store import LightStore
from .types import LightBlock
from .verifier import DEFAULT_TRUST_LEVEL, verify, verify_backwards

logger = logging.getLogger("light")


@dataclass
class TrustOptions:
    """Social-consensus root of trust (Go reference: light/base.go
    TrustOptions): a height+hash the operator got out of band."""

    period_ns: int
    height: int
    hash: bytes

    def validate(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("trusting period must be positive")
        if self.height < 1:
            raise ValueError("trusted height must be >= 1")
        if len(self.hash) != 32:
            raise ValueError("trusted hash must be 32 bytes")


class Client:
    def __init__(self, chain_id: str, trust_options: TrustOptions,
                 primary: Provider, witnesses: list[Provider],
                 store: LightStore,
                 trust_level: Fraction = DEFAULT_TRUST_LEVEL,
                 now_fn=time.time_ns):
        trust_options.validate()
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.trust_level = trust_level
        self.now_fn = now_fn
        self._initialized = False
        # In-memory linkage-verified headers from backwards walks (NOT
        # the trusted store — their commits are unverified). Bounds
        # request amplification: without it every old-height query
        # re-walks the hash chain from the trusted head.
        self._interim_cache: dict[int, LightBlock] = {}
        self._interim_cache_max = 4096

    # -- bootstrap --

    async def initialize(self) -> LightBlock:
        """Fetch + pin the trusted block (Go reference client.go
        initializeWithTrustOptions)."""
        existing = self.store.get(self.trust_options.height)
        if existing is not None:
            self._initialized = True
            return existing
        lb = await self._from_primary(self.trust_options.height)
        lb.validate_basic(self.chain_id)
        if lb.hash() != self.trust_options.hash:
            raise LightClientError(
                f"trusted header hash mismatch at height "
                f"{self.trust_options.height}: got {lb.hash().hex()}, "
                f"want {self.trust_options.hash.hex()}")
        # +2/3 of ITS OWN valset must have signed it (self-consistency)
        lb.validator_set.verify_commit_light(
            self.chain_id, lb.signed_header.commit.block_id,
            lb.height(), lb.signed_header.commit)
        self.store.save(lb)
        self._initialized = True
        return lb

    # -- public verification API --

    async def verify_light_block_at_height(self, height: int,
                                           now_ns: int | None = None
                                           ) -> LightBlock:
        """Go reference client.go:445 VerifyLightBlockAtHeight."""
        if not self._initialized:
            await self.initialize()
        now_ns = self.now_fn() if now_ns is None else now_ns
        cached = self.store.get(height)
        if cached is not None:
            return cached
        latest_trusted = self.store.latest()
        assert latest_trusted is not None
        if height < latest_trusted.height():
            return await self._verify_backwards(height, now_ns)
        target = await self._from_primary(height)
        await self._verify_skipping(latest_trusted, target, now_ns)
        await self._detect_divergence(target, now_ns)
        return target

    async def _from_primary(self, height: int) -> LightBlock:
        """Fetch from the primary; on a TRANSPORT failure promote the
        first witness to primary and retry (Go reference client.go:975
        lightBlockFromPrimary + replacePrimaryProvider). The failed
        primary goes to the END of the witness list (a transient blip
        must not shrink the witness set until fork detection is off);
        the tries bound stops an all-dead provider set from cycling.
        BlockNotFoundError propagates unchanged: a height that does not
        exist yet is not grounds to burn a witness."""
        tries = 0
        while True:
            try:
                return await self.primary.light_block(height)
            except BlockNotFoundError:
                raise
            except (ProviderError, OSError) as e:
                tries += 1
                if not self.witnesses or tries > len(self.witnesses) + 1:
                    raise
                old, self.primary = self.primary, self.witnesses.pop(0)
                self.witnesses.append(old)
                logger.warning(
                    "primary %r failed (%s); promoting witness %r "
                    "(failed primary demoted to witness)",
                    old, e, self.primary)

    async def _verify_backwards(self, height: int,
                                now_ns: int) -> LightBlock:
        """Hash-chain walk DOWN from the nearest trusted block above
        `height` (Go reference client.go:905 backwards +
        verifier.go:196): each interim header must be the one the
        (already verified) header above links to via last_block_id. No
        signature checks — the linkage is the proof; the anchor must
        still be inside its trusting period."""
        # Anchor on the nearest TRUSTED block: the trusting-period
        # check applies to it, never to a cached interim (whose older
        # timestamp could fail the check while a valid anchor exists).
        anchor_h = min(h for h in self.store.heights() if h > height)
        cur = self.store.get(anchor_h)
        if cur.time() + self.trust_options.period_ns <= now_ns:
            raise LightClientError(
                f"anchor header {anchor_h} outside trusting period")
        while cur.height() > height:
            cached = self._interim_cache.get(cur.height() - 1)
            if cached is not None and cached.hash() == \
                    cur.signed_header.header.last_block_id.hash:
                cur = cached
                continue
            interim = await self._from_primary(cur.height() - 1)
            try:
                interim.validate_basic(self.chain_id)
                verify_backwards(interim.signed_header.header,
                                 cur.signed_header.header)
            except (LightClientError, ValueError) as e:
                raise LightClientError(
                    f"backwards verification failed at height "
                    f"{cur.height() - 1}: {e}") from e
            # Interim blocks are NOT persisted to the trusted store (Go
            # reference client.go: "Intermediate headers are not saved
            # to database"): the walk proves linkage only, their
            # commits were never verified. They go into the bounded
            # linkage cache; only the requested target is saved.
            if len(self._interim_cache) >= self._interim_cache_max:
                # evict oldest-inserted so cold ranges still cache
                self._interim_cache.pop(next(iter(self._interim_cache)))
            self._interim_cache[interim.height()] = interim
            cur = interim
        self.store.save(cur)
        return cur

    async def update(self, now_ns: int | None = None) -> LightBlock | None:
        """Verify the primary's latest header (Go reference client.go
        Update)."""
        if not self._initialized:
            await self.initialize()
        now_ns = self.now_fn() if now_ns is None else now_ns
        latest = await self._from_primary(0)
        trusted = self.store.latest()
        if trusted is not None and latest.height() <= trusted.height():
            return None
        await self._verify_skipping(self.store.latest(), latest, now_ns)
        await self._detect_divergence(latest, now_ns)
        return latest

    def trusted_light_block(self, height: int = 0) -> LightBlock | None:
        return self.store.latest() if height == 0 else \
            self.store.get(height)

    # -- skipping verification with bisection --

    async def _verify_skipping(self, trusted: LightBlock,
                               target: LightBlock, now_ns: int,
                               provider: Provider | None = None,
                               persist: bool = True) -> None:
        """Go reference client.go:683 verifySkipping. Iterative
        pivoting: keep a stack of unverified blocks; verify what we can
        against the current trusted head, bisect when trust is
        insufficient.

        `provider` supplies pivot blocks (default: the primary WITH
        failover); an EXPLICIT provider (the examination of a witness)
        is used as-is and must not trigger failover. `persist=False`
        verifies without touching the trusted store — a witness's
        conflicting header must never pollute it."""
        fetch = provider.light_block if provider is not None \
            else self._from_primary
        pending: list[LightBlock] = [target]
        cache: dict[int, LightBlock] = {target.height(): target}
        steps = 0
        while pending:
            steps += 1
            if steps > 200:  # 2^200 heights — unreachable honestly
                raise LightClientError("bisection did not converge")
            block = pending[-1]
            try:
                verify(self.chain_id, trusted, block,
                       self.trust_options.period_ns, now_ns,
                       self.trust_level)
            except NewValSetCantBeTrustedError:
                pivot_h = (trusted.height() + block.height()) // 2
                if pivot_h in (trusted.height(), block.height()) or \
                        pivot_h in cache:
                    raise  # can't split further: genuine failure
                pivot = await fetch(pivot_h)
                cache[pivot_h] = pivot
                pending.append(pivot)
                continue
            if persist:
                self.store.save(block)
            trusted = block
            pending.pop()

    # -- witness cross-checking --

    async def _detect_divergence(self, verified: LightBlock,
                                 now_ns: int) -> None:
        """Go reference light/detector.go:28 detectDivergence.

        A witness that merely DISAGREES is not yet an attack: it must
        PROVE its conflicting header from a block we both trust (Go
        detector.go:120). Witnesses that cannot prove their header are
        dropped and the loop continues (one bad witness must not DoS
        the client); a witness that proves a conflict means a real
        fork — evidence is built against both sides, submitted to the
        opposing providers, and DivergenceError (carrying the evidence)
        is raised. A result in UNCAUGHT re-raises first (module
        docstring)."""
        if not self.witnesses:
            return
        results = await asyncio.gather(
            *(self._compare_with_witness(i, w, verified)
              for i, w in enumerate(self.witnesses)),
            return_exceptions=True)
        for res in results:
            if isinstance(res, UNCAUGHT):
                raise res
        faulty: list = []
        try:
            for i, res in enumerate(results):
                if isinstance(res, DivergenceError):
                    outcome = await self._examine_divergence(res, now_ns)
                    if outcome == "proven":
                        raise res
                    if outcome == "unreachable":
                        # a transport blip is NOT proof the witness
                        # forged its header: keep it for a later check
                        logger.warning(
                            "witness %d diverged but became unreachable"
                            " during examination; keeping it", i)
                        continue
                    logger.warning(
                        "witness %d could not prove its conflicting "
                        "header; removing it", i)
                    faulty.append(self.witnesses[i])
                elif isinstance(res, BaseException):
                    logger.warning("witness %d unreachable: %r", i, res)
        finally:
            if faulty:
                self.witnesses = [w for w in self.witnesses
                                  if w not in faulty]

    async def _compare_with_witness(self, idx: int, witness: Provider,
                                    verified: LightBlock) -> None:
        wb = await witness.light_block(verified.height())
        if wb.hash() != verified.hash():
            raise DivergenceError(idx, wb, verified)

    async def _examine_divergence(self, div: DivergenceError,
                                  now_ns: int) -> str:
        """Try to verify the witness's conflicting block from the last
        height the witness and our (primary-derived) store agree on.
        Returns "proven" — after building + submitting attack evidence
        — when the witness proves a genuine fork; "unprovable" when it
        fails to prove its header (the caller drops it); "unreachable"
        when transport failures made examination impossible (the caller
        keeps the witness)."""
        witness = self.witnesses[div.witness_index]
        target_h = div.primary_block.height()
        common, reachable = await self._find_common_block(witness, target_h)
        if common is None:
            return "unprovable" if reachable else "unreachable"
        try:
            await self._verify_skipping(
                common, div.witness_block, now_ns,
                provider=witness, persist=False)
        except ProviderError:
            return "unreachable"  # pivot fetch failed, not a bad proof
        except (LightClientError, ValueError):
            # ValueError: structural validate_basic failures — the
            # witness's block is not even well-formed
            return "unprovable"
        except (OSError, asyncio.TimeoutError):
            return "unreachable"
        await self._report_attack(common, div, witness)
        # The fork is PROVEN: every primary-derived block above the
        # common height may be the attacker's — including the target
        # already saved by _verify_skipping. Purge them so later calls
        # cannot serve the forged chain from the store.
        for h in self.store.heights():
            if h > common.height():
                self.store.delete(h)
        return "proven"

    async def _find_common_block(self, witness: Provider, below: int
                                 ) -> tuple[LightBlock | None, bool]:
        """Latest stored (trusted) block strictly below `below` whose
        hash the witness also reports (Go detector.go walks the primary
        trace backwards the same way). Second element is False when
        EVERY witness fetch failed — total unreachability, which the
        caller must not confuse with "no common block exists"."""
        any_response = False
        for h in sorted(self.store.heights(), reverse=True):
            if h >= below:
                continue
            ours = self.store.get(h)
            if ours is None:
                continue
            try:
                theirs = await witness.light_block(h)
            except UNCAUGHT:
                raise
            except Exception:
                # a transient failure at ONE height must not make a
                # genuine fork look "unprovable": keep walking down
                continue
            any_response = True
            if theirs.hash() == ours.hash():
                return ours, True
        return None, any_response

    async def _report_attack(self, common: LightBlock,
                             div: DivergenceError,
                             witness: Provider) -> None:
        """Build LightClientAttackEvidence for BOTH sides of the fork
        and hand each to the opposing provider (Go detector.go:234
        handleConflictingHeaders): each full node verifies the evidence
        against its own chain and discards the half that matches it."""
        from .types import (
            LightClientAttackEvidence, compute_byzantine_validators,
        )

        def build(conflicting: LightBlock, trusted: LightBlock):
            return LightClientAttackEvidence(
                conflicting_block=conflicting,
                common_height=common.height(),
                byzantine_validators=compute_byzantine_validators(
                    common.validator_set,
                    trusted.signed_header,
                    conflicting,
                ),
                total_voting_power=common.validator_set.total_voting_power(),
                timestamp=common.time(),
            )

        ev_vs_witness = build(div.witness_block, div.primary_block)
        ev_vs_primary = build(div.primary_block, div.witness_block)
        div.evidence = [ev_vs_witness, ev_vs_primary]
        for provider, ev in ((self.primary, ev_vs_witness),
                             (witness, ev_vs_primary)):
            try:
                await provider.report_evidence(ev)
            except UNCAUGHT:
                raise
            except Exception as e:  # best-effort: the fork is already fatal
                logger.warning("could not report evidence to %s: %r",
                               provider.provider_id(), e)
