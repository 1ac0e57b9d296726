"""ValidatorSet: proposer rotation + batched commit verification
(reference: types/validator_set.go).

Every verify_commit* variant collects its exact verification set first
and executes it as ONE device batch with per-lane verdicts. Large
all-ed25519 sets route through crypto/cuda/expanded.py: per-validator
comb tables cached on the GPU across heights, with the sign bytes
assembled on the device. A device failure on that path (an error the
breakers catch: a device-health CUDA code, or any error that is not
the port's own, crypto/batch.py) opens the ed25519 breaker and the
batch degrades to the BatchVerifier, which itself degrades device ->
host; a commit verify never fails for a device's sake. A fault of the
port's kernels (KernelError: a build, a launch, or a CUDA code such as
an illegal address seen at the sync before the readback) raises."""

from __future__ import annotations

import logging

from ..crypto import merkle
from ..crypto.batch import BatchVerifier
from .block import BlockID
from .validator import Validator

logger = logging.getLogger("types.validator_set")

MAX_TOTAL_VOTING_POWER = (1 << 62) // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2
# Lanes at/above this go through the expanded per-validator comb
# tables (crypto/cuda/expanded.py MIN_EXPAND); below it the general
# batch kernel / host path wins because the table build and residency
# don't amortize.
_EXPAND_MIN = 128


class VerificationError(Exception):
    pass


class CommitVerifyPlan:
    """One commit-check decomposed into its signature lanes BEFORE any
    cryptography runs: the selection loops of verify_commit_light /
    verify_commit_light_trusting (power tally, address matching, the
    insufficient-power rejections) produce a plan, and the signature
    work is a separate step. The split lets the light-client verify
    collector (light/serving.py LightVerifyCollector) coalesce the
    lanes of many independent plans into a single wide device launch,
    while the classic verify_commit* methods just plan + execute
    inline."""

    __slots__ = ("valset", "lanes", "slots", "sigs", "msgs")

    def __init__(self, valset: "ValidatorSet", lanes: list[int],
                 slots: list[int], sigs: list[bytes], msgs):
        self.valset = valset
        self.lanes = lanes    # indices into valset.validators (tables)
        self.slots = slots    # commit signature slots (error reports)
        self.sigs = sigs
        self.msgs = msgs      # list[bytes] | StructuredSignBytes

    def __len__(self) -> int:
        return len(self.lanes)

    def triples(self) -> list[tuple]:
        """(pub_key, sign_bytes, signature) per lane, msgs
        materialized — the form a cross-plan batch consumes (different
        plans may come from different validator sets, so the shared
        launch uses the general per-lane-key kernel, not this set's
        expanded tables)."""
        from .sign_batch import StructuredSignBytes

        msgs = self.msgs.materialize() \
            if isinstance(self.msgs, StructuredSignBytes) else self.msgs
        return [(self.valset.validators[i].pub_key, m, s)
                for i, m, s in zip(self.lanes, msgs, self.sigs)]

    def raise_invalid(self, verdicts) -> None:
        """Map per-lane verdicts back to commit slots; raise the same
        VerificationError the inline verify_commit* paths produce."""
        bad = [self.slots[i] for i in range(len(self.slots))
               if not verdicts[i]]
        if bad:
            raise VerificationError(
                f"invalid signature(s) at index(es) {bad}")

    def execute(self) -> None:
        """Verify this plan alone (the classic inline path): one
        batch through the owning set's expanded tables / BatchVerifier."""
        ok, verdicts = self.valset._batch_verify_lanes(
            self.lanes, self.msgs, self.sigs)
        if not ok:
            self.raise_invalid(verdicts)


class ValidatorSet:
    def __init__(self, validators: list[Validator]):
        self._total: int | None = None
        self._addr_cache: dict = {}
        self._addr_cache_src: list | None = None
        if validators:
            vals = [v.copy() for v in validators]
            vals.sort(key=lambda v: (-v.voting_power, v.address))
            self.validators = vals
            self.proposer: Validator | None = None
            self._increment_proposer_priority(1)
        else:
            self.validators = []
            self.proposer = None

    # -- queries --

    def __len__(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total is None:
            self._total = sum(v.voting_power for v in self.validators)
            if self._total > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power exceeds cap")
        return self._total

    def _addr_index(self) -> dict:
        """address -> index map, rebuilt when the validators list is
        replaced or grows (callers outside this class assign/append to
        .validators directly, so validity is keyed on the list object
        + its length rather than on construction sites). Turns the
        trusting check's per-signature address lookups from O(n) scans
        into O(1) at the 10k-validator design point (the reference
        keeps sorted order + binary search, validator_set.go:646)."""
        vals = self.validators
        if self._addr_cache_src is not vals or \
                len(self._addr_cache) != len(vals):
            self._addr_cache = {v.address: i for i, v in enumerate(vals)}
            self._addr_cache_src = vals
        return self._addr_cache

    def get_by_address(self, addr: bytes) -> tuple[int, Validator | None]:
        i = self._addr_index().get(addr, -1)
        return (i, self.validators[i]) if i >= 0 else (-1, None)

    def get_by_index(self, i: int) -> Validator | None:
        if 0 <= i < len(self.validators):
            return self.validators[i]
        return None

    def has_address(self, addr: bytes) -> bool:
        return self.get_by_address(addr)[0] >= 0

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [v.bytes_for_hash() for v in self.validators]
        )

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet([])
        vs.validators = [v.copy() for v in self.validators]
        if self.proposer is not None:
            i, _ = self.get_by_address(self.proposer.address)
            vs.proposer = vs.validators[i] if i >= 0 else self.proposer.copy()
        vs._total = self._total
        return vs

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is None:
            raise ValueError("no proposer")

    # -- proposer rotation (reference: validator_set.go:110-230) --

    def increment_proposer_priority(self, times: int) -> None:
        if times <= 0:
            raise ValueError("times must be positive")
        self._increment_proposer_priority(times)

    def _increment_proposer_priority(self, times: int) -> None:
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self._rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        prop = None
        for _ in range(times):
            prop = self._single_increment()
        self.proposer = prop

    def _single_increment(self) -> Validator:
        for v in self.validators:
            v.proposer_priority += v.voting_power
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        mostest.proposer_priority -= self.total_voting_power()
        return mostest

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0 or not self.validators:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                # truncated (toward-zero) division, matching Go int64 /
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _shift_by_avg_proposer_priority(self) -> None:
        if not self.validators:
            return
        total = sum(v.proposer_priority for v in self.validators)
        n = len(self.validators)
        avg = total // n if total >= 0 else -((-total) // n)  # trunc toward 0
        for v in self.validators:
            v.proposer_priority -= avg

    def get_proposer(self) -> Validator:
        assert self.validators
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def _find_proposer(self) -> Validator:
        mostest = self.validators[0]
        for v in self.validators[1:]:
            mostest = mostest.compare_proposer_priority(v)
        return mostest

    # -- commit verification (batched; the hot path) --

    def _use_expanded(self, lanes: list[int]) -> bool:
        """Will _batch_verify_lanes take the expanded device path?"""
        from ..crypto import batch as _batch
        from ..crypto.cuda import verify as tv

        if not (_EXPAND_MIN <= len(lanes) <= tv._MAX_BATCH
                and _batch.device_available("ed25519")):
            return False
        try:
            from ..crypto.cuda import expanded

            cap = expanded.max_keys()
        except _batch.UNCAUGHT:
            raise
        except Exception:
            # a broken device runtime degrades to the general path
            # (with the breaker's cooldown), not a failed commit verify
            _batch.mark_device_failed("ed25519")
            logger.exception("device probe for the expanded path failed")
            return False
        return (len(self.validators) <= cap
                and all(self.validators[i].pub_key.type_name == "ed25519"
                        for i in lanes))

    def warm_device_tables(self):
        """Kick a background build of this set's expanded device tables
        (crypto/cuda/expanded.py warm_async) if commit verifies for it
        would use them. Returns the thread or None."""
        if not self._use_expanded(list(range(len(self.validators)))):
            return None
        from ..crypto.cuda import expanded

        return expanded.warm_async(
            [v.pub_key.bytes() for v in self.validators])

    def structured_or_bytes(self, lanes: list[int], build, materialize):
        """THE structured-vs-full-bytes policy, one copy for every
        call site:
        build() -> a types.sign_batch.StructuredSignBytes when the
        expanded device path will consume it; ValueError from build
        (hostile timestamps, too many template groups, oversized sign
        bytes) means the input doesn't fit the vectorized layout —
        fall back to materialize()'s full bytes SILENTLY, because
        that's an input property, not a bug."""
        if self._use_expanded(lanes):
            try:
                return build()
            except ValueError:
                pass
        return materialize()

    def _commit_msgs(self, chain_id: str, commit, slots: list[int],
                     lanes: list[int]):
        """Sign bytes for the given commit slots: structured when the
        device path will consume it, materialized otherwise."""
        if not slots:
            return []
        from .sign_batch import CommitSignBatch

        return self.structured_or_bytes(
            lanes,
            lambda: CommitSignBatch(chain_id, commit, slots),
            lambda: [commit.vote_sign_bytes(chain_id, s) for s in slots],
        )

    def _batch_verify_lanes(self, lanes: list[int], msgs,
                            sigs: list[bytes]):
        """One device batch over (self.validators[lanes[i]], msgs[i],
        sigs[i]). Large all-ed25519 sets go through the expanded
        per-validator comb tables (cached on the device across heights,
        crypto/cuda/expanded.py); everything else through the general
        BatchVerifier.

        msgs is either a list of sign-byte blobs or a
        types.sign_batch.StructuredSignBytes, whose bytes the expanded
        path assembles on the device; the bytes fallback materializes
        the identical full bytes."""
        from .sign_batch import StructuredSignBytes

        structured = isinstance(msgs, StructuredSignBytes)
        # structured implies _use_expanded held when the batch was
        # built (_commit_msgs) — don't repeat the O(n) key-type scan.
        if structured or self._use_expanded(lanes):
            from ..crypto import batch as _batch
            from ..crypto.cuda import expanded
            from ..libs import failpoints

            try:
                failpoints.hit("device.verify")
                exp = expanded.get_expanded(
                    [v.pub_key.bytes() for v in self.validators])
                if structured:
                    try:
                        verdicts = exp.verify_structured(lanes, msgs, sigs)
                    except ValueError:
                        # structural limit (oversized templates / sign
                        # bytes), an input property: the same kernels
                        # on the full bytes. Logged loudly — if the
                        # lane-0 self-check fired, a template bug must
                        # surface.
                        logger.exception(
                            "structured commit verify rejected the batch "
                            "(%d lanes); using full-bytes form",
                            len(lanes))
                        verdicts = exp.verify(lanes, msgs.materialize(),
                                              sigs)
                else:
                    verdicts = exp.verify(lanes, msgs, sigs)
                return bool(verdicts.all()), verdicts
            except _batch.UNCAUGHT:
                raise
            except Exception:
                # a device that fails mid-verify (a kernel's own
                # fault is UNCAUGHT and raises): the BatchVerifier
                # (which itself degrades device -> host) instead of a
                # failed commit verify
                _batch.mark_device_failed("ed25519")
                logger.exception("expanded-valset verify failed (%d "
                                 "lanes); degrading", len(lanes))
        if structured:
            msgs = msgs.materialize()
        bv = BatchVerifier()
        for i, m, s in zip(lanes, msgs, sigs):
            bv.add(self.validators[i].pub_key, m, s)
        return bv.verify()

    def verify_commit(self, chain_id: str, block_id: BlockID, height: int,
                      commit) -> None:
        """Verify ALL non-absent signatures; tally for-block power must
        exceed 2/3 (reference: validator_set.go:662)."""
        self._check_commit_basics(block_id, height, commit)
        lanes: list[int] = []
        sigs: list[bytes] = []
        tallied = 0
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            val = self.validators[idx]
            if cs.validator_address and cs.validator_address != val.address:
                raise VerificationError(
                    f"wrong validator address in slot {idx}"
                )
            lanes.append(idx)
            sigs.append(cs.signature)
            if cs.for_block():
                tallied += val.voting_power
        msgs = self._commit_msgs(chain_id, commit, lanes, lanes)
        ok, verdicts = self._batch_verify_lanes(lanes, msgs, sigs)
        if not ok:
            bad = [lanes[i] for i in range(len(lanes)) if not verdicts[i]]
            raise VerificationError(f"invalid signature(s) at index(es) {bad}")
        if 3 * tallied <= 2 * self.total_voting_power():
            raise VerificationError(
                f"insufficient voting power: {tallied} of {self.total_voting_power()}"
            )

    def plan_commit_light(self, chain_id: str, block_id: BlockID,
                          height: int, commit) -> CommitVerifyPlan:
        """Selection half of verify_commit_light: basics + the
        cheapest 2/3 of for-block power, NO signature work. Raises
        VerificationError before planning any cryptography when the
        power cannot reach the threshold."""
        self._check_commit_basics(block_id, height, commit)
        lanes: list[int] = []
        sigs: list[bytes] = []
        tallied = 0
        need = 2 * self.total_voting_power()
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val = self.validators[idx]
            lanes.append(idx)
            sigs.append(cs.signature)
            tallied += val.voting_power
            if 3 * tallied > need:
                break
        if 3 * tallied <= need:
            raise VerificationError(
                f"insufficient voting power: {tallied} of {self.total_voting_power()}"
            )
        msgs = self._commit_msgs(chain_id, commit, lanes, lanes)
        return CommitVerifyPlan(self, lanes, lanes, sigs, msgs)

    def verify_commit_light(self, chain_id: str, block_id: BlockID,
                            height: int, commit) -> None:
        """Verify only the for-block signatures needed to pass 2/3
        (reference: validator_set.go:720) — as one batch."""
        self.plan_commit_light(chain_id, block_id, height,
                               commit).execute()

    def plan_commit_trusting(self, chain_id: str, commit,
                             trust_num: int,
                             trust_den: int) -> CommitVerifyPlan:
        """Selection half of verify_commit_light_trusting: address
        matching + the trust-level power tally, NO signature work.
        Raises VerificationError (insufficient trusted power / double
        vote) before planning any cryptography."""
        if trust_den <= 0 or trust_num <= 0 or trust_num > trust_den:
            raise ValueError("invalid trust level")
        lanes: list[int] = []  # OUR validator indices (for the tables)
        slots: list[int] = []  # commit slots (for sign bytes/errors)
        sigs: list[bytes] = []
        tallied = 0
        need = self.total_voting_power() * trust_num
        seen: set[int] = set()
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            vi, val = self.get_by_address(cs.validator_address)
            if vi < 0:
                continue
            if vi in seen:
                raise VerificationError("double vote from same validator")
            seen.add(vi)
            lanes.append(vi)
            slots.append(idx)
            sigs.append(cs.signature)
            tallied += val.voting_power
            if tallied * trust_den > need:
                break
        if tallied * trust_den <= need:
            raise VerificationError(
                f"insufficient trusted power: {tallied}"
            )
        msgs = self._commit_msgs(chain_id, commit, slots, lanes)
        return CommitVerifyPlan(self, lanes, slots, sigs, msgs)

    def verify_commit_light_trusting(self, chain_id: str, commit,
                                     trust_num: int, trust_den: int) -> None:
        """Trust-fraction variant for light-client skipping verification
        (reference: validator_set.go:776). Validators are matched by
        ADDRESS (the commit came from a possibly newer set)."""
        self.plan_commit_trusting(chain_id, commit, trust_num,
                                  trust_den).execute()

    def _check_commit_basics(self, block_id: BlockID, height: int, commit) -> None:
        if commit is None:
            raise VerificationError("nil commit")
        if len(self.validators) != len(commit.signatures):
            raise VerificationError(
                f"commit has {len(commit.signatures)} sigs, valset has "
                f"{len(self.validators)}"
            )
        if height != commit.height:
            raise VerificationError(f"commit height {commit.height} != {height}")
        if commit.block_id != block_id:
            raise VerificationError("commit is for a different block")

    def __repr__(self) -> str:
        return f"ValidatorSet(n={len(self.validators)}, power={self.total_voting_power()})"
