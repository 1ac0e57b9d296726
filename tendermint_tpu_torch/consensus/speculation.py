"""SpeculationPlane: verify-ahead commit pre-verification.

Commit verification sits on the block-commit critical path. This plane
takes it off that path by starting it before the commit is needed:

  1. As soon as height H's proposal BlockID is known, ``begin_height``
     pre-packs the TEMPLATE precommit sign bytes for every validator —
     within one commit the canonical (pre, suf) halves are fixed
     (types/canonical.py vote_sign_parts); only the timestamp varint
     varies per vote.
  2. As precommits arrive (``observe_precommit``), the matching lanes
     are patched — signature bytes + the <=24-byte timestamp patch —
     and each burst (``flush_sync``) is verified AHEAD of commit
     assembly: on the GPU through the persistent ResidentArena
     (crypto/cuda/resident.py: one K6 splice, one K7 launch, the
     known-answer sentinel lane checked every launch), or on the host
     below the device crossover.
  3. At commit time ``serve_commit`` answers from the completed
     launches after a BYTE-EXACT match per lane on the (timestamp,
     signature) the lane was verified against, which by the
     vote_sign_parts invariant equals byte equality of the full sign
     bytes. Any other lane (equivocation, unexpected timestamp, nil
     vote, straggler) re-verifies through ValidatorSet.
     _batch_verify_lanes, so correctness never depends on speculation:
     a full hit launches no verification at commit time; a miss costs
     exactly the lanes that missed.

The device path is breaker-aware (crypto/batch.py): a launch that
raises opens the ed25519 breaker and the batch re-verifies on the
host; a launch whose known-answer sentinel reads false does the same,
and on a MeshResidentArena (one sentinel a shard) only the lying
entries' breakers open, so the arena reshards over the survivors
(``ensure_mesh``) at the next launch and keeps serving on the device.

Reference: tendermint_tpu/consensus/speculation.py. Not in this slice
of the port: the asyncio flusher (drive ``flush_sync``), the
``consensus.speculate`` failpoint, tracing spans and metrics, and the
/status hook.
"""

from __future__ import annotations

import logging
import threading
from collections import deque

import numpy as np

from ..libs import failpoints
from ..types import canonical
from ..types.vote import VoteType

logger = logging.getLogger("consensus.speculation")

# Closed miss-reason set (the reference's speculation_misses labels).
MISS_NO_PLAN = "no_plan"            # no speculation for that commit
MISS_UNPATCHED = "unpatched"        # lane's precommit never observed
MISS_NIL = "nil_vote"               # nil lane: never speculated
MISS_MISMATCH = "mismatch"          # timestamp/signature differ
MISS_EQUIVOCATION = "equivocation"  # conflicting votes seen for lane
MISS_NOT_LAUNCHED = "not_launched"  # patched but no launch completed
MISS_REASONS = (MISS_NO_PLAN, MISS_UNPATCHED, MISS_NIL, MISS_MISMATCH,
                MISS_EQUIVOCATION, MISS_NOT_LAUNCHED)

_ORPHAN_RING = 2048  # precommits buffered before their proposal arrives


class _Lane:
    """One validator's speculated precommit. `ts` is the timestamp the
    lane was verified against; serve matches on it."""

    __slots__ = ("ts_obs", "ts", "sig", "verdict", "poisoned")

    def __init__(self, ts_obs: int, sig: bytes):
        self.ts_obs = ts_obs
        self.ts: int | None = None
        self.sig = sig
        self.verdict: bool | None = None
        self.poisoned = False


class _HeightSpec:
    """Everything speculated for one (height, round, block_id)."""

    __slots__ = ("chain_id", "height", "round", "block_id", "valset",
                 "valset_hash", "pre", "suf", "lanes", "other",
                 "pending")

    def __init__(self, chain_id, height, round_, block_id, valset):
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.block_id = block_id
        self.valset = valset
        self.valset_hash = valset.hash()
        self.pre, self.suf = canonical.vote_sign_parts(
            chain_id, int(VoteType.PRECOMMIT), height, round_, block_id)
        self.lanes: dict[int, _Lane] = {}
        self.other: set[int] = set()  # voted nil / a different block
        self.pending: list[tuple[int, int, bytes]] = []  # idx, ts, sig


class SpeculationPlane:
    """The verify-ahead plane one node owns: consensus feeds it
    (begin_height, observe_precommit), block validation serves from it
    (serve_commit)."""

    def __init__(self, config=None, *, device_min: int | None = None):
        from ..crypto import batch as cbatch

        self.arena_lanes = getattr(config, "arena_lanes", 12288)
        self.max_heights_ahead = getattr(config, "max_heights_ahead", 2)
        self.device_min = (cbatch._DEVICE_THRESHOLD
                           if device_min is None else device_min)
        self._lock = threading.Lock()
        self._launch_lock = threading.Lock()  # serializes arena use
        self._heights: dict[int, _HeightSpec] = {}
        self._orphans: deque = deque(maxlen=_ORPHAN_RING)
        self._arena = None
        self._arena_keys_hash: bytes | None = None
        self._arena_entry: _HeightSpec | None = None
        self.hits = 0
        self.misses: dict[str, int] = {r: 0 for r in MISS_REASONS}
        self.patched_lanes = 0

    def close(self) -> None:
        with self._lock:
            self._heights.clear()
            self._orphans.clear()

    # -- consensus-side feeds ------------------------------------------

    def begin_height(self, chain_id: str, valset, height: int,
                     round_: int, block_id) -> None:
        """The proposal BlockID for `height` is known: pre-pack the
        precommit sign-byte template and start accepting patches.
        Idempotent per (height, round, block_id); a re-proposal at a
        later round replaces the entry (new sign bytes)."""
        if block_id is None or block_id.is_zero():
            return
        with self._lock:
            cur = self._heights.get(height)
            if cur is not None and cur.round == round_ and \
                    cur.block_id == block_id:
                return
            try:
                entry = _HeightSpec(chain_id, height, round_, block_id,
                                    valset)
            except Exception:
                logger.exception("speculation template build failed "
                                 "(h=%d r=%d)", height, round_)
                return
            self._heights[height] = entry
            while len(self._heights) > self.max_heights_ahead + 1:
                evicted = min(self._heights)
                if evicted == height:
                    break
                del self._heights[evicted]
            # precommits that raced ahead of the proposal
            for v in list(self._orphans):
                if v.height == height:
                    self._observe_locked(entry, v)

    def observe_precommit(self, vote) -> None:
        """A verified-or-about-to-verify precommit arrived: patch its
        lane (or keep it until its height begins)."""
        with self._lock:
            entry = self._heights.get(vote.height)
            if entry is None:
                self._orphans.append(vote)
                return
            self._observe_locked(entry, vote)

    def _observe_locked(self, entry: _HeightSpec, vote) -> None:
        if vote.round != entry.round or not vote.signature:
            return
        idx = vote.validator_index
        if not 0 <= idx < len(entry.valset.validators):
            return
        bid = vote.block_id
        matches = bid is not None and not bid.is_nil() \
            and bid == entry.block_id
        lane = entry.lanes.get(idx)
        if not matches:
            # nil or different block: never speculated — and it
            # poisons any for-block lane from the same validator
            if lane is not None:
                lane.poisoned = True
            else:
                entry.other.add(idx)
            return
        if lane is not None:
            if lane.ts_obs != vote.timestamp or \
                    lane.sig != vote.signature:
                lane.poisoned = True  # equivocation
            return  # gossip duplicate: already patched
        lane = _Lane(vote.timestamp, vote.signature)
        if idx in entry.other:
            lane.poisoned = True  # saw a conflicting vote earlier
        entry.lanes[idx] = lane
        entry.pending.append((idx, vote.timestamp, vote.signature))
        self.patched_lanes += 1

    def retire_below(self, height: int) -> None:
        """Consensus moved to `height`: commits below height-1 can no
        longer be asked for."""
        with self._lock:
            for h in [h for h in self._heights if h < height - 1]:
                del self._heights[h]

    # -- the verify-ahead launches -------------------------------------

    def _drain(self) -> list[tuple[_HeightSpec, list]]:
        out = []
        with self._lock:
            for entry in self._heights.values():
                if entry.pending:
                    out.append((entry, entry.pending))
                    entry.pending = []
        return out

    def flush_sync(self) -> None:
        """Drain the pending lanes and verify them now, one batch per
        height."""
        for entry, batch in self._drain():
            self._launch_batch(entry, batch)

    def _launch_batch(self, entry: _HeightSpec, batch: list) -> None:
        verdicts = self._verify_lanes(entry, batch)
        if verdicts is None:
            return
        with self._lock:
            for (idx, ts_used, _sig), ok in zip(batch, verdicts):
                lane = entry.lanes.get(idx)
                if lane is None:
                    continue
                lane.ts = ts_used
                lane.verdict = bool(ok)

    def _verify_lanes(self, entry, kept):
        """Per-lane verdicts for a speculative batch: the GPU arena
        (sentinel-checked, breaker-aware) when the batch clears the
        crossover and the arena can carry it, the host otherwise.
        Returns None only when verification could not run at all
        (lanes stay verdict-less)."""
        from ..crypto import batch as cbatch

        n = len(kept)
        if n == 0:
            return []
        want_dev = n >= self.device_min and \
            all(0 <= ts < 1 << 63 for _, ts, _ in kept)
        if want_dev and cbatch.breaker("ed25519").acquire():
            try:
                out = self._device_verify(entry, kept)
                if out is not None:
                    return out
                # None: the arena cannot carry this batch by its inputs
                # — a healthy device, so not a host fallback
            except cbatch.UNCAUGHT:
                raise
            except Exception:
                cbatch.mark_device_failed("ed25519")
                logger.exception(
                    "speculative device launch failed (%d lanes); "
                    "breaker open %.1fs, degrading to host", n,
                    cbatch.breaker("ed25519").cooldown_remaining())
                cbatch.count("host_fallbacks")
        elif want_dev:
            # the device wanted but the breaker refused (open/probing)
            cbatch.count("host_fallbacks")
        return self._host_verify(entry, kept)

    def _host_verify(self, entry, kept):
        from ..crypto.batch import BatchVerifier

        try:
            bv = BatchVerifier(use_device=False)
            for idx, ts, sig in kept:
                bv.add(entry.valset.validators[idx].pub_key,
                       self._lane_sign_bytes(entry, ts), sig)
            return bv.verify()[1]
        except Exception:
            logger.exception("speculative host verify failed "
                             "(%d lanes)", len(kept))
            return None

    def _lane_sign_bytes(self, entry, ts: int) -> bytes:
        return canonical.vote_sign_bytes(
            entry.chain_id, int(VoteType.PRECOMMIT), entry.height,
            entry.round, entry.block_id, ts)

    def _device_verify(self, entry, kept):
        """One splice of the batch's lanes and one launch over the arena
        (K6 + K7; on a mesh arena K8: one of each a device). Returns
        verdicts aligned with `kept` — the host's, re-verified, when a
        sentinel failed — or None when the arena cannot carry this
        batch by its inputs (templates too big, valset over capacity, a
        key that is not ed25519, a signature that is not 64 bytes)."""
        from ..crypto import batch as cbatch
        from ..types import sign_batch as sbm

        if any(len(sig) != 64 for _, _, sig in kept):
            # the reference reaches its host path here too (through the
            # arena's failed reshape); every such lane verifies false
            return None
        with self._launch_lock:
            arena = self._ensure_arena(entry)
            if arena is None:
                return None
            n = len(kept)
            ts_arr = np.asarray([ts for _, ts, _ in kept], np.int64)
            group = np.ones(n, np.int32)
            patch, split, patch_len = sbm._build_patches(
                arena.pre_len.astype(np.int64), arena.suf_len, group,
                ts_arr)
            mlen = int(patch_len.max()) + len(entry.pre) \
                + len(entry.suf)
            if mlen > arena.width - 17:
                return None
            # lane-0 self-check: the structured reassembly must equal
            # the independently built canonical bytes
            a0, p0 = int(split[0]), int(patch_len[0])
            got = (bytes(patch[0, :a0]) + entry.pre
                   + bytes(patch[0, a0:p0]) + entry.suf)
            if got != self._lane_sign_bytes(entry, int(ts_arr[0])):
                raise ValueError(
                    "speculative structured sign-bytes self-check "
                    "failed")
            failpoints.hit("device.verify")
            arena.splice([idx + 1 for idx, _, _ in kept],
                         np.frombuffer(b"".join(s for _, _, s in kept),
                                       np.uint8).reshape(n, 64),
                         patch, split, patch_len, group)
            out = arena.launch()
            if not out[0]:
                # a wrong-verdict device: open a breaker and re-verify
                # on the host rather than keep garbage verdicts. A mesh
                # arena names the shards whose sentinel broke, and only
                # those entries are evicted; a single arena cannot
                # attribute, so the backend breaker opens.
                failed = getattr(arena, "failed_shards", lambda: [])()
                names = [name for _, name in failed]
                cbatch.mark_device_failed("ed25519", device=names or None,
                                          reason="sentinel")
                logger.error(
                    "speculative launch (%d lanes) failed its known-answer "
                    "sentinel%s; re-verifying on the host", n,
                    " on " + ", ".join(f"shard {i} ({name})"
                                       for i, name in failed)
                    if failed else "")
                cbatch.count("host_rechecks")
                cbatch.count("host_fallbacks")
                return self._host_verify(entry, kept)
            return [bool(out[idx + 1]) for idx, _, _ in kept]

    def _ensure_arena(self, entry: _HeightSpec):
        from ..crypto.cuda.resident import PRE_W, SUF_W, make_arena

        if len(entry.valset.validators) + 1 > self.arena_lanes:
            return None
        if len(entry.pre) > PRE_W or len(entry.suf) > SUF_W:
            return None
        if any(v.pub_key.type_name != "ed25519"
               for v in entry.valset.validators):
            # the arena kernel is ed25519-only; mixed sets go host-side
            return None
        if self._arena is None:
            # arena shards over the mesh when there is one: each splice
            # uploads a device's ~1/D of the deltas, and every shard
            # carries its own known-answer sentinel
            self._arena = make_arena(self.arena_lanes)
        elif getattr(self._arena, "ensure_mesh", None) is not None:
            # an entry was evicted (or re-admitted): the arena rebuilds
            # over the effective mesh, its keys replayed and templates
            # kept; this batch's lanes splice in below as they do at
            # every launch
            self._arena.ensure_mesh()
        if len(entry.valset.validators) + 1 > self._arena.capacity:
            return None
        if self._arena_keys_hash != entry.valset_hash:
            self._arena.install_keys(
                [v.pub_key.bytes() for v in entry.valset.validators])
            self._arena_keys_hash = entry.valset_hash
        if self._arena_entry is not entry:
            self._arena.deactivate_all()
            self._arena.set_template(1, entry.pre, entry.suf)
            self._arena_entry = entry
        return self._arena

    # -- the commit-time serve -----------------------------------------

    def serve_commit(self, valset, chain_id: str, block_id, height: int,
                     commit) -> bool:
        """verify_commit with speculated verdicts: byte-exact-matched
        lanes are served from the completed launches; every other lane
        re-verifies through ValidatorSet._batch_verify_lanes. Returns
        False (the caller runs the ordinary verify) only when nothing
        was speculated for this commit; True means the commit was fully
        checked here — with verify_commit's exact error behavior
        (VerificationError on bad signatures / insufficient power)."""
        from ..types.validator_set import VerificationError

        with self._lock:
            entry = self._heights.get(height)
            if entry is None or entry.chain_id != chain_id \
                    or entry.round != commit.round \
                    or entry.block_id != commit.block_id \
                    or entry.valset_hash != valset.hash():
                self.misses[MISS_NO_PLAN] += 1
                return False
            lanes = dict(entry.lanes)
        valset._check_commit_basics(block_id, height, commit)
        tallied = 0
        slots: list[int] = []
        verd: dict[int, bool] = {}
        miss: list[int] = []
        for idx, cs in enumerate(commit.signatures):
            if cs.is_absent():
                continue
            val = valset.validators[idx]
            if cs.validator_address and \
                    cs.validator_address != val.address:
                raise VerificationError(
                    f"wrong validator address in slot {idx}")
            slots.append(idx)
            if cs.for_block():
                tallied += val.voting_power
            lane = lanes.get(idx)
            if (cs.for_block() and lane is not None
                    and not lane.poisoned
                    and lane.verdict is not None
                    and lane.ts == cs.timestamp
                    and lane.sig == cs.signature):
                verd[idx] = lane.verdict
            else:
                miss.append(idx)
                self.misses[self._miss_reason(cs, lane)] += 1
        if miss:
            # per-lane fallback batch: one mismatched lane costs one
            # lane of re-verification; its batchmates keep their
            # speculated verdicts
            msgs = [commit.vote_sign_bytes(chain_id, s) for s in miss]
            sigs = [commit.signatures[s].signature for s in miss]
            _, fb = valset._batch_verify_lanes(miss, msgs, sigs)
            for s, ok in zip(miss, fb):
                verd[s] = bool(ok)
        bad = [s for s in slots if not verd[s]]
        if bad:
            raise VerificationError(
                f"invalid signature(s) at index(es) {bad}")
        if 3 * tallied <= 2 * valset.total_voting_power():
            raise VerificationError(
                f"insufficient voting power: {tallied} of "
                f"{valset.total_voting_power()}")
        if not miss:
            self.hits += 1
        return True

    @staticmethod
    def _miss_reason(cs, lane) -> str:
        if not cs.for_block():
            return MISS_NIL
        if lane is None:
            return MISS_UNPATCHED
        if lane.poisoned:
            return MISS_EQUIVOCATION
        if lane.verdict is None:
            return MISS_NOT_LAUNCHED
        return MISS_MISMATCH
