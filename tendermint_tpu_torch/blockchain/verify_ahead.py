"""Fast-sync window verification + the verify-ahead pipeline
(reference: blockchain/verify_ahead.py).

The cross-block batch verification fast sync's hot loop runs
(`_batch_verify_window`: up to BATCH_WINDOW commits in one device
launch) plus the overlap engine that takes it off the apply path:
while window W's blocks are handled, window W+1's signature batch —
its verdicts fully determined by the already-buffered blocks — runs
concurrently in an executor thread (`WindowPipeline`). Steady-state
catch-up then pays max(verify, apply) per window instead of their sum.

On the GPU a window of one all-ed25519 set is one structured K3 launch
(csrc/xverify.cu) over the set's cached comb tables, one template group
per commit (types/sign_batch.py MergedSignBatch), through the port's
verify ladder (ValidatorSet.structured_or_bytes ->
_batch_verify_lanes). The job runs in an executor thread: its launches
go on that thread's current stream, and its readback synchronizes that
stream (crypto/cuda/kernels.py readback), so two jobs in flight at once
each read their own verdicts.

P2p-free: the pipeline is pure verification scheduling over buffered
blocks. Verdicts are computed by the same `_batch_verify_window`
either way, the consumer awaits them before using them, and a
prefetched window is keyed on (valset hash, heights, commit
identities) so a validator-set change or a re-fetched block discards
the stale verdicts instead of trusting them. A window's launches are
tagged ``workload("fastsync")`` in the launch ledger, and the executor
job runs under ``TRACER.wrap`` so its spans parent under the caller's.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto.cuda import ledger as _ledger
from ..libs import tracing
from ..types.block import BlockID
from ..types.validator_set import VerificationError

logger = logging.getLogger("blockchain")

BATCH_WINDOW = 16                 # blocks per device verification batch


def _batch_verify_window(vals, chain_id: str, items):
    """Verify the commits of several consecutive blocks — all signed by
    the SAME validator set — in one device batch. `items` is a list of
    (block_id, height, commit). Returns a list of per-block Exception
    or None, mirroring VerifyCommitLight's accept/reject per block
    (reference types/validator_set.go:720, batched across blocks).

    Large all-ed25519 sets go through the expanded comb tables with
    STRUCTURED sign bytes (one template group per block's commit,
    types/sign_batch.py MergedSignBatch). Everything else (or any
    structural/device failure) falls back to the general BatchVerifier
    with full bytes."""
    spans: list = []
    results: list = [None] * len(items)
    lanes_all: list[int] = []
    sigs_all: list[bytes] = []
    per_commit: list[tuple] = []  # (commit, slots) per verifiable block
    for i, (bid, height, commit) in enumerate(items):
        start = len(lanes_all)
        try:
            vals._check_commit_basics(bid, height, commit)
            need = 2 * vals.total_voting_power()
            tallied = 0
            slots: list[int] = []
            for idx, cs in enumerate(commit.signatures):
                if not cs.for_block():
                    continue
                val = vals.validators[idx]
                lanes_all.append(idx)
                slots.append(idx)
                sigs_all.append(cs.signature)
                tallied += val.voting_power
                if 3 * tallied > need:
                    break
            if 3 * tallied <= need:
                raise VerificationError(
                    f"insufficient voting power at height {height}")
            spans.append((i, start, len(lanes_all)))
            per_commit.append((commit, slots))
        except Exception as e:
            results[i] = e
            # roll back this block's lanes
            del lanes_all[start:]
            del sigs_all[start:]
    if not lanes_all:
        return results

    verdicts = _window_lane_verdicts(
        vals, chain_id, lanes_all, sigs_all, per_commit)
    for i, start, end in spans:
        if not bool(verdicts[start:end].all()):
            results[i] = VerificationError(
                f"invalid commit signature(s) for height "
                f"{items[i][1]}")
    return results


def _window_lane_verdicts(vals, chain_id, lanes_all, sigs_all, per_commit):
    """Per-lane verdicts for a window's collected lanes.

    Builds the merged structured batch (one template group per
    block's commit) when the expanded device path will consume it and
    the commits' values fit the vectorized layout — hostile values
    (e.g. a timestamp past int64, more than MAX_GROUPS commits) get
    full bytes instead, WITHOUT tripping a breaker, mirroring
    ValidatorSet._commit_msgs. The verify ladder itself (structured →
    bytes → host, device-failure degradation, logging) is owned by
    ValidatorSet._batch_verify_lanes — one copy for every call site."""
    from ..types.sign_batch import CommitSignBatch, MergedSignBatch

    msgs = vals.structured_or_bytes(
        lanes_all,
        lambda: MergedSignBatch([
            CommitSignBatch(chain_id, c, slots)
            for c, slots in per_commit
        ]),
        lambda: [c.vote_sign_bytes(chain_id, s)
                 for c, slots in per_commit for s in slots],
    )
    with _ledger.workload("fastsync"):
        _, verdicts = vals._batch_verify_lanes(lanes_all, msgs, sigs_all)
    return verdicts


def window_items(blocks) -> tuple[list[tuple], list]:
    """((block_id, height, commit) per verifiable block, the built
    PartSet per block) of a peeked window: block i is verified with
    block i+1's LastCommit. The part sets ride along so an apply loop
    reuses them for save_block — make_part_set is a full-block
    serialization and must run ONCE per block, in the executor."""
    items, parts_list = [], []
    for i in range(len(blocks) - 1):
        first, second = blocks[i], blocks[i + 1]
        parts = first.make_part_set()
        bid = BlockID(first.hash(), parts.header())
        items.append((bid, first.header.height, second.last_commit))
        parts_list.append(parts)
    return items, parts_list


class WindowPipeline:
    """The verify-ahead engine one fast-sync loop owns: hands out a
    window's verdicts (from a matching in-flight prefetch when one
    exists) and launches the NEXT window's verification concurrently
    with whatever the caller does next (handling the current window's
    blocks). This schedules the same verification earlier, nothing
    else."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._prefetch: tuple | None = None  # (key, future, blocks)
        self.prefetch_hits = 0

    @staticmethod
    def window_key(vals, blocks) -> tuple:
        """Identity of a verification window, computed from the RAW
        blocks (never via window_items — that serializes every block
        into a part set, far too heavy for an on-loop key probe): the
        valset it verified against plus the exact block/commit objects
        consumed. Object identity is safe because the prefetch entry
        itself holds the blocks, so ids cannot be recycled while it is
        alive."""
        return (vals.hash(),
                tuple(b.header.height for b in blocks[:-1]),
                tuple(id(b) for b in blocks[:-1]),
                tuple(id(b.last_commit) for b in blocks[1:]))

    def reset(self) -> None:
        """Pool replaced (statesync handoff etc.): any in-flight
        prefetch is over stale blocks."""
        self._prefetch = None

    @staticmethod
    def _verify_window_job(vals, chain_id, blocks):
        """The executor-side unit: build the window's items + part
        sets (the make_part_set serialization per block lives HERE,
        off the event loop) and batch-verify. Returns (items,
        parts_list, results) so the consumer — prefetch hit or not —
        reuses both instead of re-serializing the window."""
        items, parts_list = window_items(blocks)
        return (items, parts_list,
                _batch_verify_window(vals, chain_id, items))

    @staticmethod
    def _retrieve_stale(fut) -> None:
        """Done-callback for a DISCARDED prefetch (valset change /
        re-fetched window): retrieve + log its exception so a failed
        job neither vanishes silently nor leaves 'exception was never
        retrieved' noise at GC."""
        exc = fut.exception() if not fut.cancelled() else None
        if exc is not None:
            logger.warning("discarded verify-ahead window failed: %r",
                           exc)

    async def verdicts(self, vals, chain_id, blocks):
        """This window's (items, part sets, per-block verdicts):
        consumed from a matching prefetch when one is in flight, else
        verified now — item/part-set building AND the device batch run
        in an executor thread either way, so neither freezes the event
        loop."""
        key = self.window_key(vals, blocks)
        pf, self._prefetch = self._prefetch, None
        if pf is not None and pf[0] == key:
            self.prefetch_hits += 1
            return await pf[1]
        if pf is not None:
            # stale (valset changed / window shifted): discarded, but
            # never silently — see _retrieve_stale
            pf[1].add_done_callback(self._retrieve_stale)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, tracing.TRACER.wrap(self._verify_window_job), vals,
            chain_id, blocks)

    def start_ahead(self, vals, chain_id, peek, skip: int) -> None:
        """Launch the NEXT window's commit verification concurrently
        with the caller's handling of this one: `peek(n)` returns up to
        n contiguous buffered blocks, `skip` is the length of the window
        just verified (its last block is the next window's first)."""
        if not self.enabled or self._prefetch is not None:
            return
        ahead = peek(skip - 1 + BATCH_WINDOW + 1)
        nxt = ahead[skip - 1:]
        if len(nxt) < 2:
            return
        key = self.window_key(vals, nxt)
        fut = asyncio.get_running_loop().run_in_executor(
            None, tracing.TRACER.wrap(self._verify_window_job), vals,
            chain_id, nxt)
        self._prefetch = (key, fut, nxt)
