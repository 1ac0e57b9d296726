"""Byzantine validator catalog for the scenario factory (reference:
tendermint_tpu/sim/byzantine.py).

Each kind is a named, seeded behaviour a scenario assigns to a node
index. Two mechanisms, matching where real byzantine conduct lives:

  * CONSENSUS-level misbehaviors (consensus/misbehavior.py hooks):
    conflicting artifacts signed with the validator's raw key —
    `equivocation` (DoublePrevote) and `double_propose`. Honest peers
    assemble DuplicateVoteEvidence and commit it.
  * TRANSPORT-seam conduct filters (Switch.peer_wrapper, installed by
    sim/harness.py): every outbound (channel, message) passes through
    the node's conduct function, which may drop, mutate or re-sign —
    `withhold_parts`, `bad_signature_flood`, `timestamp_skew` — plus
    driver TASKS that originate traffic (`garbage_flood`).

Honest nodes see the conduct through the surfaces the production
stack already defends: undecodable garbage kills the peer via the
reactor error path; invalid vote signatures debit the peer's EWMA
trust metric (behaviour.py) until the score collapses below
STOP_SCORE and the switch disconnects it; withheld parts cost the
round a propose timeout; skewed-but-validly-signed timestamps poison
byte-exact speculation templates and skew medians without tripping
any signature check.

tools/check_scenarios.py lints this registry against the named
scenario call sites, the docs/CHAOS.md byzantine table, and tests.
"""

from __future__ import annotations

import asyncio
import copy

from ..consensus import messages as m
from ..consensus.misbehavior import DoublePrevote, DoublePropose
from ..consensus.reactor import DATA_CHANNEL, VOTE_CHANNEL
from ..statesync import messages as ssm
from ..statesync.reactor import CHUNK_CHANNEL, SNAPSHOT_CHANNEL


def wrap_peer_conduct(peer, conduct):
    """Patch a Peer so every outbound message routes through
    `conduct(chan_id, msg_bytes) -> [(chan_id, msg_bytes), ...]`
    (empty list = silently withheld; >1 = extra injected traffic)."""
    orig_try, orig_send = peer.try_send, peer.send

    def try_send(chan_id: int, msg: bytes) -> bool:
        ok = True
        for c, b in conduct(chan_id, msg):
            ok = orig_try(c, b) and ok
        return ok

    async def send(chan_id: int, msg: bytes) -> bool:
        ok = True
        for c, b in conduct(chan_id, msg):
            ok = (await orig_send(c, b)) and ok
        return ok

    peer.try_send = try_send
    peer.send = send
    return peer


def compose_conduct(filters):
    def conduct(chan_id: int, msg: bytes):
        outs = [(chan_id, msg)]
        for f in filters:
            nxt = []
            for c, b in outs:
                nxt.extend(f(c, b))
            outs = nxt
        return outs

    return conduct


class Byzantine:
    """Base: spec is a plain dict from the scenario (seed-derived rng
    supplied by the runner). Subclasses override install()/driver()."""

    kind = ""

    def __init__(self, spec: dict, rng):
        self.spec = dict(spec)
        self.rng = rng

    def heights(self) -> set:
        return set(self.spec.get("heights", ()))

    def window(self) -> tuple[float, float]:
        return (float(self.spec.get("from_t", 0.0)),
                float(self.spec.get("until_t", float("inf"))))

    def conduct_filter(self, node):
        return None

    def install(self, node) -> None:
        f = self.conduct_filter(node)
        if f is not None:
            node.conduct = (f if node.conduct is None
                            else compose_conduct([node.conduct, f]))

    def driver(self, node):
        """Optional coroutine the runner spawns for the scenario's
        lifetime (traffic-originating kinds)."""
        return None


BYZANTINE_KINDS: dict[str, type] = {}


def register(cls):
    BYZANTINE_KINDS[cls.kind] = cls
    return cls


def make_byzantine(spec: dict, rng) -> Byzantine:
    kind = spec.get("kind")
    cls = BYZANTINE_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown byzantine kind {kind!r} "
                         f"(catalog: {sorted(BYZANTINE_KINDS)})")
    return cls(spec, rng)


@register
class Equivocation(Byzantine):
    """Double-prevote (block AND nil) at the scheduled heights; honest
    peers cross-gossip the conflict into DuplicateVoteEvidence."""

    kind = "equivocation"

    def install(self, node) -> None:
        super().install(node)
        for h in self.heights():
            node.misbehavior_schedule[h] = DoublePrevote()


@register
class DoubleProposeByz(Byzantine):
    """Sign two conflicting proposals for one height when proposer."""

    kind = "double_propose"

    def install(self, node) -> None:
        super().install(node)
        for h in self.heights():
            node.misbehavior_schedule[h] = DoublePropose()


@register
class WithholdParts(Byzantine):
    """Withhold block parts at the scheduled heights: proposals go out
    but no part ever follows, so honest peers burn the propose timeout
    and the round advances to the next proposer."""

    kind = "withhold_parts"

    def conduct_filter(self, node):
        heights = self.heights()

        def f(chan_id: int, msg: bytes):
            if chan_id == DATA_CHANNEL:
                try:
                    decoded = m.decode_consensus_msg(msg)
                except Exception:
                    return [(chan_id, msg)]
                if isinstance(decoded, m.BlockPartMessage) and \
                        decoded.height in heights:
                    return []
            return [(chan_id, msg)]

        return f


@register
class BadSignatureFlood(Byzantine):
    """Corrupt the signature of every vote this node sends (its own
    AND relayed gossip) inside the virtual-time window. Well-formed,
    decodable, verify-fail votes — the soft-fault shape that debits
    the sender's trust metric on every honest peer until the EWMA
    score collapses below behaviour.STOP_SCORE and the switch
    disconnects it."""

    kind = "bad_signature_flood"

    def conduct_filter(self, node):
        start, until = self.window()

        def f(chan_id: int, msg: bytes):
            if chan_id != VOTE_CHANNEL:
                return [(chan_id, msg)]
            now = asyncio.get_running_loop().time()
            if not start <= now < until:
                return [(chan_id, msg)]
            try:
                decoded = m.decode_consensus_msg(msg)
            except Exception:
                return [(chan_id, msg)]
            if not isinstance(decoded, m.VoteMessage) or \
                    not decoded.vote.signature:
                return [(chan_id, msg)]
            vote = copy.copy(decoded.vote)
            sig = bytearray(vote.signature)
            sig[0] ^= 0xFF
            vote.signature = bytes(sig)
            return [(chan_id, m.encode_consensus_msg(m.VoteMessage(vote)))]

        return f


@register
class TimestampSkew(Byzantine):
    """Re-sign this node's own precommits with a skewed timestamp
    (valid signature, wrong time): the wrong-timestamp speculation
    poison — byte-exact verify-ahead templates on honest peers miss,
    and commit medians carry the skew — without tripping a single
    signature check."""

    kind = "timestamp_skew"

    def conduct_filter(self, node):
        skew_ns = int(self.spec.get("skew_ms", 300_000)) * 1_000_000
        heights = self.heights()
        addr = node.pv.get_pub_key().address()
        priv = node.pv.priv_key
        chain_id = node.gdoc.chain_id

        def f(chan_id: int, msg: bytes):
            if chan_id != VOTE_CHANNEL:
                return [(chan_id, msg)]
            try:
                decoded = m.decode_consensus_msg(msg)
            except Exception:
                return [(chan_id, msg)]
            if not isinstance(decoded, m.VoteMessage):
                return [(chan_id, msg)]
            vote = decoded.vote
            if vote.validator_address != addr or \
                    (heights and vote.height not in heights):
                return [(chan_id, msg)]
            skewed = copy.copy(vote)
            skewed.timestamp = vote.timestamp + skew_ns
            skewed.signature = priv.sign(skewed.sign_bytes(chain_id))
            return [(chan_id, m.encode_consensus_msg(m.VoteMessage(skewed)))]

        return f


@register
class SnapshotPoison(Byzantine):
    """Serve CORRUPTED snapshot chunks: every outbound ChunkResponse
    gets one bit flipped mid-payload (still decodable, wrong bytes).
    The statesync surface this exercises is attribution — a joining
    node's restore fails the trusted-app-hash check, the syncer
    rotates to single-source attempts, and THIS node ends up
    quarantined by name (pool ban + behaviour strike) while the
    restore completes from the honest holders. Advertisements stay
    honest: the poisoner wants to be picked."""

    kind = "snapshot_poison"

    def conduct_filter(self, node):
        start, until = self.window()

        def f(chan_id: int, msg: bytes):
            if chan_id != CHUNK_CHANNEL:
                return [(chan_id, msg)]
            now = asyncio.get_running_loop().time()
            if not start <= now < until:
                return [(chan_id, msg)]
            try:
                decoded = ssm.decode_ss_msg(msg)
            except Exception:
                return [(chan_id, msg)]
            if not isinstance(decoded, ssm.ChunkResponseMessage) or \
                    not decoded.chunk:
                return [(chan_id, msg)]
            bad = bytearray(decoded.chunk)
            bad[len(bad) // 2] ^= 0x40
            return [(chan_id, ssm.encode_ss_msg(ssm.ChunkResponseMessage(
                height=decoded.height, format=decoded.format,
                index=decoded.index, chunk=bytes(bad),
                missing=False)))]

        return f


@register
class SnapshotLiar(Byzantine):
    """Advertise snapshots at heights this node CANNOT serve: every
    outbound SnapshotsResponse is lifted by `lift` heights (hash and
    chunk count kept, so the advert looks plausible). A joining node
    ranks the lie best (higher height wins), but the state provider
    cannot light-verify the nonexistent height — the bogus snapshot is
    rejected without a byte of chunk traffic and the restore proceeds
    from the honest advertisements. The lie costs the liar a rejected
    snapshot, never the joiner's liveness."""

    kind = "snapshot_liar"

    def conduct_filter(self, node):
        lift = int(self.spec.get("lift", 1000))

        def f(chan_id: int, msg: bytes):
            if chan_id != SNAPSHOT_CHANNEL:
                return [(chan_id, msg)]
            try:
                decoded = ssm.decode_ss_msg(msg)
            except Exception:
                return [(chan_id, msg)]
            if not isinstance(decoded, ssm.SnapshotsResponseMessage):
                return [(chan_id, msg)]
            return [(chan_id, ssm.encode_ss_msg(
                ssm.SnapshotsResponseMessage(
                    height=decoded.height + lift, format=decoded.format,
                    chunks=decoded.chunks, hash=decoded.hash,
                    metadata=decoded.metadata)))]

        return f


@register
class GarbageFlood(Byzantine):
    """Originate undecodable garbage on the vote channel at `rate`
    frames per virtual second inside the window. Honest reactors fail
    to decode, the switch kills the connection on the spot, and the
    byzantine node's persistent redial brings it back for more — the
    net must keep committing through the churn."""

    kind = "garbage_flood"

    def driver(self, node):
        start, until = self.window()
        rate = float(self.spec.get("rate", 20.0))
        rng = self.rng

        async def drive():
            loop = asyncio.get_running_loop()
            if loop.time() < start:
                await asyncio.sleep(start - loop.time())
            while loop.time() < until:
                if not node.running or node.switch is None:
                    await asyncio.sleep(0.5)
                    continue
                garbage = bytes(rng.getrandbits(8)
                                for _ in range(rng.randint(8, 64)))
                for peer in list(node.switch.peers.values()):
                    peer.try_send(VOTE_CHANNEL, garbage)
                await asyncio.sleep(1.0 / rate)

        return drive()
