"""The port's vote micro-batch scheduler (consensus/state.py):
batch_verdicts against the reference's ConsensusState._batch_verdicts,
and VoteScheduler's rules in the shapes of tests/test_vote_scheduler.py.

batch_verdicts runs on the CPU plain versions: at 160 lanes the current
height's group takes the expanded structured route (a VoteSignBatch,
plain K1 and K3 with K2's assembly inside) and the late precommits'
group the host; at 64 lanes the bytes route through BatchVerifier (plain
K4). The reference's _batch_verdicts never reads its ConsensusState, so
it is called unbound with None; it runs with set_force_host(True), its
host route, which compiles no JAX kernel. Per-lane verdicts must be
equal, and equal to the oracle's.

The scheduler rules run a VoteScheduler on an asyncio loop at the
default config (a 2 ms window) over a HeightVoteSet, with a tally step
that mirrors the reference's ConsensusState._add_vote: a rejected lane
in a mixed batch, a raising launch degraded to the host off the loop,
duplicate suppression, the shed at vote_buf_max (our own vote on the
sync path), the per-peer trust feedback, the breaker's cooldown and
recovery, and the port's one divergence (a KernelError ends the task).
Tolerance: exact."""

import asyncio
import threading
import types

import numpy as np
import pytest
from test_torch_vote_set import CHAIN, PACKAGES, make_valset, make_vote

from tendermint_tpu.consensus.state import ConsensusState
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch.config import ConsensusConfig
from tendermint_tpu_torch.consensus import state as pstate
from tendermint_tpu_torch.consensus.cstypes import HeightVoteSet
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.cuda import kernels
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import clock
from tendermint_tpu_torch.libs.overload import CONTROLLER
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types.vote_set import (ConflictingVoteError,
                                                 VoteSet, VoteSetError)

P = PACKAGES["port"]
H = 5  # the scheduler's current height


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    pbatch.reset_breakers()
    set_default_device(None)


# -- batch_verdicts ------------------------------------------------------


def _batch(p, n: int):
    """n current-height votes (prevotes and precommits for a block,
    nil precommits of round 1) and 8 late precommits for H - 1 against
    a second set object with the same validators; three forged
    signatures and one timestamp changed after signing. Returns the
    scheduler batch [(vote, peer, pub_key, valset)]."""
    vals, so = make_valset(p, n)
    last = p.vset.ValidatorSet(vals.validators)
    rng = np.random.default_rng(n)
    batch = []
    for i in range(n):
        kind = int(rng.integers(3))
        vote = make_vote(p, vals, so, i, height=H,
                         bid=None if kind == 2 else 0xAA,
                         round_=int(kind == 2),
                         type_="PREVOTE" if kind == 0 else "PRECOMMIT",
                         ts=1_753_928_000_000_000_000 + 7919 * i)
        batch.append((vote, f"peer-{i % 3}", vals.validators[i].pub_key,
                      vals))
    for i in range(8):
        vote = make_vote(p, last, so, i, height=H - 1, bid=0xBB,
                         type_="PRECOMMIT")
        batch.append((vote, "peer-late", last.validators[i].pub_key, last))
    for j in (3, n // 2, n + 5):
        v = batch[j][0]
        v.signature = v.signature[:9] + bytes([v.signature[9] ^ 1]) + \
            v.signature[10:]
    batch[n - 2][0].timestamp += 1
    return batch


@pytest.mark.parametrize("n", [160, 64])
def test_batch_verdicts_equals_reference(n, monkeypatch):
    seen = []
    real = pvalidator_set.ValidatorSet._batch_verify_lanes

    def spy(self, lanes, msgs, sigs):
        seen.append((type(msgs).__name__, len(lanes)))
        return real(self, lanes, msgs, sigs)

    monkeypatch.setattr(pvalidator_set.ValidatorSet, "_batch_verify_lanes",
                        spy)
    port = pstate.batch_verdicts(_batch(P, n), CHAIN)
    prev = jbatch.set_force_host(True)
    try:
        want = ConsensusState._batch_verdicts(
            None, _batch(PACKAGES["reference"], n), CHAIN)
    finally:
        jbatch.set_force_host(prev)
    oracle = [ref.verify(pk.bytes(), v.sign_bytes(CHAIN), v.signature)
              for v, _, pk, _ in _batch(P, n)]
    assert port.tolist() == list(want) == oracle
    assert np.flatnonzero(~port).tolist() == sorted([3, n // 2, n - 2,
                                                     n + 5])
    # one group a set: the current height's structured at 160 lanes
    assert seen == [("VoteSignBatch" if n >= 128 else "list", n),
                    ("list", 8)]


# -- the scheduler -------------------------------------------------------


class Tally:
    """The reference's ConsensusState._try_add_vote/_add_vote, reduced
    to the tally: late precommits into the last commit, the rest into
    the height's vote sets; a conflict recorded as evidence material."""

    def __init__(self, sched):
        self.sched = sched
        self.calls = []        # (validator index, peer, preverified)
        self.conflicts = []

    async def __call__(self, vote, peer_id, preverified):
        self.calls.append((vote.validator_index, peer_id, preverified))
        s = self.sched
        try:
            if vote.height + 1 == s.height:
                return s.last_commit.add_vote(vote, verify=not preverified)
            if vote.height != s.height:
                return False
            return s.votes.add_vote(vote, peer_id, verify=not preverified)
        except ConflictingVoteError as e:
            self.conflicts.append((e.existing, e.new))
            return False
        except VoteSetError:
            return False


class Reporter:
    def __init__(self):
        self.observed, self.enforced = [], []

    def observe(self, peer_id, good=0, bad=0):
        self.observed.append((peer_id, good, bad))

    async def enforce(self, peer_id, reason):
        self.enforced.append((peer_id, reason))


def _scheduler(n: int = 4, **cfg):
    """A VoteScheduler at height H over an n-validator set (and a last
    commit for H - 1), its tally, the set and its seeds."""
    vals, so = make_valset(P, n)
    sched = pstate.VoteScheduler(ConsensusConfig(**cfg), CHAIN, None)
    tally = Tally(sched)
    sched._tally = tally
    sched.new_height(H, vals, HeightVoteSet(CHAIN, H, vals),
                     VoteSet(CHAIN, H - 1, 0, P.vote.VoteType.PRECOMMIT, vals))
    return sched, tally, vals, so


def _prevote(vals, so, i, **kw):
    return make_vote(P, vals, so, i, height=H, **kw)


async def _settle(sched, timeout: float = 30.0):
    """Wait until every queued vote is verified and tallied."""
    await asyncio.wait_for(sched.drain(), timeout)


def _tallied(sched, i, round_=0):
    return sched.votes.prevotes(round_).get_by_index(i) is not None


def task_alive(sched) -> bool:
    return sched.task is not None and not sched.task.done()


def test_mixed_batch_rejected_lane():
    """Valid and invalid signatures in one batch: the valid lanes tally,
    the corrupt lane is dropped, nothing raises."""
    async def go():
        sched, tally, vals, so = _scheduler()
        sched.start()
        v2 = _prevote(vals, so, 2)
        v2.signature = b"\x13" * 64
        for i, v in ((1, _prevote(vals, so, 1)), (2, v2),
                     (3, _prevote(vals, so, 3))):
            await sched.receive(v, "peerX")
        assert sched.pending() == 3  # one window, one batch
        await _settle(sched)
        assert [_tallied(sched, i) for i in (1, 2, 3)] == [True, False, True]
        assert sorted(tally.calls) == [(1, "peerX", True), (3, "peerX", True)]
        await sched.stop()

    asyncio.run(go())


def test_raising_launch_degrades_to_host_off_loop(monkeypatch):
    """A batch whose verify raises (a device error) must not kill the
    scheduler or lose votes: each vote re-verifies on the host in the
    executor, and a later batch takes the normal path again."""
    calls, threads = [], []

    def boom(batch, chain_id):
        calls.append(len(batch))
        raise RuntimeError("synthetic device failure")

    real_verify = P.ed.Ed25519PubKey.verify_signature

    def spy(self, msg, sig):
        threads.append(threading.current_thread() is threading.main_thread())
        return real_verify(self, msg, sig)

    async def go():
        sched, tally, vals, so = _scheduler()
        sched.start()
        monkeypatch.setattr(pstate, "batch_verdicts", boom)
        monkeypatch.setattr(P.ed.Ed25519PubKey, "verify_signature", spy)
        v2 = _prevote(vals, so, 2)
        v2.signature = b"\x13" * 64  # still rejected on the host path
        await sched.receive(_prevote(vals, so, 1), "peerX")
        await sched.receive(v2, "peerX")
        await _settle(sched)
        assert calls == [2] and threads == [False, False]
        assert _tallied(sched, 1) and not _tallied(sched, 2)
        monkeypatch.undo()
        await sched.receive(_prevote(vals, so, 3), "peerX")
        await _settle(sched)
        assert _tallied(sched, 3) and task_alive(sched)
        await sched.stop()

    asyncio.run(go())


def test_duplicate_suppression():
    """A gossip duplicate of a tallied vote never burns a lane, and two
    copies in the same batch tally once."""
    async def go():
        sched, tally, vals, so = _scheduler()
        sched.start()
        v1 = _prevote(vals, so, 1)
        await sched.receive(v1, "pA")
        await sched.receive(v1, "pB")
        assert sched.pending() == 2
        await _settle(sched)
        assert _tallied(sched, 1)
        assert [c[2] for c in tally.calls] == [True, True]  # 2nd: a no-op
        assert sched.enqueue(v1, "pC") is True
        assert sched.pending() == 0, "a tallied duplicate took a lane"
        await sched.stop()

    asyncio.run(go())


def test_shed_at_vote_buf_max_and_own_vote_sync_path():
    """At vote_buf_max a peer vote is shed (counted on
    consensus.vote_buf) while our own vote takes the sync path; the
    buffered batch then verifies."""
    async def go():
        sched, tally, vals, so = _scheduler(8, vote_buf_max=4)
        shed0 = CONTROLLER.sheds.get("consensus.vote_buf", 0)
        for i in range(4):
            assert sched.enqueue(_prevote(vals, so, i), "pA")
        assert sched.enqueue(_prevote(vals, so, 4), "pA") is True
        assert sched.pending() == 4
        assert CONTROLLER.sheds["consensus.vote_buf"] == shed0 + 1
        assert CONTROLLER.evaluate()["queues"]["consensus.vote_buf"] == {
            "depth": 4, "capacity": 4, "fill": 1.0}
        own = _prevote(vals, so, 5)
        assert sched.enqueue(own, "") is False
        await sched.receive(own, "")
        assert tally.calls == [(5, "", False)] and _tallied(sched, 5)
        sched.start()
        await _settle(sched)
        assert [_tallied(sched, i) for i in range(6)] == [True] * 4 + [
            False, True]
        await sched.stop()
        assert "consensus.vote_buf" not in CONTROLLER.evaluate()["queues"]

    asyncio.run(go())


def test_unaddressable_votes_and_window_zero_take_the_sync_path():
    """A vote of another height or with a wrong address is not batched
    (the sync path rejects it cheaply); with a 0 ms window nothing is."""
    async def go():
        sched, tally, vals, so = _scheduler()
        assert not sched.enqueue(make_vote(P, vals, so, 0, height=H + 1), "p")
        assert not sched.enqueue(make_vote(P, vals, so, 1, height=H,
                                           signer=0), "p")
        late = make_vote(P, vals, so, 2, height=H - 1, type_="PRECOMMIT")
        assert sched.enqueue(late, "p") and sched.pending() == 1
        assert sched.target_vote_set(late) is sched.last_commit
        off, otally, ovals, oso = _scheduler(vote_batch_window_ms=0)
        off.start()
        assert off.task is None
        await off.receive(_prevote(ovals, oso, 0), "p")
        assert otally.calls == [(0, "p", False)] and _tallied(off, 0)
        await off.stop()
        await sched.stop()

    asyncio.run(go())


def test_trust_feedback_counts():
    """Verified lanes credit the sending peer, rejected ones debit it and
    trigger enforcement."""
    async def go():
        sched, tally, vals, so = _scheduler()
        rep = Reporter()
        sched.reporter_fn = lambda: rep
        sched.start()
        bad = _prevote(vals, so, 2)
        bad.signature = b"\x13" * 64
        await sched.receive(_prevote(vals, so, 1), "good")
        await sched.receive(bad, "bad")
        await sched.receive(_prevote(vals, so, 3), "good")
        await sched.receive(_prevote(vals, so, 0, round_=1), "")
        await _settle(sched)
        assert sorted(rep.observed) == [("bad", 0, 1), ("good", 2, 0)]
        assert rep.enforced == [("bad", "invalid vote signature")]
        await sched.stop()

    asyncio.run(go())


def test_breaker_cooldown_and_recovery(monkeypatch):
    """A raising K4 launch opens the ed25519 breaker (host verdicts, the
    same), no launch while it is open, and the device is taken again
    once it closes — through the scheduler's 40-lane batches."""
    calls = []

    def boom(pubs, msgs, sigs, device=None):
        calls.append(len(pubs))
        raise RuntimeError("dead device")

    def oracle(pubs, msgs, sigs, device=None):
        calls.append(len(pubs))
        return np.array([ref.verify(p, m, s)
                         for p, m, s in zip(pubs, msgs, sigs)], bool)

    async def burst(sched, vals, so, round_):
        for i in range(40):
            v = _prevote(vals, so, i, round_=round_)
            if i == 7:
                v.signature = bytes(64)
            await sched.receive(v, "p")
        await _settle(sched)
        return [_tallied(sched, i, round_) for i in range(40)]

    async def go():
        sched, tally, vals, so = _scheduler(40)
        sched.start()
        want = [i != 7 for i in range(40)]
        monkeypatch.setattr(pverify, "verify_batch", boom)
        # the port's clock stands still: the cooldown cannot pass
        clock.install(types.SimpleNamespace(monotonic=lambda: 1000.0))
        fb0 = pbatch.counters()["host_fallbacks"]
        assert await burst(sched, vals, so, 0) == want
        assert calls == [40] and not pbatch.device_available("ed25519")
        assert await burst(sched, vals, so, 1) == want
        assert calls == [40]  # open: the host path, no launch
        assert pbatch.counters()["host_fallbacks"] == fb0 + 2
        pbatch.reset_breakers()  # what a passing probe does
        monkeypatch.setattr(pverify, "verify_batch", oracle)
        sched.votes.set_round(2)
        assert await burst(sched, vals, so, 2) == want
        assert calls == [40, 40]
        await sched.stop()

    try:
        asyncio.run(go())
    finally:
        clock.uninstall()


def test_kernel_error_ends_the_task(monkeypatch):
    """The port's recorded divergence: a KernelError (a fault of the
    port's own kernels, crypto.batch.UNCAUGHT) is not degraded to the
    host path; it ends the scheduler's task, and no vote is tallied."""
    def fault(batch, chain_id):
        raise kernels.KernelError("k_xverify: illegal address (700)")

    async def go():
        sched, tally, vals, so = _scheduler()
        sched.start()
        monkeypatch.setattr(pstate, "batch_verdicts", fault)
        await sched.receive(_prevote(vals, so, 1), "p")
        await sched.receive(_prevote(vals, so, 2), "p")
        for _ in range(500):
            if sched.task.done():
                break
            await asyncio.sleep(0.01)
        with pytest.raises(kernels.KernelError):
            sched.task.result()
        assert tally.calls == []
        sched.task = None
        await sched.stop()

    asyncio.run(go())


# -- the config and the overload controller ------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raise", type(e).__name__, str(e))


def test_consensus_config_equals_reference():
    from tendermint_tpu.config import ConsensusConfig as JConsensusConfig

    for kw in ({}, {"vote_buf_max": 0}, {"vote_buf_max": -3},
               {"vote_batch_window_ms": 0.0, "vote_batch_max": 64}):
        assert _outcome(ConsensusConfig(**kw).validate_basic) == \
            _outcome(JConsensusConfig(**kw).validate_basic), kw
    for f in ("vote_batch_window_ms", "vote_batch_max", "vote_buf_max"):
        assert getattr(ConsensusConfig(), f) == getattr(JConsensusConfig(), f)


def test_overload_controller_equals_reference():
    """Levels, fills and owner-checked unregistration as the reference's
    controller gives them, and the shed counts."""
    from tendermint_tpu.libs.overload import OverloadController as JOC
    from tendermint_tpu_torch.libs.overload import OverloadController

    def run(ctl):
        a, b, depth = object(), object(), {"q": 1}
        ctl.register("consensus.vote_buf", lambda: depth["q"], 4, owner=a)
        ctl.register("light.pending_verify", lambda: 2, lambda: 8)
        out = [ctl.evaluate()]
        depth["q"] = 4
        out.append(ctl.evaluate())
        depth["q"] = 3
        ctl.unregister("consensus.vote_buf", owner=b)  # not its owner
        out.append(ctl.evaluate())
        ctl.shed("light.pending_verify", 2)
        out.append(ctl.evaluate()["level"])
        ctl.unregister("consensus.vote_buf", owner=a)
        ctl.register("x", lambda: 1 // 0, 4)  # a stopped owner reads empty
        out.append(ctl.evaluate()["queues"])
        return out

    ctl = OverloadController()
    assert run(ctl) == run(JOC())
    assert ctl.sheds == {"light.pending_verify": 2}
