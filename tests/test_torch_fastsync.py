"""Port parity for fast sync's verify-ahead plane: MergedSignBatch,
_batch_verify_window, window_items, WindowPipeline and BlockPool,
against the JAX package on chains both packages build from the same
seeds (test_torch_block.make_chain: blocks cross between nothing here,
each package builds its own, and the tests first hold their bytes
equal).

The port's window runs its expanded structured route (one MergedSignBatch,
one plain K1 for the set, one plain K3 a window with K2's assembly
inside, on the CPU), with _EXPAND_MIN lowered on the port's module only;
the reference runs its host route, which compiles no JAX kernel: its
windows stay under _DEVICE_THRESHOLD = 40 lanes (4 validators, 3 lanes a
commit). Per-block results must match: None, or the same exception
type and text. Tolerance: exact everywhere."""

import asyncio
import concurrent.futures
import logging
import sys

import numpy as np
import pytest
from test_torch_block import PACKAGES, START, make_chain

from tendermint_tpu.blockchain import pool as jpool
from tendermint_tpu.blockchain import verify_ahead as jva
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.types import sign_batch as jsign_batch
from tendermint_tpu_torch.blockchain import pool as ppool
from tendermint_tpu_torch.blockchain import verify_ahead as pva
from tendermint_tpu_torch.crypto.cuda import expanded
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import sign_batch as psign_batch
from tendermint_tpu_torch.types import validator_set as pvalidator_set

CHAIN = "torch-block-chain"
N_VALS = 4
VA = {"port": pva, "reference": jva}
SB = {"port": psign_batch, "reference": jsign_batch}
POOL = {"port": ppool, "reference": jpool}


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture
def structured(monkeypatch):
    """The port's windows take the expanded structured route at 4
    validators; every batch the port verifies is recorded as
    (message type, lanes)."""
    monkeypatch.setattr(pvalidator_set, "_EXPAND_MIN", 4)
    seen = []
    real = pvalidator_set.ValidatorSet._batch_verify_lanes

    def spy(self, lanes, msgs, sigs):
        seen.append((type(msgs).__name__, len(lanes)))
        return real(self, lanes, msgs, sigs)

    monkeypatch.setattr(pvalidator_set.ValidatorSet, "_batch_verify_lanes",
                        spy)
    return seen


def _chains(n_blocks=9, rounds=None, n_vals=N_VALS, start=START):
    return {name: make_chain(p, n_vals, start, n_blocks, seed=3,
                             rounds=rounds)
            for name, p in PACKAGES.items()}


def _outcome(results):
    return [None if r is None else (type(r).__name__, str(r))
            for r in results]


def _merged(name, items, full=False):
    """The window's MergedSignBatch: every for-block slot of each
    commit (full) or its first three (the quorum at 4 validators)."""
    sb = SB[name]
    return sb.MergedSignBatch([
        sb.CommitSignBatch(CHAIN, c, [i for i, s in enumerate(c.signatures)
                                      if s.for_block()][:None if full else 3])
        for _, _, c in items])


FIELDS = ("pre", "pre_len", "suf", "suf_len", "group", "patch", "split",
          "patch_len")


@pytest.mark.parametrize("rounds", [{}, {125: 1, 127: 2}],
                         ids=["round0", "rounds_1_2"])
def test_merged_sign_batch_matches_reference(rounds):
    chains = _chains(n_blocks=13, rounds=rounds, n_vals=6)
    batches = {}
    for name, (_, blocks, _) in chains.items():
        items, _ = VA[name].window_items(blocks)
        assert [h for _, h, _ in items] == list(range(START, START + 12))
        batches[name] = _merged(name, items, full=True)
    p, j = batches["port"], batches["reference"]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), f)
    assert p.materialize() == j.materialize()
    assert [p.host_assemble(i) for i in range(len(p))] == p.materialize()
    assert p.anchor_bytes() == j.anchor_bytes() and len(p) == 12 * 6
    assert list(p.group) == [g for g in range(12) for _ in range(6)]
    # the canonical vote's height is sfixed64: crossing 128 leaves the
    # templates' width alone; a round past 0 adds its 9-byte field
    widths = sorted(set(p.pre_len.tolist()))
    assert len(widths) == (2 if rounds else 1)
    if rounds:
        assert widths[1] - widths[0] == 9
        assert p.pre.shape[1] == widths[1]


def test_merged_sign_batch_refuses_more_than_max_groups():
    chains = _chains(n_blocks=2)
    errors = []
    for name, (_, blocks, _) in chains.items():
        sb = SB[name]
        commit = blocks[1].last_commit
        one = sb.CommitSignBatch(CHAIN, commit, [0, 1, 2])
        assert len(sb.MergedSignBatch([one] * sb.MAX_GROUPS)) == 3 * 32
        with pytest.raises(ValueError) as e:
            sb.MergedSignBatch([one] * (sb.MAX_GROUPS + 1))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert psign_batch.MAX_GROUPS == expanded.ExpandedKeys._S_GROUPS == 32


def _fault(case, name, items):
    """Apply `case` to one package's window items (block i is verified
    with block i + 1's commit)."""
    p = PACKAGES[name]
    if case in ("bad_signature", "all"):
        cs = items[2][2].signatures[0]
        cs.signature = cs.signature[:7] + bytes([cs.signature[7] ^ 1]) + \
            cs.signature[8:]
    if case in ("timestamp", "all"):
        items[5][2].signatures[1].timestamp += 1  # after signing
    if case in ("insufficient", "all"):
        sigs = items[1][2].signatures
        for i in (1, 2):
            sigs[i] = p.block.CommitSig.absent()
    if case in ("wrong_block_id", "all"):
        bid, h, commit = items[4]
        items[4] = (p.block.BlockID(b"\x5a" * 32, bid.part_set_header), h,
                    commit)
    return items


CASES = ["valid", "bad_signature", "timestamp", "insufficient",
         "wrong_block_id", "all"]


@pytest.mark.parametrize("case", CASES)
def test_batch_verify_window_matches_reference(case, structured):
    chains = _chains()
    out = {}
    for name, (vals, blocks, _) in chains.items():
        items, _ = VA[name].window_items(blocks)
        items = _fault(case, name, items)
        out[name] = _outcome(VA[name]._batch_verify_window(vals, CHAIN,
                                                           items))
    assert out["port"] == out["reference"]
    bad = {"valid": [], "bad_signature": [2], "timestamp": [5],
           "insufficient": [1], "wrong_block_id": [4],
           "all": [1, 2, 4, 5]}[case]
    assert [i for i, r in enumerate(out["port"]) if r is not None] == bad
    # one structured batch (K3's structured form) for the window's
    # verifiable blocks, 3 lanes each
    assert structured == [("MergedSignBatch", 3 * (8 - len(
        [i for i in bad if i in (1, 4)])))]


def test_window_items_and_part_sets_match():
    chains = _chains(n_blocks=5)
    got = {}
    for name, (_, blocks, _) in chains.items():
        items, parts = VA[name].window_items(blocks)
        got[name] = ([(bid.hash, bid.part_set_header.total,
                       bid.part_set_header.hash, h, c.to_bytes())
                      for bid, h, c in items],
                     [[x.to_bytes() for x in ps.parts] for ps in parts])
    assert got["port"] == got["reference"] and len(got["port"][0]) == 4


def test_concurrent_window_jobs_keep_their_own_verdicts(structured):
    """Two window jobs (one window with a bad signature) at once in two
    threads on the structured route, as a discarded prefetch and a fresh
    job may run: each job's results equal its window's results when run
    alone."""
    vals, blocks, _ = _chains(n_blocks=9)["port"]
    good = blocks[:5]
    bad_blocks = [type(b).from_bytes(b.to_bytes()) for b in blocks[4:9]]
    cs = bad_blocks[2].last_commit.signatures[0]
    cs.signature = bytes([cs.signature[0] ^ 1]) + cs.signature[1:]
    alone = [_outcome(pva.WindowPipeline._verify_window_job(
        vals, CHAIN, w)[2]) for w in (good, bad_blocks)]
    assert alone[0] == [None] * 4 and alone[1][1] is not None
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(pva.WindowPipeline._verify_window_job, vals,
                              CHAIN, w)
                    for w in (bad_blocks, good)]
            got = [_outcome(f.result(timeout=120)[2]) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    assert got == alone[::-1]


class _Failing:
    """A block whose part set cannot be built: its job raises."""

    def __init__(self, block):
        self.header, self.last_commit = block.header, block.last_commit

    def make_part_set(self):
        raise RuntimeError("boom")


async def _pipeline_scenario(name, scenario, vals, vals2, blocks, pool_of):
    """One WindowPipeline scenario; returns what it observed."""
    va = VA[name]
    pipe = va.WindowPipeline(enabled=scenario != "disabled")
    pool = pool_of(blocks)
    first = pool.peek_blocks(5)
    _, _, res = await pipe.verdicts(vals, CHAIN, first)
    seen = [_outcome(res)]
    if scenario == "stale_failing":
        ahead = list(pool.peek_blocks(9)[4:])
        ahead[1] = _Failing(ahead[1])
        pipe._prefetch = (pipe.window_key(vals, ahead),
                          asyncio.get_running_loop().run_in_executor(
                              None, pipe._verify_window_job, vals, CHAIN,
                              ahead), ahead)
    else:
        pipe.start_ahead(vals, CHAIN, pool.peek_blocks, len(first))
    prefetched = pipe._prefetch is not None
    stale = pipe._prefetch[1] if prefetched else None
    if scenario == "reset":
        pipe.reset()
    for _ in range(len(first) - 1):
        pool.pop_request()
    nxt = pool.peek_blocks(5)
    if scenario == "changed_window":
        nxt = [type(b).from_bytes(b.to_bytes()) for b in nxt]
    use = vals2 if scenario == "changed_valset" else vals
    _, _, res = await pipe.verdicts(use, CHAIN, nxt)
    seen.append(_outcome(res))
    if stale is not None:
        await asyncio.wait([stale], timeout=60)
        await asyncio.sleep(0)  # the discarded job's done-callback
    return dict(seen=seen, hits=pipe.prefetch_hits, prefetched=prefetched,
                left=pipe._prefetch is not None)


def _pool_of(name):
    def make(blocks):
        pool = POOL[name].BlockPool(START)
        pool.set_peer_range("p", START, START + len(blocks) - 1)
        pool.make_next_requests(now=0.0)
        for b in blocks:
            assert pool.add_block("p", b, 100)
        return pool
    return make


@pytest.mark.parametrize("scenario", ["hit", "changed_window",
                                      "changed_valset", "stale_failing",
                                      "reset", "disabled"])
def test_window_pipeline_matches_reference(scenario, caplog):
    chains = _chains()
    got = {}
    for name, (vals, blocks, _) in chains.items():
        # the last validator gains power: it sorts first, so every
        # slot's key moves
        vals2 = type(vals)([v.copy() for v in vals.validators])
        vals2.validators[-1].voting_power += 1
        vals2 = type(vals)(vals2.validators)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="blockchain"):
            got[name] = asyncio.run(_pipeline_scenario(
                name, scenario, vals, vals2, blocks, _pool_of(name)))
        got[name]["warned"] = [r.getMessage() for r in caplog.records
                               if r.name == "blockchain"]
    assert got["port"] == got["reference"]
    out = got["port"]
    assert out["hits"] == (1 if scenario == "hit" else 0)
    assert out["prefetched"] == (scenario != "disabled")
    assert not out["left"]
    assert out["seen"][0] == [None] * 4
    if scenario == "changed_valset":
        assert all(r is not None for r in out["seen"][1])
    else:
        assert out["seen"][1] == [None] * 4
    assert out["warned"] == (
        ["discarded verify-ahead window failed: RuntimeError('boom')"]
        if scenario == "stale_failing" else [])


class _FakeBlock:
    def __init__(self, height):
        self.header = type("H", (), {"height": height})()


def _pool_assigns(mod):
    pool = mod.BlockPool(1)
    pool.set_peer_range("p1", 1, 50)
    pool.set_peer_range("p2", 1, 50)
    reqs = pool.make_next_requests(now=0.0)
    by_height = dict((h, p) for p, h in reqs)
    wrong = "p1" if by_height[1] == "p2" else "p2"
    out = [sorted(reqs), pool.add_block(wrong, _FakeBlock(1), 100),
           pool.add_block(by_height[1], _FakeBlock(1), 100),
           pool.add_block(by_height[2], _FakeBlock(2), 100),
           [b.header.height for b in pool.peek_blocks(5)]]
    pool.pop_request()
    return out + [pool.height, [b.header.height for b in pool.peek_blocks(5)],
                  len(reqs) == 2 * mod.MAX_PENDING_PER_PEER]


def _pool_timeout(mod):
    pool = mod.BlockPool(1)
    pool.set_peer_range("p1", 1, 10)
    pool.make_next_requests(now=0.0)
    out = [pool.tick(now=1.0), pool.tick(now=mod.REQUEST_TIMEOUT + 1),
           pool.remove_peer("p1")]
    pool.set_peer_range("p2", 1, 10)
    return out + [("p2", 1) in pool.make_next_requests(now=20.0)]


def _pool_no_block(mod):
    pool = mod.BlockPool(5)
    pool.set_peer_range("p1", 1, 10)
    pool.make_next_requests(now=0.0)
    pool.no_block("p1", 7)
    return [pool.peers["p1"].height, 7 in pool.requests]


def _pool_redo(mod):
    pool = mod.BlockPool(1)
    pool.set_peer_range("p1", 1, 10)
    for _, h in pool.make_next_requests(now=0.0):
        pool.add_block("p1", _FakeBlock(h), 10)
    out = [pool.redo_request(1), "p1" in pool.peers, bool(pool.requests)]
    pool.set_peer_range("p1", 1, 10)
    return out + ["p1" in pool.peers]


def _pool_caught_up(mod):
    pool = mod.BlockPool(10)
    out = [pool.is_caught_up()]
    pool.set_peer_range("p1", 1, 9)
    out.append(pool.is_caught_up())
    pool.set_peer_range("p2", 1, 30)
    return out + [pool.is_caught_up()]


POOL_CASES = {
    "assigns_and_orders": (_pool_assigns, lambda o: o[1:] == [
        False, True, True, [1, 2], 2, [2], True]),
    "timeout_drops_peer": (_pool_timeout, lambda o: o[0] == [] and
                           o[1] == ["p1"] and 1 in o[2] and o[3]),
    "no_block_shrinks_peer": (_pool_no_block, lambda o: o == [6, False]),
    "redo_bans_lying_peer": (_pool_redo, lambda o: o == [
        "p1", False, False, False]),
    "caught_up": (_pool_caught_up, lambda o: o == [False, True, False]),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_block_pool_matches_reference(case):
    run, check = POOL_CASES[case]
    port, jref = run(ppool), run(jpool)
    assert port == jref
    assert check(port)


def test_reference_host_route_stays_under_its_device_threshold():
    # 8 verifiable blocks x 3 lanes: the reference's windows here never
    # reach its device path (no JAX kernel compiles)
    assert 8 * 3 < jbatch._DEVICE_THRESHOLD
