"""Port parity for the evidence pool (evidence/__init__.py Pool), the
ABCI form of both evidence kinds (to_abci) and the state store's ABCI
responses (state/store.py save_abci_responses / load_abci_responses),
against the JAX package, in the shapes of tests/test_evidence.py's pool
cases.

Both packages commit the same chain into their own stores (the
committed context of tests/test_torch_light_attack.py: 4 validators,
blocks 1-3) and run the same steps through a Pool over a MemDB of
their own: every outcome (None, or the exception's class and text), the
pending list and its order, the gossip list, the pool's DB bytes and a
second pool's refill from that DB must be equal. No kernel runs (4
validators). Tolerance: exact."""

import types

import numpy as np
import pytest
from test_torch_light_attack import PACKAGES as ATTACK_PACKAGES
from test_torch_light_attack import Ctx, _dup, outcome
from test_torch_state_store import db_bytes

from tendermint_tpu import evidence as jpool
from tendermint_tpu.abci import types as jt
from tendermint_tpu.state import store as jsstore
from tendermint_tpu_torch import evidence as ppool
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.state import store as psstore

PACKAGES = {
    "port": types.SimpleNamespace(pool=ppool, t=pt, ss=psstore),
    "reference": types.SimpleNamespace(pool=jpool, t=jt, ss=jsstore),
}
for _name, _p in PACKAGES.items():
    _p.__dict__.update(vars(ATTACK_PACKAGES[_name]))


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    pbatch.reset_breakers()
    set_default_device(None)


def both(fn):
    got = {name: fn(Ctx(p)) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _lunatic(ctx):
    return ctx.attack(ctx.conflicting_block(app_hash=b"\xee" * 32))


def _snapshot(pool):
    return ([e.hash() for e in pool.pending_evidence(-1)],
            [e.hash() for e in pool.evidence_list], pool.size(),
            pool._pending_bytes, db_bytes(pool.db))


def test_pool_lifecycle_equals_reference():
    """Add a duplicate vote and a light-client attack, re-add, check a
    block's evidence (pending, duplicated, committed), commit one, and
    the pending list under byte caps."""
    def case(ctx):
        p = ctx.p
        pool = p.pool.Pool(p.db.MemDB(), ctx.state_store, ctx.block_store)
        dup, lca = _dup(ctx), _lunatic(ctx)
        out = [outcome(lambda: pool.add_evidence(dup)),
               outcome(lambda: pool.add_evidence(lca)),
               outcome(lambda: pool.add_evidence(dup)),
               (pool.is_pending(dup), pool.is_committed(dup)),
               _snapshot(pool)]
        sizes = [len(e.to_bytes()) for e in pool.pending_evidence(-1)]
        out += [[e.hash() for e in pool.pending_evidence(cap)]
                for cap in (0, sizes[0], sizes[0] + sizes[1] - 1,
                            sum(sizes))]
        out.append(outcome(lambda: pool.check_evidence([dup, lca])))
        out.append(outcome(lambda: pool.check_evidence([dup, dup])))
        pool.update(ctx.committed_state, [dup])
        out += [(pool.is_pending(dup), pool.is_committed(dup)),
                _snapshot(pool),
                outcome(lambda: pool.check_evidence([dup])),
                outcome(lambda: pool.add_evidence(dup)), pool.size()]
        return out

    got = both(case)
    assert got[0] is got[1] is None and got[3] == (True, False)
    assert got[4][2] == 2 and got[9] is None
    assert got[10] == ("EvidenceError", "duplicate evidence in block")
    assert got[13] == ("EvidenceError", "evidence was already committed")
    assert got[15] == 1


def test_pool_rejects_invalid_evidence_as_in_reference():
    """From a peer every piece is verified (a bad signature, a forged
    byzantine set, a malformed one); from consensus none is; a block's
    evidence that is not pending is verified at check_evidence."""
    def case(ctx):
        p = ctx.p
        pool = p.pool.Pool(p.db.MemDB(), ctx.state_store, ctx.block_store)
        bad = _dup(ctx)
        bad.vote_b.signature = b"\x22" * 64
        forged = _lunatic(ctx)
        forged.byzantine_validators = forged.byzantine_validators[:-1]
        same = _dup(ctx)
        same.vote_b = same.vote_a
        out = [outcome(lambda: pool.add_evidence(bad)),
               outcome(lambda: pool.add_evidence(forged)),
               outcome(lambda: pool.add_evidence(same)), pool.size(),
               outcome(lambda: pool.check_evidence([forged])),
               outcome(lambda: pool.check_evidence([_lunatic(ctx)])),
               outcome(lambda: pool.add_evidence_from_consensus(bad)),
               outcome(lambda: pool.add_evidence_from_consensus(bad)),
               _snapshot(pool)]
        return out

    got = both(case)
    assert got[0] == ("EvidenceError", "invalid signature on vote B")
    assert got[1] == ("EvidenceError", "byzantine validator set mismatch")
    assert got[3] == 0 and got[5] is None and got[8][2] == 1


def test_pool_refills_from_its_db():
    def case(ctx):
        p = ctx.p
        db = p.db.MemDB()
        pool = p.pool.Pool(db, ctx.state_store, ctx.block_store)
        pool.add_evidence(_dup(ctx))
        pool.add_evidence(_lunatic(ctx))
        again = p.pool.Pool(db, ctx.state_store, ctx.block_store)
        return _snapshot(pool), _snapshot(again), again.state.last_block_height

    got = both(case)
    assert got[0] == got[1] and got[1][2] == 2 and got[2] == 3
    assert ppool.METRICS["pool_size"] == 2 and ppool.METRICS["pool_bytes"] \
        == got[1][3]


@pytest.mark.parametrize("ages", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["both_equal", "blocks_over", "time_over",
                              "both_over"])
def test_update_prunes_expired_as_in_reference(ages):
    """Pending evidence is pruned only when BOTH its height-age and its
    time-age exceed the consensus params' maxima (reference
    pool.go:576)."""
    def case(ctx):
        p = ctx.p
        pool = p.pool.Pool(p.db.MemDB(), ctx.state_store, ctx.block_store)
        pool.add_evidence(_dup(ctx))
        st = ctx.committed_state.copy()
        ev = st.consensus_params.evidence
        st.last_block_height = 1 + ev.max_age_num_blocks + ages[0]
        st.last_block_time = ctx.block_time + ev.max_age_duration_ns + ages[1]
        pool.update(st, [])
        return _snapshot(pool)

    got = both(case)
    assert got[2] == (0 if ages == (1, 1) else 1)


def test_add_evidence_runs_verify_evidence_once(monkeypatch):
    """The port's Pool verifies through evidence/verify.py's
    verify_evidence, as the reference's does (a light-client attack at
    150 validators launches K4 there: the chip's light_client phase)."""
    calls = []
    real = ppool.verify_evidence

    def counted(*a):
        calls.append(type(a[0]).__name__)
        return real(*a)

    monkeypatch.setattr(ppool, "verify_evidence", counted)
    ctx = Ctx(PACKAGES["port"])
    pool = ppool.Pool(ctx.p.db.MemDB(), ctx.state_store, ctx.block_store)
    lca = _lunatic(ctx)
    pool.add_evidence(lca)
    pool.add_evidence(lca)
    pool.check_evidence([lca])
    pool.add_evidence_from_consensus(_dup(ctx))
    assert calls == ["LightClientAttackEvidence"]


# -- to_abci ---------------------------------------------------------------


def test_to_abci_of_both_kinds_equal():
    def case(ctx):
        p = ctx.p
        out = []
        for ev in (_dup(ctx), _lunatic(ctx),
                   ctx.attack(ctx.conflicting_block(
                       signers={0, 1, 2}, data_hash=b"\xdd" * 32),
                       common_height=2)):
            out.append([p.t.encode_msg(m) for m in ev.to_abci()])
        return out

    got = both(case)
    assert [len(x) for x in got] == [1, 4, 3]
    m = pt.decode_msg(got[1][0])
    assert m.type == "LIGHT_CLIENT_ATTACK" and m.height == 1


# -- ABCI responses in the state store ------------------------------------


def _responses(p, seed):
    rng = np.random.default_rng(seed)
    t = p.t
    txs = [t.ResponseDeliverTx(
        code=int(rng.integers(0, 3)), data=rng.bytes(int(rng.integers(0, 9))),
        log="l%d" % i, gas_wanted=int(rng.integers(9)),
        events=[{"type": "app", "attributes": [
            {"key": "key", "value": "k%d" % i}]}])
        for i in range(int(rng.integers(0, 6)))]
    out = {"deliver_txs": txs}
    if seed % 3:
        out["begin_block"] = t.ResponseBeginBlock(events=[{"type": "b"}])
    if seed % 2:
        out["end_block"] = t.ResponseEndBlock(
            validator_updates=[t.ValidatorUpdate("ed25519", bytes([seed]) * 32,
                                                 seed)],
            consensus_param_updates={"block": {"max_bytes": 100 + seed}})
    return out


def test_abci_responses_bytes_equal_and_cross_read():
    stores = {}
    for name, p in PACKAGES.items():
        db = p.db.MemDB()
        ss = p.ss.Store(db)
        for h in range(1, 7):
            ss.save_abci_responses(h, _responses(p, h))
        stores[name] = (db, ss)
    assert db_bytes(stores["port"][0]) == db_bytes(stores["reference"][0])
    for reader, writer in (("port", "reference"), ("reference", "port")):
        p = PACKAGES[reader]
        ss = p.ss.Store(stores[writer][0])
        for h in range(1, 8):
            got = ss.load_abci_responses(h)
            if h == 7:
                assert got is None
                continue
            want = _responses(p, h)
            assert got["deliver_txs"] == want["deliver_txs"]
            assert got["begin_block"] == want.get("begin_block")
            assert got["end_block"] == want.get("end_block")
    # pruning deletes them in both
    for name, (db, ss) in stores.items():
        ss.prune_states(1, 4)
    assert db_bytes(stores["port"][0]) == db_bytes(stores["reference"][0])
    assert stores["port"][1].load_abci_responses(2) is None
    assert stores["port"][1].load_abci_responses(5) is not None
