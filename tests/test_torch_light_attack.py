"""Port parity for evidence verification (evidence/verify.py:
verify_evidence, verify_light_client_attack) and the light client's
attack detector (light/client.py), against the JAX package, in the
shapes of tests/test_light_attack.py and the verify and expiry cases of
tests/test_evidence.py.

Both packages commit the same chain into their own stores (the
committed context of the reference's _Ctx: 4 validators, blocks 1-3)
and build the same evidence. Every verify_evidence outcome (None, or
the exception's class and text), every evidence byte, byzantine set,
power and timestamp the detector builds, the providers each evidence
was reported to and the store's purge must be equal. The detector's two
evidences are then checked against a node's stores, as a full node
would. No kernel runs (4 validators). Tolerance: exact."""

import asyncio
import dataclasses
import types

import pytest
from test_torch_light_client import PACKAGES as CLIENT_PACKAGES
from test_torch_light_client import client, light_chain, provider
from test_torch_state_store import CHAIN, Node, seed_of, sign_commit
from test_torch_vote_set import sign

from tendermint_tpu.evidence import verify as jev_verify
from tendermint_tpu.types import evidence as jevidence
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import kernels as pkernels
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.evidence import verify as pev_verify
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import vote as pvote

PACKAGES = {
    "port": types.SimpleNamespace(ev_verify=pev_verify, evidence=pevidence,
                                  vote=pvote),
    "reference": types.SimpleNamespace(ev_verify=jev_verify,
                                       evidence=jevidence, vote=jvote),
}
for _name, _p in PACKAGES.items():
    _p.__dict__.update(vars(CLIENT_PACKAGES[_name]))
PORT, REF = PACKAGES["port"], PACKAGES["reference"]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    pbatch.reset_breakers()
    set_default_device(None)


def run(coro):
    return asyncio.run(coro)


def outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


class Ctx:
    """The reference test's committed context in one package: blocks
    1-3 of 4 validators in the stores (the canonical commit of height h
    lands with block h+1), the state after block 3."""

    def __init__(self, p, n_heights=3):
        self.p = p
        self.node = Node(p, n_heights=n_heights)
        self.state = self.node.state
        self.state_store = self.node.state_store
        self.block_store = self.node.block_store
        self.committed_state = self.node.committed_state
        self.block_time = self.block_store.load_block_meta(1).header.time

    def verify(self, ev, state=None):
        return outcome(lambda: self.p.ev_verify.verify_evidence(
            ev, state or self.committed_state, self.state_store,
            self.block_store))

    def conflicting_block(self, height=2, round_=0, signers=None,
                          outsiders=False, **header_changes):
        """A committed block variant re-signed by the real validators
        (or by `signers` of them, or by four outsiders)."""
        p = self.p
        real = self.block_store.load_block_meta(height).header
        forged = dataclasses.replace(real, **header_changes)
        bid = p.block.BlockID(forged.hash(),
                              p.block.PartSetHeader(1, b"\x07" * 32))
        vals = self.state.validators
        if outsiders:
            from test_torch_state_store import valset

            vals = valset(p, range(50, 54))
        commit = sign_commit(p, vals, height, round_, bid, real.time + 1,
                             signers=signers)
        return p.lt.LightBlock(p.lt.SignedHeader(forged, commit),
                               self.state.validators)

    def trusted_sh(self, height):
        meta = self.block_store.load_block_meta(height)
        return self.p.lt.SignedHeader(meta.header,
                                      self.block_store.load_block_commit(height))

    def attack(self, cb, common_height=1):
        common_vals = self.state_store.load_validators(common_height)
        return self.p.lt.LightClientAttackEvidence(
            conflicting_block=cb, common_height=common_height,
            byzantine_validators=self.p.lt.compute_byzantine_validators(
                common_vals, self.trusted_sh(cb.height()), cb),
            total_voting_power=common_vals.total_voting_power(),
            timestamp=self.block_store.load_block_meta(
                common_height).header.time)


def both(fn):
    got = {name: fn(Ctx(p)) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def test_codec_roundtrip_equals_reference():
    def case(ctx):
        ev = ctx.attack(ctx.conflicting_block(app_hash=b"\xee" * 32))
        out = ctx.p.evidence.evidence_from_bytes(ev.to_bytes())
        return (ev.to_bytes(), ev.hash(), out.hash() == ev.hash(),
                out.common_height, [v.address for v in
                                    out.byzantine_validators],
                out.total_voting_power, out.timestamp)

    got = both(case)
    assert got[2:4] == (True, 1) and len(got[4]) == 4
    for p in PACKAGES.values():
        assert p.evidence.evidence_from_bytes(got[0]).to_bytes() == got[0]


def test_valid_attacks_verify_as_in_reference():
    """Lunatic (app hash forged at 2, common height 1), equivocation
    (data hash at 2, common height 2), amnesia (round 1: an empty
    byzantine set) and an equivocation signed by 3 of 4."""
    def case(ctx):
        lunatic = ctx.attack(ctx.conflicting_block(app_hash=b"\xee" * 32))
        equiv = ctx.attack(ctx.conflicting_block(data_hash=b"\xdd" * 32),
                           common_height=2)
        amnesia = ctx.attack(ctx.conflicting_block(
            round_=1, data_hash=b"\xdd" * 32), common_height=2)
        three = ctx.attack(ctx.conflicting_block(
            signers={0, 1, 2}, data_hash=b"\xdd" * 32), common_height=2)
        claimed = dataclasses.replace(
            amnesia,
            byzantine_validators=list(ctx.state.validators.validators))
        return [(len(ev.byzantine_validators), ctx.verify(ev))
                for ev in (lunatic, equiv, amnesia, three)] + [
            ctx.verify(claimed)]

    got = both(case)
    assert got[:4] == [(4, None), (4, None), (0, None), (3, None)]
    assert got[4] == ("EvidenceError", "byzantine validator set mismatch")


def test_attack_rejections_equal_reference():
    def case(ctx):
        p = ctx.p
        cb = ctx.conflicting_block(app_hash=b"\xee" * 32)
        honest = p.lt.LightBlock(ctx.trusted_sh(2), ctx.state.validators)
        out = [ctx.verify(dataclasses.replace(ctx.attack(cb),
                                              conflicting_block=honest)),
               ctx.verify(ctx.attack(cb, common_height=2)),
               ctx.verify(ctx.attack(ctx.conflicting_block(
                   outsiders=True, app_hash=b"\xee" * 32)))]
        ev = ctx.attack(cb)
        ev.byzantine_validators = ev.byzantine_validators[:-1]
        out.append(ctx.verify(ev))
        ev = ctx.attack(cb)
        ev.timestamp += 1
        out.append(ctx.verify(ev))
        ev = ctx.attack(cb)
        ev.total_voting_power = 1
        out.append(ctx.verify(ev))
        bad = ctx.conflicting_block(app_hash=b"\xee" * 32)
        bad.signed_header.commit.signatures[0].signature = b"\x11" * 64
        out.append(ctx.verify(ctx.attack(bad)))
        foreign = ctx.conflicting_block(
            data_hash=b"\xdd" * 32, validators_hash=b"\x99" * 32)
        out.append(ctx.verify(ctx.attack(foreign, common_height=2)))
        tip = ctx.conflicting_block(height=3, app_hash=b"\xee" * 32)
        out.append(outcome(lambda: ctx.p.ev_verify.verify_light_client_attack(
            dataclasses.replace(ctx.attack(cb), conflicting_block=tip),
            CHAIN, ctx.state.validators, ctx.block_time, ctx.state_store,
            ctx.block_store)))
        out.append(ctx.verify(dataclasses.replace(ctx.attack(cb),
                                                  common_height=7)))
        out.append(ctx.verify(types.SimpleNamespace(height=lambda: 1)))
        return out

    got = both(case)
    assert got[0] == ("EvidenceError",
                      "conflicting block matches the committed chain")
    assert "correctly derived" in got[1][1]
    assert got[2][0] == "EvidenceError" and got[3][1].startswith("byzantine")
    assert "time" in got[4][1] and "power" in got[5][1]
    assert got[6][1].startswith("conflicting commit failed verification")
    assert got[8] == ("EvidenceError", "no committed header+commit at "
                      "conflicting height 3 (commit lands with block 4)")
    assert got[9] == ("EvidenceError",
                      "no committed block at evidence height 7")
    assert got[10] == ("EvidenceError", "unknown evidence type "
                       "SimpleNamespace")


# -- duplicate votes through verify_evidence (tests/test_evidence.py) ----


def _bid(p, s):
    return p.block.BlockID(bytes([s]) * 32, p.block.PartSetHeader(
        1, bytes([s]) * 32))


def _vote(ctx, i, bid, height=1, round_=0, outsider=None):
    p, vals = ctx.p, ctx.state.validators
    if outsider is None:
        val = vals.validators[i]
        addr, idx, pub = val.address, i, val.pub_key.bytes()
    else:
        addr, idx, pub = outsider.address, 0, outsider.pub_key.bytes()
    v = p.vote.Vote(type=p.vote.VoteType.PRECOMMIT, height=height,
                    round=round_, block_id=bid, timestamp=5,
                    validator_address=addr, validator_index=idx)
    v.signature = sign(seed_of(pub), v.sign_bytes(CHAIN))
    return v


def _dup(ctx, ts=None):
    return ctx.p.evidence.DuplicateVoteEvidence.from_votes(
        _vote(ctx, 0, _bid(ctx.p, 1)), _vote(ctx, 0, _bid(ctx.p, 2)),
        ctx.block_time if ts is None else ts, ctx.state.validators)


def test_duplicate_vote_verify_equals_reference():
    def case(ctx):
        out = [ctx.verify(_dup(ctx))]
        ev = _dup(ctx)
        ev.vote_a.signature = b"\x11" * 64
        out.append(ctx.verify(ev))
        out.append(ctx.verify(_dup(ctx, ts=ctx.block_time + 1)))
        ev = _dup(ctx)
        ev.total_voting_power = 999
        out.append(ctx.verify(ev))
        ev = _dup(ctx)
        ev.vote_b = ev.vote_a
        out.append(ctx.verify(ev))
        from test_torch_state_store import valset

        outsider = valset(ctx.p, [99]).validators[0]
        va = _vote(ctx, 0, _bid(ctx.p, 1), outsider=outsider)
        vb = _vote(ctx, 0, _bid(ctx.p, 2), outsider=outsider)
        out.append(ctx.verify(ctx.p.evidence.DuplicateVoteEvidence(
            vote_a=va, vote_b=vb, total_voting_power=40, validator_power=10,
            timestamp=ctx.block_time)))
        return out

    got = both(case)
    assert got[0] is None
    assert got[1] == ("EvidenceError", "invalid signature on vote A")
    assert got[5][1].endswith("not in set at height 1")


@pytest.mark.parametrize("ages", [(0, 0), (1, 0), (0, 1), (1, 1)],
                         ids=["both_equal", "blocks_over", "time_over",
                              "both_over"])
def test_evidence_expiry_equals_reference(ages):
    """Expired only when BOTH the height-age and the time-age exceed
    their maxima (reference verify.py:28)."""
    def case(ctx):
        st = ctx.committed_state
        p = st.consensus_params.evidence
        st.last_block_height = 1 + p.max_age_num_blocks + ages[0]
        st.last_block_time = ctx.block_time + p.max_age_duration_ns + ages[1]
        return ctx.verify(_dup(ctx), st)

    got = both(case)
    if ages == (1, 1):
        assert got[0] == "EvidenceError" and "too old" in got[1]
    else:
        assert got is None


# -- the detector --------------------------------------------------------


class Recorder:
    """Wraps a provider; records evidence reported through it."""

    def __init__(self, inner, fail=None):
        self.inner, self.fail, self.reported = inner, fail, []

    def provider_id(self):
        return "recorder"

    async def light_block(self, height):
        return await self.inner.light_block(height)

    async def report_evidence(self, ev):
        if self.fail is not None:
            raise self.fail
        self.reported.append(ev)


def _detector_case(p, fail=None):
    chain = light_chain(p, 8)
    fork = light_chain(p, 8, fork=6)
    primary = Recorder(provider(p, chain), fail=fail)
    witness = Recorder(provider(p, fork))
    cl = client(p, chain, witnesses=[witness], primary=primary)
    try:
        run(cl.verify_light_block_at_height(8))
        return "no divergence"
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        evs = getattr(e, "evidence", [])
        return ((type(e).__name__, str(e)),
                [(ev.to_bytes(), ev.common_height,
                  [(v.address, v.voting_power)
                   for v in ev.byzantine_validators],
                  ev.total_voting_power, ev.timestamp,
                  ev.conflicting_block.signed_header.header.app_hash)
                 for ev in evs],
                [ev.hash() for ev in primary.reported],
                [ev.hash() for ev in witness.reported],
                cl.store.heights(), cl.store.get(8))


def test_detector_builds_and_reports_evidence_as_in_reference():
    got = {name: _detector_case(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    err, evs, to_primary, to_witness, heights, at8 = got["port"]
    assert err == ("DivergenceError",
                   "witness 0 header conflicts with primary at height 8")
    assert len(evs) == 2 and evs[0][1] == evs[1][1] < 6
    assert len(evs[0][2]) == 4 and evs[0][5] == b"\xbb" * 32
    hashes = [PORT.evidence.evidence_from_bytes(e[0]).hash() for e in evs]
    assert to_primary == hashes[:1] and to_witness == hashes[1:]
    assert max(heights) <= evs[0][1] and at8 is None


def test_report_evidence_kernel_error_ends_the_call():
    """The recorded divergence at the evidence report: a KernelError
    re-raises in the port (the store is left unpurged); the reference
    logs it and raises DivergenceError."""
    port = _detector_case(PORT, fail=pkernels.KernelError("fault"))
    assert port[0] == ("KernelError", "fault") and 8 in port[4]
    ref = _detector_case(REF, fail=pkernels.KernelError("fault"))
    assert ref[0][0] == "DivergenceError" and len(ref[1]) == 2
    same = {name: _detector_case(p, fail=RuntimeError("down"))
            for name, p in PACKAGES.items()}
    assert same["port"] == same["reference"]
    assert same["port"][0][0] == "DivergenceError"


def _node_fork_case(p):
    """A fork proven against a node's stores, then both evidences checked
    by verify_evidence on those stores, as a full node would: the one
    against the witness verifies, the one against the primary matches
    the committed chain. A tip-height evidence fails for want of the
    canonical commit."""
    sets = lambda h: range(4) if h <= 4 else range(1, 5)  # noqa: E731
    node = Node(p, n_heights=9, sets=sets)

    class Sink:
        def __init__(self):
            self.added = []

        def add_evidence(self, ev):
            self.added.append(ev)

    sink = Sink()
    primary = p.provider.BlockStoreProvider(node.block_store, node.state_store,
                                            evidence_pool=sink)
    real = {h: run(primary.light_block(h)) for h in range(1, 10)}
    forged = {}
    for h, lb in real.items():
        if h < 6:
            forged[h] = lb
            continue
        hdr = dataclasses.replace(lb.signed_header.header,
                                  app_hash=b"\xbb" * 32)
        bid = p.block.BlockID(hdr.hash(), p.block.PartSetHeader(1, b"\x07" * 32))
        forged[h] = p.lt.LightBlock(p.lt.SignedHeader(hdr, sign_commit(
            p, lb.validator_set, h, 0, bid, hdr.time + 1)), lb.validator_set)
    witness = Recorder(provider(p, forged))
    now = node.committed_state.last_block_time + 1
    cl = p.client.Client(CHAIN, p.client.TrustOptions(3600 * 10**9, 1,
                                                      real[1].hash()),
                         primary, [witness], p.lstore.LightStore(p.db.MemDB()),
                         now_fn=lambda: now)
    try:
        run(cl.verify_light_block_at_height(8))
        return "no divergence"
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        div = e
    out = [(type(div).__name__, [ev.common_height for ev in div.evidence],
            [ev.hash() for ev in sink.added], cl.store.heights())]
    st, ss, bs = node.committed_state, node.state_store, node.block_store
    for ev in div.evidence:
        out.append(outcome(lambda: p.ev_verify.verify_evidence(ev, st, ss,
                                                               bs)))
    tip = dataclasses.replace(div.evidence[0], conflicting_block=forged[9])
    out.append(outcome(lambda: p.ev_verify.verify_evidence(tip, st, ss, bs)))
    return out


def test_proven_fork_checked_on_node_stores_as_in_reference():
    got = {name: _node_fork_case(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    head, vs_witness, vs_primary, tip = got["port"]
    assert head[0] == "DivergenceError" and len(head[2]) == 1
    assert vs_witness is None
    assert vs_primary == ("EvidenceError",
                          "conflicting block matches the committed chain")
    assert tip == ("EvidenceError", "no committed header+commit at "
                   "conflicting height 9 (commit lands with block 10)")
