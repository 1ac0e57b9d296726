"""Port parity for the node's host layers under the light client:
libs/db.py (MemDB), types/params.py, types/block_meta.py,
types/genesis.py, the ValidatorSet methods state needs (copy,
has_address, increment_proposer_priority, get_proposer), state/
(State, make_genesis_state, median_time, abci_results_hash),
state/store.py (Store) and store/ (BlockStore), against the JAX
package on chains both packages build from the same seeds.

Every stored byte must equal the reference's: the two packages' MemDB
contents are compared key for key after the same writes, and each
package's stores read the other's bytes back field for field and hash
for hash. ConsensusParams.hash and GenesisDoc.hash must be equal. No
kernel runs (4-7 validators stay under the device threshold).
Tolerance: exact."""

import base64
import functools
import hashlib
import json
import types

import pytest
from test_torch_vote_set import sign

from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.libs import db as jdb
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu import state as jstate
from tendermint_tpu.state import store as jsstore
from tendermint_tpu import store as jbstore
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import block_meta as jblock_meta
from tendermint_tpu.types import genesis as jgenesis
from tendermint_tpu.types import params as jparams
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.libs import db as pdb
from tendermint_tpu_torch.libs import failpoints as pfailpoints
from tendermint_tpu_torch import state as pstate
from tendermint_tpu_torch.state import store as psstore
from tendermint_tpu_torch import store as pbstore
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import block_meta as pblock_meta
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import params as pparams
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set

CHAIN = "torch-node-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000
PACKAGES = {
    "port": types.SimpleNamespace(
        ed=ped25519, db=pdb, state=pstate, sstore=psstore, bstore=pbstore,
        block=pblock, block_meta=pblock_meta, genesis=pgenesis,
        params=pparams, validator=pvalidator, vset=pvalidator_set,
        failpoints=pfailpoints),
    "reference": types.SimpleNamespace(
        ed=jed25519, db=jdb, state=jstate, sstore=jsstore, bstore=jbstore,
        block=jblock, block_meta=jblock_meta, genesis=jgenesis,
        params=jparams, validator=jvalidator, vset=jvalidator_set,
        failpoints=jfailpoints),
}
PORT, REF = PACKAGES["port"], PACKAGES["reference"]


def outcome(fn):
    """fn()'s value, or its exception's class and text."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def seed(i: int) -> bytes:
    return hashlib.sha256(b"node-val-%d" % i).digest()


@functools.cache
def pub(i: int) -> bytes:
    return ref.public_key_from_seed(seed(i))


@functools.cache
def seed_of(pub_bytes: bytes) -> bytes:
    for i in range(256):
        if pub(i) == pub_bytes:
            return seed(i)
    raise KeyError(pub_bytes.hex())


def valset(p, indices, power=10):
    return p.vset.ValidatorSet([p.validator.Validator.new(
        p.ed.Ed25519PubKey(pub(i)), power) for i in indices])


def genesis_doc(p, indices=range(4), power=10, **kw):
    gdoc = p.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=GENESIS_TIME,
        validators=[p.genesis.GenesisValidator(p.ed.Ed25519PubKey(pub(i)),
                                               power) for i in indices],
        **kw)
    gdoc.validate_and_complete()
    return gdoc


def sign_commit(p, vals, height, round_, bid, ts, signers=None,
                chain_id=CHAIN):
    """A commit with a precommit from every validator of `vals` (or from
    the indices in `signers` only; the others absent), timestamps ts."""
    sigs = []
    for idx, v in enumerate(vals.validators):
        if signers is not None and idx not in signers:
            sigs.append(p.block.CommitSig.absent())
        else:
            sigs.append(p.block.CommitSig(p.block.BlockIDFlag.COMMIT,
                                          v.address, ts, b""))
    commit = p.block.Commit(height, round_, bid, sigs)
    for idx, cs in enumerate(sigs):
        if not cs.is_absent():
            cs.signature = sign(seed_of(vals.validators[idx].pub_key.bytes()),
                                commit.vote_sign_bytes(chain_id, idx))
    return commit


class Node:
    """A committed chain in one package's stores: blocks 1..n through
    State.make_block, BlockStore.save_block and Store.save_validator_set
    over MemDB, each commit signed by the height's set; the state after
    the last block saved. `sets(h)` gives the indices of height h's set
    (default: genesis' 4 validators throughout); `txs(h)` the block's
    txs."""

    def __init__(self, p, n_heights=3, sets=None, txs=None, n_vals=4,
                 dt=10):
        self.p = p
        self.gdoc = genesis_doc(p, range(n_vals))
        self.state = p.state.make_genesis_state(self.gdoc)
        self.state_db, self.block_db = p.db.MemDB(), p.db.MemDB()
        self.state_store = p.sstore.Store(self.state_db)
        self.block_store = p.bstore.BlockStore(self.block_db)
        cache = {}

        def vals_at(h):
            if sets is None:
                return self.state.validators
            key = tuple(sets(h))
            if key not in cache:
                cache[key] = valset(p, key)
            return cache[key]

        self.vals_at = vals_at
        st = self.state.copy()
        prev_commit = None
        self.block_ids = {}
        for h in range(1, n_heights + 1):
            vals = vals_at(h)
            if sets is not None:
                st.validators, st.next_validators = vals, vals_at(h + 1)
            block = st.make_block(h, txs(h) if txs else [], prev_commit, [],
                                  vals.get_proposer().address,
                                  GENESIS_TIME + dt * h)
            parts = block.make_part_set()
            bid = p.block.BlockID(block.hash(), parts.header())
            prev_commit = sign_commit(p, vals, h, 0, bid,
                                      GENESIS_TIME + dt * h + 1)
            self.block_store.save_block(block, parts, prev_commit)
            self.state_store.save_validator_set(h, vals)
            st = st.copy()
            st.last_block_height = h
            st.last_block_id = bid
            st.last_block_time = block.header.time
            self.block_ids[h] = bid
        self.committed_state = st
        self.state_store.save(st)


def db_bytes(db) -> dict:
    return dict(db.iterate())


def copy_db(p, src):
    out = p.db.MemDB()
    out.write_batch(list(src.iterate()))
    return out


# -- libs/db.py ------------------------------------------------------------


def _db_script(p):
    db = p.db.MemDB()
    log = []
    db.set(b"b", b"2")
    db.set(b"a", b"1")
    db.set(b"\xff\xff", b"ff")
    db.set(b"ab\xff", b"x")
    db.write_batch([(b"c", b"3"), (b"a", None), (b"ac", b"y")])
    log.append(list(db.iterate()))
    log.append(list(db.iterate(b"ab", b"c")))
    log.append(list(db.iterate_prefix(b"a")))
    log.append(list(db.iterate_prefix(b"\xff")))
    db.delete(b"b")
    db.delete(b"missing")
    log.append([db.get(b"b"), db.has(b"c"), db.has(b"b")])
    log.append(list(db.iterate(b"b")))
    log.append([p.db._prefix_end(x) for x in
                (b"a", b"a\xff", b"\xff\xff", b"", b"\x00\xfe")])
    db.close()
    return log


def test_memdb_equals_reference():
    assert _db_script(PORT) == _db_script(REF)


# -- types/params.py -------------------------------------------------------


def _params_cases(p):
    cp = p.params.ConsensusParams
    variants = [
        cp(),
        cp(block=p.params.BlockParams(max_bytes=1024, max_gas=10 ** 6)),
        cp(evidence=p.params.EvidenceParams(max_age_num_blocks=7,
                                            max_age_duration_ns=99,
                                            max_bytes=512)),
        cp(validator=p.params.ValidatorParams(["ed25519", "sr25519"]),
           version=p.params.VersionParams(app_version=3)),
    ]
    bad = [
        cp(block=p.params.BlockParams(max_bytes=0)),
        cp(block=p.params.BlockParams(max_gas=-2)),
        cp(evidence=p.params.EvidenceParams(max_age_num_blocks=0)),
        cp(evidence=p.params.EvidenceParams(max_bytes=10 ** 8)),
        cp(validator=p.params.ValidatorParams([])),
    ]
    tm = {"block": {"max_bytes": "4096", "max_gas": "-1",
                    "time_iota_ms": "1000"},
          "evidence": {"max_age_num_blocks": "100",
                       "max_age_duration": "172800000000000",
                       "max_bytes": "1024"},
          "validator": {"pub_key_types": ["ed25519"]},
          "version": None}
    out = [(v.hash(), v.to_json(), outcome(v.validate_basic))
           for v in variants]
    out += [outcome(v.validate_basic) for v in bad]
    parsed = cp.from_json(tm)
    out.append((parsed.to_json(), parsed.hash()))
    out.append(outcome(lambda: cp.from_json({"block": {"max_byts": 1}})))
    out.append(cp.from_json(None).hash())
    out.append(cp.from_json(variants[3].to_json()).hash())
    upd = variants[0].update({"block": {"max_bytes": 2 << 20, "nope": 1},
                              "nosuch": {"x": 1}})
    out.append((upd.to_json(), variants[0].block.max_bytes))
    out.append(outcome(lambda: variants[0].update(
        {"evidence": {"max_age_num_blocks": 0}})))
    out.append(variants[0].update(None).hash())
    return out


def test_consensus_params_equal_reference():
    got = {name: _params_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    # the reference's default hash feeds every header's consensus_hash
    assert got["port"][0][0] == jparams.ConsensusParams().hash()


# -- types/genesis.py ------------------------------------------------------


def _genesis_cases(p):
    gdoc = genesis_doc(p, range(5), app_hash=b"\x0a" * 32,
                       app_state={"k": [1, 2]})
    out = [gdoc.to_json(), gdoc.hash(), gdoc.validator_set().hash(),
           [v.address for v in gdoc.validators]]
    back = p.genesis.GenesisDoc.from_json(gdoc.to_json())
    out.append((back.to_json() == gdoc.to_json(), back.hash()))
    tm = json.dumps({
        "chain_id": CHAIN, "genesis_time": "2023-11-14T22:13:20.5Z",
        "initial_height": "3",
        "consensus_params": {"block": {"max_bytes": "4194304"},
                             "evidence": {"max_age_duration": "10"}},
        "validators": [{"pub_key": {"type": "tendermint/PubKeyEd25519",
                                    "value": base64.b64encode(pub(i))
                                    .decode()},
                        "power": "7", "name": f"v{i}"} for i in range(3)],
        "app_hash": ""})
    parsed = p.genesis.GenesisDoc.from_json(tm)
    out.append((parsed.to_json(), parsed.hash(), parsed.genesis_time,
                parsed.initial_height))

    def bad(**kw):
        doc = p.genesis.GenesisDoc(**{"chain_id": CHAIN,
                                      "genesis_time": 5, **kw})
        return outcome(doc.validate_and_complete)

    out += [bad(chain_id=""), bad(chain_id="x" * 51),
            bad(initial_height=-1),
            bad(validators=[p.genesis.GenesisValidator(
                p.ed.Ed25519PubKey(pub(0)), -1)]),
            bad(consensus_params=p.params.ConsensusParams(
                block=p.params.BlockParams(max_bytes=0)))]
    doc = p.genesis.GenesisDoc(chain_id=CHAIN, genesis_time=5,
                               initial_height=0)
    doc.validate_and_complete()
    out.append(doc.initial_height)
    return out


def test_genesis_doc_equal_reference(tmp_path):
    got = {name: _genesis_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    path = tmp_path / "genesis.json"
    genesis_doc(PORT, range(3)).save(str(path))
    assert jgenesis.GenesisDoc.load(str(path)).hash() == \
        pgenesis.GenesisDoc.load(str(path)).hash()


def test_secp256k1_genesis_key_is_a_recorded_gap():
    """The gap is closed: the port registers secp256k1, so a secp256k1
    genesis key (repo form, hex, and Go tmjson form, base64) loads in
    both packages with the same key, address, power and document hash."""
    import base64

    g = "0279BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798"
    forms = [{"type": "secp256k1", "value": g.lower()},
             {"type": "tendermint/PubKeySecp256k1",
              "value": base64.b64encode(bytes.fromhex(g)).decode()}]
    for pk in forms:
        doc = json.dumps({"chain_id": CHAIN, "genesis_time": 5,
                          "validators": [{"pub_key": pk, "power": 1}]})
        got = []
        for p in (jgenesis, pgenesis):
            d = p.GenesisDoc.from_json(doc)
            d.validate_and_complete()
            v = d.validators[0]
            got.append((v.pub_key.type_name, v.pub_key.bytes(),
                        v.pub_key.address(), v.power, d.hash()))
        assert got[0] == got[1]
        assert got[0][0] == "secp256k1" and len(got[0][2]) == 20


# -- the ValidatorSet additions ---------------------------------------------


def _valset_cases(p):
    vs = valset(p, range(6), power=1)
    vs.validators[2].voting_power = 5
    vs._total = None
    out = []
    cp = vs.copy()
    cp.increment_proposer_priority(3)
    out.append(([v.proposer_priority for v in vs.validators],
                [v.proposer_priority for v in cp.validators],
                vs.proposer.address, cp.proposer.address,
                cp.proposer is cp.validators[cp.get_by_address(
                    cp.proposer.address)[0]], cp.hash() == vs.hash()))
    out.append([vs.has_address(v.address) for v in vs.validators]
               + [vs.has_address(b"\x00" * 20)])
    for times in (1, 2, 7):
        vs.increment_proposer_priority(times)
        out.append((vs.get_proposer().address,
                    [v.proposer_priority for v in vs.validators]))
    out.append(outcome(lambda: vs.increment_proposer_priority(0)))
    bare = p.vset.ValidatorSet([])
    bare.validators = [v.copy() for v in vs.validators]
    out.append((bare.proposer, bare.get_proposer().address))
    empty = p.vset.ValidatorSet([]).copy()
    out.append((len(empty), empty.proposer))
    return out


def test_validator_set_additions_equal_reference():
    got = {name: _valset_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]


# -- state/ ------------------------------------------------------------------


def _state_cases(p):
    gdoc = genesis_doc(p, range(5), app_hash=b"\x0b" * 32)
    st = p.state.make_genesis_state(gdoc)
    out = [(st.chain_id, st.initial_height, st.last_block_height,
            st.last_block_time, st.validators.hash(),
            st.next_validators.hash(),
            [v.proposer_priority for v in st.validators.validators],
            [v.proposer_priority for v in st.next_validators.validators],
            st.next_validators.proposer.address, len(st.last_validators),
            st.consensus_params.hash(), st.app_hash, st.is_empty())]
    cp = st.copy()
    cp.validators.increment_proposer_priority(2)
    cp.consensus_params.block.max_bytes = 4096
    out.append(([v.proposer_priority for v in st.validators.validators],
                st.consensus_params.block.max_bytes))
    empty = p.state.make_genesis_state(p.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=5))
    out.append((empty.is_empty(), len(empty.next_validators)))
    bid = p.block.BlockID(b"\x01" * 32, p.block.PartSetHeader(1, b"\x02" * 32))
    commit = sign_commit(p, st.validators, 1, 0, bid, GENESIS_TIME + 1,
                         signers={0, 1, 3, 4})
    block = st.make_block(2, [b"tx1", b"tx2"], commit, [],
                          st.validators.get_proposer().address,
                          GENESIS_TIME + 20)
    out.append((block.header.to_proto().finish(), block.hash(),
                block.to_bytes(), block.make_part_set().header().hash))
    out.append(p.state.median_time(commit, st.validators))
    skew = valset(p, range(5))
    skew.validators[0].voting_power = 100
    skew._total = None
    out.append(p.state.median_time(commit, skew))
    out.append(p.state.median_time(p.block.Commit(1, 0, bid, []),
                                   st.validators))
    res = [types.SimpleNamespace(code=c, data=d)
           for c, d in ((0, b""), (1, b"\x01\x02"), (7, b"x" * 40))]
    out.append((p.state.abci_results_hash(res),
                p.state.abci_results_hash([])))
    return out


def test_state_equals_reference():
    got = {name: _state_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]


# -- types/block_meta.py -----------------------------------------------------


def test_block_meta_codec_equal_reference():
    got = {}
    for name, p in PACKAGES.items():
        node = Node(p, n_heights=2, txs=lambda h: [b"t%d" % h])
        block = node.block_store.load_block(2)
        meta = p.block_meta.BlockMeta.from_block(block)
        stored = node.block_store.load_block_meta(2)
        got[name] = (meta.to_bytes(), stored.to_bytes(), stored.block_size,
                     stored.num_txs, stored.header.hash())
    assert got["port"] == got["reference"]
    for b in got["port"][:2]:
        for p in PACKAGES.values():
            assert p.block_meta.BlockMeta.from_bytes(b).to_bytes() == b


# -- the stores: byte-identical both ways ------------------------------------


def _rotating(h):
    return range(4) if h <= 3 else range(1, 6)


def _big_txs(h):
    return [bytes([h]) * 70_000] if h == 2 else [b"tx-%d" % h]


@pytest.mark.parametrize("shape", ["constant", "rotating", "two_parts"])
def test_node_stores_are_byte_identical(shape):
    kw = {"constant": {}, "rotating": {"n_heights": 6, "sets": _rotating},
          "two_parts": {"txs": _big_txs}}[shape]
    nodes = {name: Node(p, **kw) for name, p in PACKAGES.items()}
    assert db_bytes(nodes["port"].block_db) == \
        db_bytes(nodes["reference"].block_db)
    assert db_bytes(nodes["port"].state_db) == \
        db_bytes(nodes["reference"].state_db)
    if shape == "two_parts":
        meta = nodes["port"].block_store.load_block_meta(2)
        assert meta.block_id.part_set_header.total == 2


def _read_back(p, block_db, state_db, heights):
    """Everything one package's stores read from the given bytes."""
    bs = p.bstore.BlockStore(block_db)
    ss = p.sstore.Store(state_db)
    out = [(bs.base, bs.height, bs.size())]
    for h in heights:
        meta = bs.load_block_meta(h)
        block = bs.load_block(h)
        commit = bs.load_block_commit(h)
        seen = bs.load_seen_commit(h)
        vals = ss.load_validators(h)
        out.append((
            meta.to_bytes(), meta.block_id.hash, meta.header.hash(),
            block.to_bytes(), block.hash(),
            bs.load_block_by_hash(block.hash()).hash(),
            bs.load_block_part(h, 0).to_bytes(),
            commit.to_bytes() if commit else None, seen.to_bytes(),
            seen.hash(), vals.hash(),
            [(v.address, v.voting_power, v.proposer_priority)
             for v in vals.validators], vals.proposer.address))
    st = ss.load()
    out.append((st.chain_id, st.initial_height, st.last_block_height,
                st.last_block_id.hash, st.last_block_id.part_set_header.hash,
                st.last_block_time, st.validators.hash(),
                st.next_validators.hash(), st.last_validators.hash(),
                st.last_height_validators_changed,
                st.consensus_params.hash(),
                st.last_height_consensus_params_changed,
                st.last_results_hash, st.app_hash, st.app_version))
    out.append([(h, ss.load_consensus_params(h) and
                 ss.load_consensus_params(h).hash())
                for h in (1, 2, max(heights) + 1)])
    out.append((bs.load_block_meta(99), bs.load_block(99),
                bs.load_block_commit(max(heights)), ss.load_validators(99),
                bs.load_block_by_hash(b"\x00" * 32)))
    return out


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_stores_read_the_other_packages_bytes(direction):
    src, dst = ((REF, PORT) if direction == "reference_to_port"
                else (PORT, REF))
    node = Node(src, n_heights=6, sets=_rotating, txs=_big_txs)
    heights = range(1, 7)
    want = _read_back(src, node.block_db, node.state_db, heights)
    got = _read_back(dst, copy_db(dst, node.block_db),
                     copy_db(dst, node.state_db), heights)
    assert got == want
    assert want[-1] == (None, None, None, None, None)


def test_state_store_save_and_bootstrap_equal_reference():
    got = {}
    for name, p in PACKAGES.items():
        gdoc = genesis_doc(p, range(4), initial_height=5)
        st = p.state.make_genesis_state(gdoc)
        a = p.db.MemDB()
        p.sstore.Store(a).save(st)
        later = st.copy()
        later.last_block_height = 9
        later.last_validators = valset(p, range(1, 4))
        b = p.db.MemDB()
        p.sstore.Store(b).bootstrap(later)
        c = p.db.MemDB()
        p.sstore.Store(c).bootstrap(st)
        got[name] = (db_bytes(a), db_bytes(b), db_bytes(c),
                     p.sstore.Store(p.db.MemDB()).load())
    assert got["port"] == got["reference"]
    assert sorted(got["port"][1]) == [
        b"consensusParamsKey:" + (10).to_bytes(8, "big"), b"stateKey",
        *(b"validatorsKey:" + h.to_bytes(8, "big") for h in (9, 10, 11))]


def test_block_store_rules_equal_reference():
    got = {}
    for name, p in PACKAGES.items():
        node = Node(p, n_heights=2)
        bs, out = node.block_store, []
        block = bs.load_block(2)
        parts = block.make_part_set()
        out.append(outcome(lambda: bs.save_block(block, parts, None)))
        st = node.committed_state
        nxt = st.make_block(3, [], bs.load_seen_commit(2), [],
                            st.validators.get_proposer().address,
                            GENESIS_TIME + 30)
        half = p.block.PartSet(parts.total + 1, parts.hash)
        out.append(outcome(lambda: bs.save_block(nxt, half, None)))
        full = nxt.make_part_set()
        seen = sign_commit(p, st.validators, 3, 0,
                           p.block.BlockID(nxt.hash(), full.header()),
                           GENESIS_TIME + 31)
        p.failpoints.arm("store.save_block", "error")
        try:
            out.append(outcome(lambda: bs.save_block(nxt, full, seen)))
        finally:
            p.failpoints.disarm("store.save_block")
        out.append((bs.height, db_bytes(node.block_db) ==
                    db_bytes(Node(p, n_heights=2).block_db)))
        bs.save_block(nxt, full, seen)
        bs.save_seen_commit(1, seen)
        out.append((bs.height, bs.load_seen_commit(1).to_bytes(),
                    bs.load_block_commit(2).to_bytes()))
        out.append(db_bytes(node.block_db))
        got[name] = out
    assert got["port"] == got["reference"]
    assert got["port"][0][0] == "ValueError"
    assert got["port"][2] == ("FailpointError",
                              "injected failpoint 'store.save_block'")


def test_pruning_equal_reference():
    got = {}
    for name, p in PACKAGES.items():
        node = Node(p, n_heights=5)
        bs, ss, out = node.block_store, node.state_store, []
        out.append(outcome(lambda: bs.prune_blocks(9)))
        out.append((bs.prune_blocks(1), bs.prune_blocks(3), bs.base,
                    bs.size(), bs.load_block(2), bs.load_block(3).hash()))
        out.append(db_bytes(node.block_db))
        ss.prune_states(1, 4)
        ss.prune_states(0, 9)
        ss.prune_states(4, 4)
        out.append(db_bytes(node.state_db))
        reopened = p.bstore.BlockStore(node.block_db)
        out.append((reopened.base, reopened.height))
        got[name] = out
    assert got["port"] == got["reference"]
    assert got["port"][1][:4] == (0, 2, 3, 3)
