"""Port parity for the light Client (light/client.py), its providers
(light/provider.py) and its trusted store (light/store.py), against the
JAX package, in the shapes of tests/test_light.py.

Both packages build the same chains from the same seeds; each client
runs with a fixed clock. The bisection trace (every verify step's
trusted and target heights and its outcome), the trusted heights, the
LightStore bytes, the fetches, the witnesses kept and every error's
class and text must be equal. LightStore bytes are read across the
packages both ways. One test crosses _DEVICE_THRESHOLD so that K4's
plain version runs under the client (the reference's BatchVerifier is
held on the host). The port's one recorded divergence: a KernelError
out of a witness is re-raised, where the reference logs the witness as
unreachable. Tolerance: exact."""

import asyncio
import dataclasses
import types

import pytest
from test_torch_state_store import CHAIN, Node, sign_commit, valset
from test_torch_state_store import PACKAGES as NODE_PACKAGES

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.libs import db as jdb
from tendermint_tpu.light import client as jclient
from tendermint_tpu.light import provider as jprovider
from tendermint_tpu.light import store as jlstore
from tendermint_tpu.light import types as jltypes
from tendermint_tpu.light import verifier as jverifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto.cuda import kernels as pkernels
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import db as pdb
from tendermint_tpu_torch.light import client as pclient
from tendermint_tpu_torch.light import provider as pprovider
from tendermint_tpu_torch.light import store as plstore
from tendermint_tpu_torch.light import types as pltypes
from tendermint_tpu_torch.light import verifier as pverifier
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set

HOUR = 3600 * 1_000_000_000
T0 = 1_700_000_000 * 1_000_000_000
NOW = T0 + 100 * 1_000_000_000
PACKAGES = {
    "port": types.SimpleNamespace(
        ed=ped25519, db=pdb, client=pclient, provider=pprovider,
        lstore=plstore, lt=pltypes, verifier=pverifier, block=pblock,
        validator=pvalidator, vset=pvalidator_set),
    "reference": types.SimpleNamespace(
        ed=jed25519, db=jdb, client=jclient, provider=jprovider,
        lstore=jlstore, lt=jltypes, verifier=jverifier, block=jblock,
        validator=jvalidator, vset=jvalidator_set),
}
for _name, _p in PACKAGES.items():
    _p.__dict__.update({k: v for k, v in vars(NODE_PACKAGES[_name]).items()
                        if k not in vars(_p)})
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


def err(e):
    return (type(e).__name__, str(e))


def light_chain(p, n_heights, sets=lambda h: range(4), app_hash=b"\x04" * 32,
                fork=None):
    """{height: LightBlock} of one package: tests/test_light.py's
    LightChain, its sets given by `sets(h)`, each commit signed by the
    height's set. `fork` (a height) re-signs the headers from there up
    with another app hash: a provable fork of the same chain."""
    vsets = {}

    def vals(h):
        key = tuple(sets(h))
        if key not in vsets:
            vsets[key] = valset(p, key)
        return vsets[key]

    blocks, prev_bid = {}, None
    for h in range(1, n_heights + 1):
        v, nv = vals(h), vals(h + 1)
        header = p.block.Header(
            version_block=11, version_app=0, chain_id=CHAIN, height=h,
            time=T0 + h * 1_000_000_000, last_block_id=prev_bid,
            last_commit_hash=b"\x01" * 32, data_hash=b"\x02" * 32,
            validators_hash=v.hash(), next_validators_hash=nv.hash(),
            consensus_hash=b"\x03" * 32,
            app_hash=b"\xbb" * 32 if fork and h >= fork else app_hash,
            last_results_hash=b"\x05" * 32, evidence_hash=b"\x06" * 32,
            proposer_address=v.get_proposer().address)
        bid = p.block.BlockID(header.hash(),
                              p.block.PartSetHeader(1, b"\x07" * 32))
        commit = sign_commit(p, v, h, 0, bid, header.time + 1)
        blocks[h] = p.lt.LightBlock(p.lt.SignedHeader(header, commit), v)
        prev_bid = bid
    return blocks


def provider(p, blocks, tamper_height=None, fetches=None):
    """A provider serving `blocks`; at `tamper_height` a header whose app
    hash was changed after signing."""

    class P(p.provider.Provider):
        async def light_block(self, height):
            if fetches is not None:
                fetches.append(height)
            if height == 0:
                height = max(blocks)
            lb = blocks.get(height)
            if lb is None:
                raise p.provider.BlockNotFoundError(str(height))
            if height == tamper_height:
                forged = dataclasses.replace(lb.signed_header.header,
                                             app_hash=b"\xee" * 32)
                return p.lt.LightBlock(
                    p.lt.SignedHeader(forged, lb.signed_header.commit),
                    lb.validator_set)
            return lb

    return P()


def client(p, blocks, trust_height=1, witnesses=(), primary=None,
           db=None, **kw):
    return p.client.Client(
        CHAIN, p.client.TrustOptions(period_ns=HOUR, height=trust_height,
                                     hash=blocks[trust_height].hash()),
        primary or provider(p, blocks), list(witnesses),
        p.lstore.LightStore(db if db is not None else p.db.MemDB()),
        now_fn=lambda: NOW, **kw)


@pytest.fixture
def trace(monkeypatch):
    """Every verify step of each package's Client: (trusted height,
    target height, None or the exception's class)."""
    steps = {"port": [], "reference": []}
    for name, p in PACKAGES.items():
        real = p.client.verify

        def rec(chain_id, trusted, block, *a, _real=real, _log=steps[name]):
            try:
                _real(chain_id, trusted, block, *a)
            except Exception as e:
                _log.append((trusted.height(), block.height(),
                             type(e).__name__))
                raise
            _log.append((trusted.height(), block.height(), None))

        monkeypatch.setattr(p.client, "verify", rec)
    return steps


def _verify_at(p, height, sets=lambda h: range(4), n=16):
    blocks = light_chain(p, n, sets)
    cl = client(p, blocks)
    lb = run(cl.verify_light_block_at_height(height))
    return (lb.hash(), cl.store.heights(), cl.store.latest_height(),
            dict(cl.store.db.iterate()))


@pytest.mark.parametrize("shape", ["constant", "one_a_height", "a_sixth"])
def test_bisection_trace_equals_reference(shape, trace):
    """A constant set skips straight to the target; a set rotating one
    member a height, or a sixth of six every two heights (the chip's
    light_client shape at its scale), forces bisection: the same pivots, the same
    trusted heights, the same LightStore bytes."""
    sets = {"constant": lambda h: range(4),
            "one_a_height": lambda h: range(h, h + 4),
            "a_sixth": lambda h: range((h - 1) // 2, (h - 1) // 2 + 6)}[shape]
    got = {name: _verify_at(p, 16, sets) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert trace["port"] == trace["reference"]
    if shape == "constant":
        assert trace["port"] == [(1, 16, None)]
    else:
        assert len(got["port"][1]) > 2  # pivots were stored
        assert "NewValSetCantBeTrustedError" in {s[2] for s in trace["port"]}


def _client_cases(p):
    blocks = light_chain(p, 12)
    out = []
    bad = p.client.Client(CHAIN, p.client.TrustOptions(HOUR, 1, b"\xab" * 32),
                          provider(p, blocks), [],
                          p.lstore.LightStore(p.db.MemDB()),
                          now_fn=lambda: NOW)
    try:
        run(bad.initialize())
    except Exception as e:
        out.append(err(e))
    for args in ((0, 1, b"\x00" * 32), (HOUR, 0, b"\x00" * 32),
                 (HOUR, 1, b"\x00" * 31)):
        try:
            p.client.TrustOptions(*args).validate()
        except ValueError as e:
            out.append(err(e))
    cl = client(p, blocks)
    out.append(cl.trusted_light_block())
    first = run(cl.update())
    out.append((first.height(), run(cl.update()),
                cl.trusted_light_block().height(),
                cl.trusted_light_block(1).hash(),
                cl.trusted_light_block(5)))
    cl2 = client(p, blocks)
    run(cl2.initialize())
    out.append(run(cl2.initialize()).hash())
    out.append(run(cl2.verify_light_block_at_height(1)).hash())
    try:
        run(cl2.verify_light_block_at_height(99))
    except Exception as e:
        out.append(err(e))
    return out


def test_client_entry_points_equal_reference():
    got = {name: _client_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][0][1].startswith("trusted header hash mismatch")
    assert got["port"][-1] == ("BlockNotFoundError", "99")


def _witness_cases(p):
    blocks = light_chain(p, 8)
    honest, lying = provider(p, blocks), provider(p, blocks, tamper_height=8)
    cl = client(p, blocks, witnesses=[honest, lying])
    lb = run(cl.verify_light_block_at_height(8))
    return (lb.height(), [w is honest for w in cl.witnesses],
            cl.store.heights())


def test_unprovable_witness_is_dropped_as_in_reference():
    got = {name: _witness_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"] == (8, [True], [1, 8])


def _backwards_cases(p):
    blocks = light_chain(p, 8)
    cl = client(p, blocks)
    run(cl.verify_light_block_at_height(8))
    out = [cl.store.get(3)]
    lb3 = run(cl.verify_light_block_at_height(3))
    out.append((lb3.hash() == blocks[3].hash(), cl.store.heights(),
                sorted(cl._interim_cache)))
    tampered = client(p, blocks, primary=provider(p, blocks, tamper_height=5))
    run(tampered.verify_light_block_at_height(8))
    try:
        run(tampered.verify_light_block_at_height(3))
    except Exception as e:
        out.append(err(e))
    out.append(tampered.store.heights())
    expired = client(p, blocks)
    run(expired.verify_light_block_at_height(8))
    expired.trust_options.period_ns = 1
    try:
        run(expired.verify_light_block_at_height(2))
    except Exception as e:
        out.append(err(e))
    return out


def test_backwards_verification_equals_reference():
    got = {name: _backwards_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][1] == (True, [1, 3, 8], [3, 4, 5, 6, 7])
    assert got["port"][2][1].startswith("backwards verification failed at "
                                        "height 5")


def _primary_cases(p):
    blocks = light_chain(p, 8)

    class Dead(p.provider.Provider):
        async def light_block(self, height):
            raise p.provider.ProviderError("connection refused")

    good, dead = provider(p, blocks), Dead()
    cl = client(p, blocks, primary=dead, witnesses=[good])
    out = [run(cl.verify_light_block_at_height(5)).height(),
           cl.primary is good, cl.witnesses == [dead]]
    cl2 = client(p, blocks, witnesses=[provider(p, blocks)])
    try:
        run(cl2.verify_light_block_at_height(999))
    except Exception as e:
        out.append((err(e), len(cl2.witnesses)))
    cl3 = client(p, blocks, primary=Dead(), witnesses=[Dead()])
    try:
        run(cl3.verify_light_block_at_height(5))
    except Exception as e:
        out.append(err(e))
    return out


def test_dead_primary_promotes_witness_as_in_reference():
    got = {name: _primary_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][:3] == [5, True, True]
    assert got["port"][-1] == ("ProviderError", "connection refused")


def _scan_cases(p):
    blocks = light_chain(p, 8)
    inner, scans = p.db.MemDB(), []

    class CountingDB:
        def set(self, k, v):
            inner.set(k, v)

        def get(self, k):
            return inner.get(k)

        def delete(self, k):
            inner.delete(k)

        def iterate_prefix(self, prefix):
            scans.append(prefix)
            return inner.iterate_prefix(prefix)

    store = p.lstore.LightStore(CountingDB())
    out = []
    for h in (1, 3, 5):
        store.save(blocks[h])
    out.append((store.latest_height(), len(scans)))
    store.save(blocks[7])
    store.save(blocks[2])
    out.append((store.latest_height(), len(scans)))
    store.delete(2)
    out.append((store.latest_height(), len(scans)))
    store.delete(7)
    out.append((store.latest_height(), len(scans), store.lowest_height()))
    store.prune(1)
    out.append((store.heights(), store.latest_height(), len(scans)))
    store.prune(0)
    out.append((store.latest_height(), store.latest(), store.lowest_height()))
    return out


def test_store_latest_height_scans_equal_reference():
    got = {name: _scan_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][:3] == [(5, 1), (7, 1), (7, 1)]


def _cache_cases(p):
    blocks = light_chain(p, 30)
    fetches = []
    cl = client(p, blocks, primary=provider(p, blocks, fetches=fetches))
    run(cl.verify_light_block_at_height(30))
    run(cl.verify_light_block_at_height(10))
    out = [list(fetches)]
    fetches.clear()
    out.append((run(cl.verify_light_block_at_height(20)).height(),
                list(fetches)))
    cl2 = client(p, blocks, primary=provider(p, blocks, fetches=fetches))
    run(cl2.verify_light_block_at_height(30))
    cl2._interim_cache[29] = blocks[29]
    cl2.trust_options.period_ns = 70 * 1_000_000_000 + 500_000_000
    fetches.clear()
    out.append((run(cl2.verify_light_block_at_height(15)).height(),
                list(fetches)))
    return out


def test_backwards_cache_and_trusted_anchor_equal_reference():
    got = {name: _cache_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][1] == (20, [])
    assert 29 not in got["port"][2][1]


def _light_store_bytes(p, blocks):
    db = p.db.MemDB()
    store = p.lstore.LightStore(db)
    for h in (1, 4, 7):
        store.save(blocks[h])
    return db


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_light_store_bytes_cross_the_packages(direction):
    dbs = {name: _light_store_bytes(p, light_chain(p, 8, lambda h: range(
        h // 3, h // 3 + 5))) for name, p in PACKAGES.items()}
    assert dict(dbs["port"].iterate()) == dict(dbs["reference"].iterate())
    src, dst = (("reference", PORT) if direction == "reference_to_port"
                else ("port", REF))
    copy = dst.db.MemDB()
    copy.write_batch(list(dbs[src].iterate()))
    theirs = dst.lstore.LightStore(copy)
    ours = (PORT if src == "port" else REF).lstore.LightStore(dbs[src])
    assert theirs.heights() == ours.heights() == [1, 4, 7]
    for h in (1, 4, 7):
        a, b = theirs.get(h), ours.get(h)
        assert a.hash() == b.hash()
        assert a.signed_header.commit.to_bytes() == \
            b.signed_header.commit.to_bytes()
        assert a.validator_set.hash() == b.validator_set.hash()
        assert [v.proposer_priority for v in a.validator_set.validators] == \
            [v.proposer_priority for v in b.validator_set.validators]
        assert a.validator_set.proposer.address == \
            b.validator_set.proposer.address
        assert a.to_proto().finish() == b.to_proto().finish()
    assert theirs.latest().height() == 7


def _node_cases(p):
    node = Node(p, n_heights=6, sets=lambda h: range(4) if h <= 3
                else range(2, 6))
    prov = p.provider.BlockStoreProvider(node.block_store, node.state_store)
    head = run(prov.light_block(0))
    out = [(head.height(), head.signed_header.commit.to_bytes() ==
            node.block_store.load_seen_commit(6).to_bytes(),
            prov.provider_id())]
    try:
        run(prov.light_block(7))
    except Exception as e:
        out.append(err(e))
    out.append(run(prov.report_evidence(object())))
    trusted = run(prov.light_block(1))
    cl = p.client.Client(
        CHAIN, p.client.TrustOptions(HOUR, 1, trusted.hash()), prov, [prov],
        p.lstore.LightStore(p.db.MemDB()),
        now_fn=lambda: node.committed_state.last_block_time + 1)
    lb = run(cl.verify_light_block_at_height(5))
    out.append((lb.hash() == node.block_store.load_block_meta(5).block_id.hash,
                cl.store.heights()))
    out.append(run(cl.update()).height())
    return out


def test_client_over_node_stores_equals_reference():
    """BlockStoreProvider over a node's stores (the reference's
    live-node case without the network): the head is served from the
    seen commit, a missing height raises BlockNotFoundError."""
    got = {name: _node_cases(p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][0] == (6, True, "local")
    assert got["port"][1] == ("BlockNotFoundError",
                              "no light block at height 7")


def test_client_runs_plain_k4_past_the_device_threshold(trace, monkeypatch):
    """61 validators: a +2/3 check plans 41 lanes (>= _DEVICE_THRESHOLD),
    so the BatchVerifier under the client launches K4, here its plain
    version (one launch a check: initialize, then the skip's +2/3 check;
    the 1/3 trusting check's 21 lanes stay on the host)."""
    got, launches = {}, []
    real = pverify.general_verify

    def counted(*a):
        launches.append(len(a[0]))
        return real(*a)

    monkeypatch.setattr(pverify, "general_verify", counted)
    jbatch.set_force_host(True)
    try:
        for name, p in PACKAGES.items():
            got[name] = _verify_at(p, 3, lambda h: range(61), n=3)
    finally:
        jbatch.set_force_host(False)
    assert got["port"] == got["reference"]
    assert trace["port"] == trace["reference"] == [(1, 3, None)]
    assert launches == [128, 128]  # 41 live lanes in K4's smallest bucket


def _uncaught_cases(p, exc):
    blocks = light_chain(p, 6)

    class Faulty(p.provider.Provider):
        async def light_block(self, height):
            raise exc("a witness's K4 check failed")

    honest = provider(p, blocks)
    faulty = Faulty()
    cl = client(p, blocks, witnesses=[faulty, honest])
    try:
        lb = run(cl.verify_light_block_at_height(6))
        return ("returned", lb.height(), len(cl.witnesses))
    except Exception as e:
        return err(e) + (len(cl.witnesses),)


def test_kernel_error_from_a_witness_ends_the_call():
    """The recorded divergence: a KernelError (crypto.batch.UNCAUGHT)
    out of the witness cross-check re-raises in the port; the reference
    logs the witness as unreachable and returns the block. Any other
    error is "unreachable" in both, and the witness is kept."""
    assert _uncaught_cases(PORT, pkernels.KernelError) == (
        "KernelError", "a witness's K4 check failed", 2)
    assert _uncaught_cases(REF, pkernels.KernelError) == ("returned", 6, 2)
    assert _uncaught_cases(PORT, RuntimeError) == \
        _uncaught_cases(REF, RuntimeError) == ("returned", 6, 2)
