"""The port's lints (tendermint_tpu_torch/tools/check_{spans,ledger,
metrics,failpoints,scenarios}.py) against the reference's (the
repository's root tools/).

Each port lint reports nothing over tendermint_tpu_torch/. On small
source trees written under tmp_path each gives the same findings as the
reference's function given the same tree, with the package paths
mapped (tendermint_tpu/crypto/tpu -> tendermint_tpu_torch/crypto/cuda,
bench.py -> chip_smoke.py); among the cases, a
`_ledger.begin("general")` site, which both span lints flag (that site
in tendermint_tpu/crypto/tpu/verify.py is what fails the reference's
own test_check_spans_lint_and_overhead_budget). Where the port's rule
is wider or narrower by design it is pinned: a LaunchGroup
(`ledger.group`) records, and only tests/test_torch_*.py count as the
port's tests. The port's REQUIRED_KINDS are the reference's and all
registered, and its span and ledger-record costs stay within the
reference's budgets (50 us enabled, 10 us disabled).

Last, the sites the lints' test rules need exercised in the port's own
tests: the expanded-table dispatch (`ExpandedKeys._traced_verify`, one
ledger record a launch) and the failpoints consensus.speculate,
statesync.chunk and statesync.offer, each held to the reference on the
same inputs."""

import asyncio
import hashlib
import os
import re
import types

import pytest

from tendermint_tpu.libs import failpoints as ref_fp
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import failpoints as port_fp
from tendermint_tpu_torch.tools import (
    check_failpoints, check_ledger, check_metrics, check_scenarios,
    check_spans,
)
from tools import check_failpoints as ref_check_failpoints
from tools import check_ledger as ref_check_ledger
from tools import check_metrics as ref_check_metrics
from tools import check_scenarios as ref_check_scenarios
from tools import check_spans as ref_check_spans


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)
    port_fp.reset()
    ref_fp.reset()


def write(root, files: dict) -> str:
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return str(root)


def mapped(lines):
    """The reference's findings with its paths mapped to the port's."""
    return [re.sub(r"tendermint_tpu/(crypto/tpu/)?",
                   lambda m: "tendermint_tpu_torch/" + (
                       "crypto/cuda/" if m.group(1) else ""),
                   str(x)).replace("bench.py", "chip_smoke.py")
            for x in lines]


# -- the port is clean ---------------------------------------------------


def test_every_port_lint_is_clean_over_the_port():
    assert check_spans.find_ad_hoc_spans() == []
    assert check_spans.find_origin_parity_problems() == []
    assert check_spans.missing_required_kinds() == []
    assert check_ledger.collect_problems() == []
    assert check_metrics.collect_problems() == []
    assert check_failpoints.collect_problems() == []
    assert check_scenarios.collect_problems() == []


def test_required_kinds_and_budgets_are_the_references():
    from tendermint_tpu_torch.libs import tracing

    assert check_spans.REQUIRED_KINDS == ref_check_spans.REQUIRED_KINDS
    assert check_spans.REQUIRED_KINDS <= tracing.registered_kinds()
    assert (check_spans.ENABLED_BUDGET_S, check_spans.DISABLED_BUDGET_S) \
        == (ref_check_spans.ENABLED_BUDGET_S,
            ref_check_spans.DISABLED_BUDGET_S) == (50e-6, 10e-6)
    assert check_metrics.REQUIRED == ref_check_metrics.REQUIRED
    assert check_metrics.NAMESPACES == ref_check_metrics.NAMESPACES
    assert {q for _, q in check_ledger.DISPATCH_SITES} == \
        {q for _, q in ref_check_ledger.DISPATCH_SITES}
    assert sorted(mapped(f for f, _ in ref_check_ledger.DISPATCH_SITES)) \
        == sorted(f for f, _ in check_ledger.DISPATCH_SITES)


def test_overheads_are_within_the_reference_budgets():
    enabled, disabled = check_spans.measure_overhead(n=5000)
    assert enabled < check_spans.ENABLED_BUDGET_S, enabled
    assert disabled < check_spans.DISABLED_BUDGET_S, disabled
    assert check_ledger.measure_overhead(n=5000) < \
        check_spans.ENABLED_BUDGET_S


# -- the span lint -------------------------------------------------------

SPAN_TREE = {
    "pkg/a.py": (
        "from x import TRACER, tracing, _ledger\n"
        "KIND = tracing.CRYPTO_PACK\n"
        "def f(kind, y):\n"
        "    with TRACER.span('adhoc.kind', lanes=1):\n"
        "        pass\n"
        "    rec = _ledger.begin('general')\n"
        "    TRACER.begin(f'crypto.{y}')\n"
        "    TRACER.span(KIND)\n"
        "    TRACER.span(kind)\n"
        "    TRACER.span()\n"
        "    other.begin(b'bytes')\n"
        "    other.finish('ok')\n"),
    "pkg/sub/b.py": "def g(t):\n    return t.begin(\"consensus.x\")\n",
    "pkg/sub/c.txt": "t.span('not python')\n",
    "pkg/broken.py": "def (:\n",
}

REACTORS = {
    "clean": (
        "class ConsensusReactor:\n"
        "    def _stamped(self, msg):\n"
        "        msg.origin = tracing.origin_stamp(1)\n"
        "        return encode_consensus_msg(msg)\n"
        "    def receive(self, ch, peer, b):\n"
        "        tracing.rehydrate_origin(b)\n"
        "    def gossip(self):\n"
        "        self._stamped(VoteMessage(v))\n"
        "        m.encode_consensus_msg(NewRoundStepMessage(1))\n"),
    "raw_sends": (
        "class ConsensusReactor:\n"
        "    def _stamped(self, msg):\n"
        "        return encode_consensus_msg(msg)\n"
        "    def receive(self, ch, peer, b):\n"
        "        pass\n"
        "    async def gossip(self):\n"
        "        m.encode_consensus_msg(VoteMessage(v))\n"
        "        encode_consensus_msg(m.BlockPartMessage(1, 2, p))\n"),
    "no_helpers": "class ConsensusReactor:\n    pass\n",
    "no_class": "class Other:\n    pass\n",
}


def test_span_lint_findings_equal_the_references(tmp_path):
    root = write(tmp_path, SPAN_TREE)
    port = check_spans.find_ad_hoc_spans(root)
    assert port == ref_check_spans.find_ad_hoc_spans(root)
    flagged = [p.split(": ", 1)[1] for p in port]
    assert any("'general'" in p for p in flagged)  # the ledger site
    assert any("'adhoc.kind'" in p for p in flagged)
    assert any("f-string" in p for p in flagged)
    assert any("unparseable" in p for p in port)
    assert len(port) == 5


@pytest.mark.parametrize("variant", sorted(REACTORS))
def test_origin_parity_findings_equal_the_references(tmp_path,
                                                     monkeypatch, variant):
    pkg = write(tmp_path, {"pkg/consensus/reactor.py": REACTORS[variant]})
    pkg = os.path.join(pkg, "pkg")
    monkeypatch.setattr(check_spans, "PKG", pkg)
    monkeypatch.setattr(ref_check_spans, "PKG", pkg)
    port = check_spans.find_origin_parity_problems()
    assert port == ref_check_spans.find_origin_parity_problems()
    assert (port == []) == (variant == "clean")


# -- the ledger lint -----------------------------------------------------

LEDGER_FILES = {
    "verify.py": (
        "def verify_batch(p, m, s):\n"
        "    with _ledger.launch('general') as rec:\n"
        "        pass\n"
        "def helper():\n"
        "    ledger.record(kernel='x')\n"),
    "expanded.py": (
        "class ExpandedKeys:\n"
        "    def _traced_verify(self, n):\n"
        "        rec = _ledger.begin(self.kernel)\n"
        "    def other(self):\n"
        "        def inner():\n"
        "            my_ledger.launch('x')\n"
        "        return inner\n"),
    "resident.py": (
        "class ResidentArena:\n"
        "    def launch(self):\n"
        "        pass\n"
        "class MeshResidentArena:\n"
        "    def launch(self):\n"
        "        led.begin('resident_mesh')\n"),
    "sr_verify.py": "x = 1\n",
    "ledger.py": "def launch(k):\n    return ledger.begin(k)\n",
}
WORKLOAD_FILES = {
    "a.py": (
        "with ledger.workload('consensus'):\n    pass\n"
        "with _ledger.workload('nope'):\n    pass\n"
        "workload(tag)\n"),
    "sub/b.py": "with workload('light'):\n    pass\n",
}


def _ledger_tree(tmp_path, pkg: str, sub: str) -> str:
    files = {f"{pkg}/{sub}/{k}": v for k, v in LEDGER_FILES.items()}
    files.update({f"{pkg}/{k}": v for k, v in WORKLOAD_FILES.items()})
    files["bench.py" if pkg == "tendermint_tpu" else "chip_smoke.py"] = (
        "with ledger.workload('bench'):\n    pass\n")
    return write(tmp_path / pkg.replace("/", "_"), files)


def test_ledger_lint_findings_equal_the_references(tmp_path, monkeypatch):
    out = {}
    for mod, pkg, sub in ((ref_check_ledger, "tendermint_tpu",
                           "crypto/tpu"),
                          (check_ledger, "tendermint_tpu_torch",
                           "crypto/cuda")):
        root = _ledger_tree(tmp_path, pkg, sub)
        monkeypatch.setattr(mod, "REPO", root)
        monkeypatch.setattr(mod, "PKG", os.path.join(root, pkg))
        out[pkg] = (
            mod._qualnames_calling_ledger(
                os.path.join(root, pkg, sub, "expanded.py")),
            mod.check_dispatch_sites(),
            sorted((k, sorted(v)) for k, v in
                   mod.workload_call_sites().items()),
            mod.check_workloads())
    ref, port = out["tendermint_tpu"], out["tendermint_tpu_torch"]
    assert port[0] == ref[0] == {"ExpandedKeys._traced_verify": [3],
                                 "ExpandedKeys.other.inner": [6]}
    assert port[1] == mapped(ref[1])
    assert any("ResidentArena.launch is a cataloged dispatch site" in p
               for p in port[1])
    assert any("helper records launches" in p for p in port[1])
    assert port[2] == [(k, mapped(v)) for k, v in ref[2]]
    assert port[3] == mapped(ref[3])
    assert any("nope: workload() call site" in p for p in port[3])


def test_the_port_ledger_lint_counts_a_launch_group(tmp_path):
    path = write(tmp_path, {"m.py": (
        "def launch(self):\n"
        "    with _ledger.group('resident') as grp:\n"
        "        pass\n")})
    path = os.path.join(path, "m.py")
    assert check_ledger._qualnames_calling_ledger(path) == {"launch": [2]}
    assert ref_check_ledger._qualnames_calling_ledger(path) == {}


DOC = """# Doc

## Metrics catalog

| name | type |
| --- | --- |
| `consensus_height` | gauge |
| `made_up_total` | counter |

## Launch ledger & silicon watchdog

Tags: consensus, speculation, admission, light, fastsync, probe.

## Failpoint catalog

| point | where |
| --- | --- |
| `p2p.send` | x |
| `made.up` | y |

## Byzantine catalog

| kind | what |
| --- | --- |
| `equivocation` | x |
| `made_up_kind` | y |

### Scenario invariants

| `agreement` | x |
| `liveness` | y |

## Last
"""


def test_docs_and_tests_rules_equal_the_references(tmp_path, monkeypatch):
    doc = write(tmp_path, {"docs/D.md": DOC,
                           "tests/test_torch_a.py": (
                               "verify_batch launch p2p.send\n"
                               "equivocation timestamp_skew\n"),
                           "tests/sub/test_torch_b.py": "verify_batch_sr\n",
                           "tests/notes.txt": "_traced_verify\n"})
    doc_path = os.path.join(doc, "docs", "D.md")
    tests = os.path.join(doc, "tests")
    assert check_ledger.docs_section(doc_path) == \
        ref_check_ledger.docs_section(doc_path)
    assert "probe" in check_ledger.docs_section(doc_path)
    for mod in (ref_check_ledger, check_ledger):
        monkeypatch.setattr(mod, "TESTS", tests)
    ledger = [m.check_docs_and_tests() for m in (ref_check_ledger,
                                                 check_ledger)]
    assert [p.split(":")[0] for p in ledger[0]] == \
        [p.split(":")[0] for p in ledger[1]] == ["_traced_verify"]
    assert ledger[1][0].endswith("by any tests/test_torch_*.py file")

    assert check_metrics.docs_table_names(doc_path) == \
        ref_check_metrics.docs_table_names(doc_path) == \
        {"consensus_height", "made_up_total"}
    for mod in (ref_check_metrics, check_metrics):
        monkeypatch.setattr(mod, "DOCS", doc_path)
    declared = {"consensus_height", "p2p_peers"}
    assert check_metrics.check_docs_table(declared) == \
        ref_check_metrics.check_docs_table(declared)

    assert check_failpoints.docs_table_names(doc_path) == \
        ref_check_failpoints.docs_table_names(doc_path) == \
        {"p2p.send", "made.up"}
    names = {"p2p.send", "made.up", "equivocation"}
    assert check_failpoints.tests_mentioning(names, tests) == \
        ref_check_failpoints.tests_mentioning(names, tests) == \
        {"p2p.send", "equivocation"}

    for section in ("Byzantine catalog", "Scenario invariants", "Nope"):
        assert check_scenarios._docs_table(section, doc_path) == \
            ref_check_scenarios._docs_table(section, doc_path)
    kinds = {"equivocation", "timestamp_skew", "garbage_flood"}
    assert check_scenarios._tests_mentioning(kinds, tests) == \
        ref_check_scenarios._tests_mentioning(kinds, tests) == \
        {"equivocation", "timestamp_skew"}


def test_only_the_ports_tests_count_for_the_port(tmp_path):
    tests = write(tmp_path, {"test_other.py": "p2p.send equivocation\n"})
    assert check_failpoints.tests_mentioning({"p2p.send"}, tests) == set()
    assert ref_check_failpoints.tests_mentioning({"p2p.send"}, tests) == \
        {"p2p.send"}
    assert check_scenarios._tests_mentioning({"equivocation"},
                                             tests) == set()


FAILPOINT_TREE = {
    "pkg/a.py": (
        "from libs import failpoints\n"
        "failpoints.hit('db.set', key=1)\n"
        "await failpoints.hit_async('abci.deliver')\n"
        "_failpoint('state.apply.block_executed')\n"
        "hit('made.up')\n"
        "hit(name)\n"
        "other.miss('db.set')\n"),
    "pkg/sub/b.py": "x.hit(\"db.set\")\n",
    "pkg/bad.py": "def (:\n",
}


def test_failpoint_call_sites_equal_the_references(tmp_path):
    root = os.path.join(write(tmp_path, FAILPOINT_TREE), "pkg")
    port = check_failpoints.call_sites(root)
    assert port == ref_check_failpoints.call_sites(root)
    assert sorted(port) == ["abci.deliver", "db.set", "made.up",
                            "state.apply.block_executed"]
    assert len(port["db.set"]) == 2


# -- the sites the lints' test rules need --------------------------------


def test_an_expanded_verify_is_one_traced_dispatch_and_one_record(
        monkeypatch):
    """ExpandedKeys._traced_verify (the K3 dispatch site) on four keys:
    one call, one launch-ledger record on the CPU, verdicts the
    reference oracle's."""
    from tendermint_tpu.crypto import ed25519_ref as oracle
    from tendermint_tpu_torch.crypto import ed25519_ref
    from tendermint_tpu_torch.crypto.cuda import expanded, ledger

    seeds = [hashlib.sha256(b"lint%d" % i).digest() for i in range(4)]
    pubs = [ed25519_ref.public_key_from_seed(s) for s in seeds]
    msgs = [b"lint message %d" % i for i in range(4)]
    sigs = [ed25519_ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[2] = sigs[2][:7] + bytes([sigs[2][7] ^ 1]) + sigs[2][8:]
    calls = []
    orig = expanded.ExpandedKeys._traced_verify

    def spy(self, *a, **kw):
        calls.append(a[0])
        return orig(self, *a, **kw)

    monkeypatch.setattr(expanded.ExpandedKeys, "_traced_verify", spy)
    exp = expanded.ExpandedKeys(pubs)
    ledger.reset()  # the overhead microbench fills the ring
    got = exp.verify([0, 1, 2, 3], msgs, sigs)
    recs = ledger.snapshot()
    assert calls == [4]
    assert [bool(v) for v in got] == [oracle.verify(p, m, s) for p, m, s
                                      in zip(pubs, msgs, sigs)]
    assert [bool(v) for v in got] == [True, True, False, True]
    assert len(recs) == 1 and recs[0]["lanes"] == 4
    assert recs[0]["backend"] == "cpu-fallback"


def test_consensus_speculate_failpoint_equals_the_reference():
    """consensus.speculate corrupt (every speculated lane verified
    against a wrong timestamp) and error (the launch abandoned): the
    same serve, hits, misses and lanes in both packages' planes."""
    from test_torch_speculation import World, _scenario

    for action in ("corrupt", "error"):
        out = []
        for name, fp in (("port", port_fp), ("reference", ref_fp)):
            fp.arm("consensus.speculate", action)
            try:
                out.append(_scenario(World(name), "hit"))
            finally:
                fp.reset()
        assert out[0] == out[1], action
        assert out[0][0] == ("served", True) and out[0][1] == 0


def _chunk_msg(index, chunk=b"", missing=False):
    return types.SimpleNamespace(height=1, format=1, index=index,
                                 chunk=chunk, missing=missing)


def _syncer(package: str):
    """A one-peer, one-chunk restore whose app checks the applied bytes
    (the reference's failpoint-sweep doubles)."""
    import importlib

    abci = importlib.import_module(f"{package}.abci.types")
    snapshots = importlib.import_module(f"{package}.statesync.snapshots")
    syncer = importlib.import_module(f"{package}.statesync.syncer")
    data = b"\xaa" * 64

    class App:
        def __init__(self):
            self.chunks, self.offers = [], 0

        async def offer_snapshot(self, req):
            self.offers += 1
            self.chunks = []
            return abci.ResponseOfferSnapshot(
                abci.OfferSnapshotResult.ACCEPT)

        async def apply_snapshot_chunk(self, req):
            self.chunks.append(req.chunk)
            return abci.ResponseApplySnapshotChunk(
                abci.ApplySnapshotChunkResult.ACCEPT)

        async def info(self, req):
            ok = self.chunks == [data]
            return abci.ResponseInfo(
                last_block_height=1,
                last_block_app_hash=b"H" * 8 if ok else b"X" * 8)

    class Provider:
        async def app_hash(self, height):
            return b"H" * 8

        async def state(self, height):
            return f"state@{height}"

        async def commit(self, height):
            return f"commit@{height}"

    app = App()
    s = syncer.Syncer(app, Provider(), request_chunk=None,
                      discovery_time=0.2)

    async def feeder(peer_id, snapshot, idx):
        s.add_chunk(_chunk_msg(idx, data), peer_id=peer_id)

    s.request_chunk = feeder
    s.add_snapshot("peerA", snapshots.Snapshot(height=1, format=1,
                                               chunks=1, hash=b"h"))
    return app, s, data, snapshots, syncer


def _statesync_failpoints(package: str, fp) -> dict:
    async def go():
        out = {}
        _app, s, _data, snapshots, _sy = _syncer(package)
        snap = snapshots.Snapshot(height=1, format=1, chunks=2, hash=b"h")
        s.pool.add("peerA", snap)
        s._active = snap
        fp.arm("statesync.chunk", "corrupt")
        s.add_chunk(_chunk_msg(0, b"\xaa" * 64), peer_id="peerA")
        out["corrupted"] = s._chunks[0].hex()
        fp.reset()
        fp.arm("statesync.chunk", "error")
        try:
            s.add_chunk(_chunk_msg(1, b"\xbb" * 64), peer_id="peerA")
        except Exception as e:
            out["chunk_error"] = (type(e).__name__, str(e))
        fp.reset()
        app, s, data, _snapshots, _sy = _syncer(package)
        fp.arm("statesync.offer", "error")
        try:
            await asyncio.wait_for(s.sync_any(), 10)
        except Exception as e:
            out["offer_error"] = (type(e).__name__, str(e))
        out["after_offer_error"] = (app.offers, app.chunks)
        fp.reset()
        app2, s2, data, _snapshots, _sy = _syncer(package)
        state, commit = await asyncio.wait_for(s2.sync_any(), 10)
        out["restarted"] = (state, commit, app2.chunks == [data])
        return out

    try:
        return asyncio.run(go())
    finally:
        fp.reset()


def test_statesync_chunk_and_offer_failpoints_equal_the_reference():
    """statesync.chunk corrupt (the stored chunk is not the wire's) and
    error (raised from add_chunk); statesync.offer error (the sync dies
    before the app sees an offer, and a fresh syncer then restores):
    the same in both packages."""
    port = _statesync_failpoints("tendermint_tpu_torch", port_fp)
    ref = _statesync_failpoints("tendermint_tpu", ref_fp)
    assert port == ref
    assert port["corrupted"] != (b"\xaa" * 64).hex()
    assert port["chunk_error"][0] == "FailpointError"
    assert port["offer_error"][0] == "FailpointError"
    assert port["after_offer_error"] == (0, [])
    assert port["restarted"] == ("state@1", "commit@1", True)
