"""The port's e2e tools (tendermint_tpu_torch/tools/{check_recovery,
crash_sweep,height_forensics,soak}.py) against the repository's root
tools/ of the same names.

check_recovery reports nothing over the port, and the same findings as
the reference's with a sweep spec removed or a pipeline point left out
of the tests. crash_sweep's specs are the reference's and cover the
commit-pipeline catalog in its order (the reference's
test_pipeline_order_matches_catalog); its full sweep, slow as the
reference's, runs solo nodes with --device cpu on ports from the OS.
height_forensics, against two tiny local HTTP servers serving
synthetic /debug/trace anchors and spans, prints the same TIMELINE and
TIMELINE_SUMMARY lines and exits with the same codes as the
reference's. soak's log sweep flags the same lines, with and without
--chaos."""

import http.server
import json
import os
import sys
import threading

import pytest

from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs.failpoints import COMMIT_PIPELINE
from tendermint_tpu_torch.tools import (
    check_recovery, crash_sweep, height_forensics, soak,
)

from test_torch_forensics import NODES, chrome_doc, synthetic_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import check_recovery as ref_check_recovery  # noqa: E402
import crash_sweep as ref_crash_sweep  # noqa: E402
import height_forensics as ref_height_forensics  # noqa: E402
import soak as ref_soak  # noqa: E402

# Pins the sweep's coverage to the catalog with literal names, as the
# reference's tests/test_crash_sweep.py does.
PIPELINE_ORDER = [
    "wal.fsync",
    "db.set",
    "store.save_block",
    "consensus.commit.block_saved",
    "consensus.commit.wal_delimited",
    "state.apply.block_executed",
    "state.apply.responses_saved",
    "state.apply.app_committed",
    "state.apply.state_saved",
    "privval.save",
]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def test_pipeline_order_matches_catalog():
    assert PIPELINE_ORDER == list(COMMIT_PIPELINE)
    assert set(crash_sweep.SWEEP_SPECS) == set(COMMIT_PIPELINE)
    assert crash_sweep.SWEEP_SPECS == ref_crash_sweep.SWEEP_SPECS
    assert crash_sweep.BASE_PORT != ref_crash_sweep.BASE_PORT


def test_check_recovery_reports_nothing_on_the_port(capsys):
    assert check_recovery.collect_problems() == []
    assert check_recovery.main() == 0
    assert capsys.readouterr().out.splitlines()[-1] == "OK"


def test_check_recovery_agrees_with_the_reference_without_a_spec(
        monkeypatch):
    for mod in (crash_sweep, ref_crash_sweep):
        monkeypatch.setattr(mod, "SWEEP_SPECS", {
            k: v for k, v in mod.SWEEP_SPECS.items() if k != "db.set"})
    port = check_recovery.collect_problems()
    assert port == ref_check_recovery.collect_problems()
    assert port == ["db.set: commit-pipeline point with no crash spec in "
                    "tools/crash_sweep.py SWEEP_SPECS"]


def test_check_recovery_agrees_when_the_tests_miss_a_point(monkeypatch,
                                                           tmp_path):
    (tmp_path / "test_torch_points.py").write_text("\n".join(
        f"# {p}" for p in PIPELINE_ORDER if p != "privval.save"))
    monkeypatch.setattr(check_recovery, "TESTS", str(tmp_path))
    monkeypatch.setattr(ref_check_recovery, "TESTS", str(tmp_path))
    port = check_recovery.collect_problems()
    ref = ref_check_recovery.collect_problems()
    assert port == [p.replace("any tests/ file",
                              "any tests/test_torch_*.py file") for p in ref]
    assert len(port) == 1 and port[0].startswith("privval.save:")


def test_check_recovery_reads_only_the_ports_tests(monkeypatch, tmp_path):
    """A reference test file naming every point does not count."""
    (tmp_path / "test_other.py").write_text("\n".join(PIPELINE_ORDER))
    monkeypatch.setattr(check_recovery, "TESTS", str(tmp_path))
    assert len(check_recovery.collect_problems()) == len(PIPELINE_ORDER)


class _Fleet:
    """Tiny HTTP servers on ports from the OS, each serving one node's
    /debug/trace/anchor and /debug/trace (synthetic spans)."""

    def __init__(self, docs: dict):
        self.servers = []
        self.specs = []
        for label, doc in docs.items():
            anchor = json.dumps({"mono_ns": 1_000, "wall_ns": 6_001_000,
                                 "spans_dropped": 0, "capacity": 16384})

            class Handler(http.server.BaseHTTPRequestHandler):
                def do_GET(self, doc=doc, anchor=anchor):
                    body = (anchor if self.path == "/debug/trace/anchor"
                            else json.dumps(doc)).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *a):
                    pass

            srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.servers.append(srv)
            self.specs += ["--node",
                           f"{label}=127.0.0.1:{srv.server_address[1]}"]

    def close(self):
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()


def _run_tool(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    cap = capsys.readouterr()
    return rc, cap.out


@pytest.mark.parametrize("extra", [[], ["--last", "3"], ["--height", "5"],
                                   ["--json"]])
def test_height_forensics_prints_the_references_lines(capsys, extra):
    recs = synthetic_records(4)
    fleet = _Fleet({n: chrome_doc(recs, n) for n in NODES[:2]})
    try:
        port = _run_tool(height_forensics.main, fleet.specs + extra, capsys)
        ref = _run_tool(ref_height_forensics.main, fleet.specs + extra,
                        capsys)
    finally:
        fleet.close()
    assert port == ref
    rc, out = port
    assert rc == 0
    lines = out.splitlines()
    if "--json" not in extra:
        assert lines[-1].startswith("TIMELINE_SUMMARY ")
        assert all(ln.startswith("TIMELINE ") for ln in lines[:-1])
    assert len(lines) >= 2


def test_height_forensics_exit_codes_match(capsys):
    fleet = _Fleet({"a": {"traceEvents": []}, "b": {"traceEvents": []}})
    try:
        port = _run_tool(height_forensics.main, fleet.specs, capsys)
        ref = _run_tool(ref_height_forensics.main, fleet.specs, capsys)
    finally:
        fleet.close()
    assert port == ref == (1, "")
    assert _run_tool(height_forensics.main, [], capsys)[0] == \
        _run_tool(ref_height_forensics.main, [], capsys)[0] == 2
    assert height_forensics.parse_nodes(["x=h:1", "h:2"]) == \
        ref_height_forensics.parse_nodes(["x=h:1", "h:2"])


LOG = b"""I node started
E consensus: Traceback (most recent call last):
W p2p: stopping peer abc: connection lost AssertionError
E consensus: routine for gossipVotes died
W mempool: AttributeError on a bad tx
I p2p: reconnect to peer attribute
E asyncio: Task exception was never retrieved
I failpoint firing: injected failpoint wal.fsync action=error
E wal: Traceback (most recent call last):
""" + b"I filler\n" * 45 + b"""E state: Traceback (most recent call last):
I tail
"""


@pytest.mark.parametrize("chaos", [False, True])
def test_soak_log_sweep_flags_the_same_lines(tmp_path, chaos):
    path = tmp_path / "node.log"
    path.write_bytes(LOG)
    got = soak._sweep_log(str(path), 2, chaos)
    assert got == ref_soak._sweep_log(str(path), 2, chaos)
    assert got and all(b[0] == 2 for b in got)
    assert soak.HARD.pattern == ref_soak.HARD.pattern
    assert soak.CHAOS_ROTATION == ref_soak.CHAOS_ROTATION


def test_the_soak_manifest_is_valid():
    from tendermint_tpu_torch.e2e import Manifest

    m = Manifest.from_dict(soak.soak_manifest(5, 4, True))
    assert len(m.perturbations) == 10 and m.wait_height == 375
    assert {p.op for p in m.perturbations} == {
        "kill", "pause", "restart", "disconnect", "disconnect_hard",
        "chaos"}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """One clean solo run per module: height -> app hash hex."""
    out = str(tmp_path_factory.mktemp("oracle"))
    return crash_sweep.oracle_run(out, None, upto=6, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("point", PIPELINE_ORDER)
def test_crash_point_recovers(tmp_path, point, oracle):
    report = crash_sweep.run_case(str(tmp_path / "net"), point, None,
                                  oracle=oracle, device="cpu")
    assert report["ok"]
    assert report["advanced_to"] >= report["resumed_at"] + 2
