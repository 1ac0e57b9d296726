"""The port's abci-cli (tendermint_tpu_torch/abci/cli.py) held against the
JAX package's: each package's `kvstore` and `counter` servers run as
children (`python -m <package>.abci.cli kvstore --address
tcp://127.0.0.1:0`), and each package's console drives each server with
the same script (`batch`, and one-shot commands). Tolerance: exact —
the same printed lines, the same exit codes. `--abci grpc` is refused
by the port with NotImplementedError (the gRPC transport is not ported,
ROADMAP Queue A), a recorded divergence."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tendermint_tpu.abci import cli as jcli
from tendermint_tpu_torch.abci import cli as pcli

ROOT = Path(__file__).resolve().parents[1]
CLIS = {"port": pcli, "reference": jcli}
PKG = {"port": "tendermint_tpu_torch", "reference": "tendermint_tpu"}

KV_SCRIPT = """echo hello
info
deliver_tx "abc"
deliver_tx "def=xyz"
deliver_tx 0x6B65793D76616C
check_tx 0x00
commit
query "abc"
query "def"
query "key"
query "nothing"
bogus_command
"""
COUNTER_SCRIPT = """echo counter
info
deliver_tx 0x00
deliver_tx 0x01
check_tx 0x05
deliver_tx 0x05
commit
query "tx"
"""


@pytest.fixture(scope="module")
def servers():
    procs, addrs = [], {}
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    try:
        for k, pkg in PKG.items():
            for app in ("kvstore", "counter"):
                proc = subprocess.Popen(
                    [sys.executable, "-m", f"{pkg}.abci.cli", app,
                     "--address", "tcp://127.0.0.1:0"],
                    cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                procs.append(proc)
                line = proc.stdout.readline()
                m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
                assert m, line
                addrs[(k, app)] = (line.split(" on ")[0],
                                   f"tcp://127.0.0.1:{m.group(1)}")
        yield addrs
    finally:
        for proc in procs:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _run(k, argv, stdin: str = ""):
    """One console run of package `k` in a child: (exit code, stdout)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", f"{PKG[k]}.abci.cli", *argv],
                         cwd=str(ROOT), env=env, input=stdin,
                         capture_output=True, text=True, timeout=120)
    return res.returncode, res.stdout


def test_the_servers_announce_alike(servers):
    for app in ("kvstore", "counter"):
        assert servers[("port", app)][0] == servers[("reference", app)][0]


@pytest.mark.parametrize("app,script", [("kvstore", KV_SCRIPT),
                                        ("counter", COUNTER_SCRIPT)])
def test_batch_scripts_print_alike(servers, app, script):
    """Each console against each server: a fresh server per package, so
    the two runs of one server see its state after the first."""
    got = {}
    for srv in PKG:
        addr = servers[(srv, app)][1]
        for k in CLIS:
            got[(srv, k)] = _run(k, ["batch", "--address", addr], script)
    # the first run against each server is alike, and so is the second
    assert got[("port", "port")] == got[("reference", "port")]
    assert got[("port", "reference")] == got[("reference", "reference")]
    rc, out = got[("port", "port")]
    assert out.startswith("> echo ")
    if app == "kvstore":
        assert rc == 1 and "-> error: unknown command 'bogus_command'" in out
        assert "-> value: xyz" in got[("port", "reference")][1]
    else:
        assert rc == 0


def test_one_shot_commands_print_alike(servers):
    addr = {k: servers[(k, "kvstore")][1] for k in PKG}
    for argv in (["echo", "hi there"], ["info"], ["check_tx", "0x01"],
                 ["query", '"def"'], ["--address", "@", "commit"]):
        got = {}
        for k in CLIS:
            a = list(argv)
            if a[0] == "--address":
                a[1] = addr[k]
            else:
                a += ["--address", addr[k]]
            got[k] = _run(k, a)
        assert got["port"] == got["reference"], argv
        assert got["port"][0] == 0 and got["port"][1].startswith("-> code: ")


def test_grpc_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A, gRPC"):
        pcli.main(["echo", "x", "--abci", "grpc",
                   "--address", "tcp://127.0.0.1:1"])
