"""`debug dump|trace|kill` of the port (tendermint_tpu_torch/cmd/debug.py)
held against the JAX package's (tendermint_tpu/cmd/debug.py): both
packages' commands read one port node, started by `python -m
tendermint_tpu_torch.cmd start --device cpu` in a child with its debug
server on, over its RPC and /metrics, /debug/trace, /status and the
pprof routes. Tolerance: exact — the same bundle file lists, the same
printed lines (paths aside), the same exit codes; the port's kill ends
the node. Ports are the OS's free ones, never fixed."""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import tarfile
from pathlib import Path

from tendermint_tpu import cmd as jcmd
from tendermint_tpu_torch import cmd as pcmd
from tendermint_tpu_torch.config import Config
from test_torch_cli import _free_port, _status

ROOT = Path(__file__).resolve().parents[1]
CMDS = {"port": pcmd, "reference": jcmd}


def _boot(tmp_path):
    home = str(tmp_path / "home")
    assert pcmd.main(["--home", home, "init", "--chain-id",
                      "debug-chain"]) == 0
    cp = os.path.join(home, "config", "config.toml")
    cfg = Config.load(cp)
    rpc, pprof = _free_port(), _free_port()
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc}"
    cfg.rpc.pprof_laddr = f"tcp://127.0.0.1:{pprof}"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.base.fast_sync = False
    cfg.consensus.timeout_commit_ms = 50
    cfg.save(cp)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", home,
         "start", "--device", "cpu"], cwd=str(ROOT), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return home, rpc, pprof, proc


def test_dump_trace_and_kill_from_a_port_node(tmp_path, capsys):
    home, rpc, pprof, proc = _boot(tmp_path)
    addrs = ["--rpc-laddr", f"127.0.0.1:{rpc}",
             "--pprof-laddr", f"127.0.0.1:{pprof}"]
    try:
        asyncio.run(_status(rpc, 2))
        got = {}
        for k, c in CMDS.items():
            out_dir = str(tmp_path / f"bundles-{k}")
            capsys.readouterr()
            rc = c.main(["debug", "dump", out_dir, "--count", "1",
                         "--home", home, *addrs])
            printed = capsys.readouterr().out.replace(out_dir, "<D>")
            (bundle,) = os.listdir(out_dir)
            with tarfile.open(os.path.join(out_dir, bundle)) as tar:
                names = sorted(n for n in tar.getnames()
                               if not n.startswith("cs.wal/"))
                docs = {n: tar.extractfile(n).read() for n in (
                    "status.json", "metrics.txt", "trace.json",
                    "node_health.json", "goroutine.txt")}
            trace_file = str(tmp_path / f"trace-{k}.json")
            trc = c.main(["debug", "trace", trace_file, *addrs])
            tprinted = capsys.readouterr().out
            got[k] = (rc, printed.split(":")[0], names, trc,
                      tprinted.split(" spans: ")[0].split()[0])
            assert json.loads(docs["status.json"])["node_info"][
                "network"] == "debug-chain"
            assert b"# TYPE " in docs["metrics.txt"]
            assert "traceEvents" in json.loads(docs["trace.json"])
            assert set(json.loads(docs["node_health.json"])["checks"]) >= \
                {"consensus", "device"}
            assert b"asyncio tasks" in docs["goroutine.txt"]
        assert got["port"] == got["reference"]
        rc, printed, names, trc, _ = got["port"]
        assert rc == 0 and trc == 0 and printed == "wrote debug bundle"
        assert "INCOMPLETE.txt" not in names
        assert {"status.json", "net_info.json", "consensus_state.json",
                "goroutine.txt", "heap.txt", "trace.json",
                "trace_rollup.json", "metrics.txt", "node_health.json",
                "config.toml", "cs.wal"} <= set(names)

        kill_out = str(tmp_path / "kill.tar.gz")
        assert pcmd.main(["debug", "kill", str(proc.pid), kill_out,
                          "--home", home, *addrs]) == 0
        with tarfile.open(kill_out) as tar:
            assert "consensus_state.json" in tar.getnames()
            assert "INCOMPLETE.txt" not in tar.getnames()
        assert proc.wait(timeout=15) != 0  # SIGABRT, not a clean exit
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_kill_of_a_missing_process_is_incomplete_alike(tmp_path, capsys):
    pid = 2 ** 22 - 3
    while True:
        try:
            os.kill(pid, 0)
            pid -= 1
        except ProcessLookupError:
            break
        except PermissionError:
            pid -= 1
    dead = _free_port()
    got = {}
    for k, c in CMDS.items():
        out = str(tmp_path / f"{k}.tar.gz")
        capsys.readouterr()
        rc = c.main(["debug", "kill", str(pid), out, "--home",
                     str(tmp_path / "nohome"), "--rpc-laddr",
                     f"127.0.0.1:{dead}", "--pprof-laddr",
                     f"127.0.0.1:{dead}"])
        lines = [line.split(":")[0] for line in
                 capsys.readouterr().out.splitlines()]
        with tarfile.open(out) as tar:
            got[k] = (rc, lines, sorted(tar.getnames()))
    assert got["port"] == got["reference"]
    assert got["port"][0] == 1 and got["port"][2] == ["INCOMPLETE.txt"]
