"""The port's command line (tendermint_tpu_torch/cmd) held against the JAX
package's (tendermint_tpu/cmd) on the same inputs.

Every subcommand that runs without a node (init, testnet, gen-validator,
show-validator, gen-node-key, show-node-id, unsafe-reset-all,
unsafe-reset-priv-validator, replay-console, version) is run by both
packages' `main([...])` with the same arguments and the same randomness
(os.urandom and time.time_ns replaced by one seeded source): the printed
lines and every written file are equal byte for byte, and a home written
by either package reads the same in the other. `start --device cpu` in a
child on a home the JAX package wrote serves /status and commits heights,
`light --once` runs against it (a port Node with RPC on), `replay` runs on
its stopped home; `start` without a GPU and without the flag exits
non-zero naming NoDeviceError and binds no port; `--misbehavior` is
refused without TM_TPU_ENABLE_MAVERICK=1 as the reference refuses it.
Tolerance: exact. Ports are the OS's free ones (bound at 0), never fixed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from tendermint_tpu import cmd as jcmd
from tendermint_tpu.config import Config as JConfig
from tendermint_tpu_torch import cmd as pcmd
from tendermint_tpu_torch import device
from tendermint_tpu_torch.config import Config as PConfig

ROOT = Path(__file__).resolve().parents[1]
CMDS = {"port": pcmd, "reference": jcmd}
PKG = {"port": "tendermint_tpu_torch", "reference": "tendermint_tpu"}


def _seeded(monkeypatch, seed: bytes) -> None:
    """One deterministic source for both packages' keys, chain ids and
    genesis times."""
    state = {"n": 0}

    def urandom(n: int) -> bytes:
        state["n"] += 1
        out = b""
        while len(out) < n:
            out += hashlib.sha256(seed + b"%d/%d" % (state["n"],
                                                     len(out))).digest()
        return out[:n]

    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr(time, "time_ns", lambda: 1_760_000_000_123_456_789)


def _run(k, argv, capsys, home: str | None = None, tag: str = "<H>"):
    capsys.readouterr()
    rc = CMDS[k].main(argv)
    out = capsys.readouterr()
    text = out.out + out.err
    if home:
        text = text.replace(home, tag)
    return rc, text


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = Path(p).read_bytes().replace(
                root.encode(), b"<H>")
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_init_and_key_commands_equal_the_reference(tmp_path, monkeypatch,
                                                   capsys):
    got = {}
    for k in CMDS:
        _seeded(monkeypatch, b"init")
        home = str(tmp_path / k)
        seq = [_run(k, ["--home", home, "init", "--chain-id", "cli-chain"],
                    capsys, home)]
        seq.append(_run(k, ["--home", home, "init"], capsys, home))
        for argv in (["show-node-id"], ["show-validator"], ["gen-validator"],
                     ["version"], ["gen-node-key"]):
            seq.append(_run(k, ["--home", home, *argv], capsys, home))
        seq.append(_run(k, ["init", "--home", home], capsys, home))
        got[k] = (seq, _tree(home))
    assert got["port"] == got["reference"]
    seq, tree = got["port"]
    assert seq[0][0] == 0 and "Generated genesis file" in seq[0][1]
    assert len(seq[2][1].strip()) == 40
    assert json.loads(seq[3][1])["type"] == "ed25519"
    assert seq[6] == (1, "node key already exists at "
                         "<H>/config/node_key.json\n")
    assert {"config/genesis.json", "config/node_key.json",
            "config/priv_validator_key.json", "config/config.toml"} <= \
        set(tree)


def test_testnet_homes_equal_the_reference(tmp_path, monkeypatch, capsys):
    got = {}
    for k in CMDS:
        _seeded(monkeypatch, b"testnet")
        out = str(tmp_path / k)
        rc = _run(k, ["testnet", "--v", "4", "--o", out, "--chain-id",
                      "mesh-chain", "--starting-port", "29100"], capsys, out)
        got[k] = (rc, _tree(out))
    assert got["port"] == got["reference"]
    rc, tree = got["port"]
    assert rc == (0, "Successfully initialized 4 node directories in <H>\n")
    assert len({tree[f"node{i}/config/genesis.json"] for i in range(4)}) == 1
    cfg = tree["node2/config/config.toml"].decode()
    assert "tcp://127.0.0.1:29102" in cfg and cfg.count("@127.0.0.1:") == 3


def test_homes_read_the_same_in_both_packages(tmp_path, capsys):
    """A home each package writes (fresh randomness) reads the same in
    both: show-validator, show-node-id, Config.load, the genesis."""
    from tendermint_tpu.types.genesis import GenesisDoc as JGen
    from tendermint_tpu_torch.types.genesis import GenesisDoc as PGen

    for writer in CMDS:
        home = str(tmp_path / f"by-{writer}")
        assert CMDS[writer].main(["--home", home, "init"]) == 0
        reads = {k: [_run(k, ["--home", home, a], capsys)
                     for a in ("show-validator", "show-node-id")]
                 for k in CMDS}
        assert reads["port"] == reads["reference"]
        cp = os.path.join(home, "config", "config.toml")
        assert dataclasses.asdict(PConfig.load(cp)) == \
            dataclasses.asdict(JConfig.load(cp))
        gp = os.path.join(home, "config", "genesis.json")
        assert PGen.load(gp).hash() == JGen.load(gp).hash()
        # re-saving in the other package writes the same bytes
        raw = Path(cp).read_bytes()
        (PConfig if writer == "reference" else JConfig).load(cp).save(cp)
        assert Path(cp).read_bytes() == raw


def test_reset_commands_and_replay_console_equal_the_reference(
        tmp_path, monkeypatch, capsys):
    from tendermint_tpu.consensus import wal as jwal

    got = {}
    for k in CMDS:
        _seeded(monkeypatch, b"reset")
        home = str(tmp_path / k)
        seq = [_run(k, ["--home", home, "init"], capsys, home)]
        seq.append(_run(k, ["--home", home, "replay-console"], capsys, home))
        wal_path = os.path.join(home, "data", "cs.wal", "wal")
        w = jwal.WAL(wal_path)
        for h in (1, 2, 3):
            w.write(jwal.EndHeightMessage(h), time_ns=h * 1000)
        w.flush_and_sync()
        w.close()
        feeds = iter(["", "1", "q"])
        monkeypatch.setattr("builtins.input", lambda *_: next(feeds))
        seq.append(_run(k, ["--home", home, "replay-console"], capsys, home))
        def eof(*_):
            raise EOFError

        monkeypatch.setattr("builtins.input", eof)
        seq.append(_run(k, ["--home", home, "replay-console"], capsys, home))
        state_file = os.path.join(home, "data", "priv_validator_state.json")
        Path(state_file).write_text(json.dumps({"height": 7, "round": 1,
                                                "step": 3}))
        Path(home, "data", "blockstore.db").write_bytes(b"x")
        Path(home, "config", "addrbook.json").write_text("{}")
        seq.append(_run(k, ["--home", home, "unsafe-reset-priv-validator"],
                        capsys, home))
        os.remove(os.path.join(home, "config", "priv_validator_key.json"))
        seq.append(_run(k, ["--home", home, "unsafe-reset-priv-validator"],
                        capsys, home))
        seq.append(_run(k, ["--home", home, "unsafe-reset-all",
                            "--keep-addr-book"], capsys, home))
        seq.append(_run(k, ["--home", home, "unsafe-reset-all"], capsys,
                        home))
        got[k] = (seq, _tree(home))
    assert got["port"] == got["reference"]
    seq, tree = got["port"]
    assert seq[1][0] == 1 and "no WAL at" in seq[1][1]
    assert "1 segment(s)" in seq[2][1] and "EndHeightMessage" in seq[2][1]
    assert seq[3][1].count("EndHeightMessage") == 0  # EOF quits at once
    assert "config/addrbook.json" not in tree
    assert "data/blockstore.db" not in tree


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               PYTHONUNBUFFERED="1")
    env.pop("TM_TPU_ENABLE_MAVERICK", None)
    env.update(extra)
    return env


def _spawn(k, argv, **env):
    return subprocess.Popen([sys.executable, "-m", f"{PKG[k]}.cmd", *argv],
                            cwd=str(ROOT), env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _stop(proc) -> str:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.stdout.read()


def _single_node_home(path: str, writer: str) -> tuple[str, int]:
    """A one-validator home written by `writer`'s init, on free ports,
    with no fast sync and a short commit timeout."""
    assert CMDS[writer].main(["--home", path, "init", "--chain-id",
                              "boot-chain"]) == 0
    cp = os.path.join(path, "config", "config.toml")
    cfg = (PConfig if writer == "port" else JConfig).load(cp)
    rpc = _free_port()
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc}"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.base.fast_sync = False
    cfg.consensus.timeout_commit_ms = 50
    cfg.save(cp)
    return path, rpc


async def _status(port: int, height: int, timeout: float = 60.0) -> dict:
    from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

    cli = HTTPClient("127.0.0.1", port, timeout=5)
    deadline = time.monotonic() + timeout
    while True:
        try:
            st = await cli.call("status")
            if int(st["sync_info"]["latest_block_height"]) >= height:
                return st
        except Exception:
            if time.monotonic() > deadline:
                raise
        await asyncio.sleep(0.3)


def test_start_on_the_cpu_serves_rpc_light_follows_and_replay_runs(
        tmp_path, capsys):
    """`start --device cpu` (a child) on a home the JAX package wrote:
    /status answers and heights commit; `light --once` (this process,
    --device cpu) verifies the node's head over its RPC from a trusted
    height 1; then, the node stopped, `replay` runs on its home."""
    home, rpc = _single_node_home(str(tmp_path / "home"), "reference")
    proc = _spawn("port", ["--home", home, "start", "--device", "cpu"])
    try:
        st = asyncio.run(_status(rpc, 3))
        assert st["node_info"]["network"] == "boot-chain"

        async def trusted():
            from tendermint_tpu_torch.rpc.jsonrpc import HTTPClient

            cli = HTTPClient("127.0.0.1", rpc, timeout=5)
            return (await cli.call("commit", height=1))[
                "signed_header"]["commit"]["block_id"]["hash"]

        h1 = asyncio.run(trusted())
        rc, out = _run("port", ["light", "boot-chain", "--primary",
                                f"127.0.0.1:{rpc}", "--trust-height", "1",
                                "--trust-hash", h1, "--once",
                                "--device", "cpu"], capsys)
        assert rc == 0, out
        assert out.startswith("trusted root at height 1: ")
        assert "verified height " in out
    finally:
        device.set_default_device("cpu")
        log = _stop(proc)
    assert "node node started" in log or "started" in log, log[-2000:]
    res = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cmd",
                          "--home", home, "replay", "--device", "cpu"],
                         cwd=str(ROOT), env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "replay complete; consensus at height " in res.stdout


def test_start_without_a_gpu_or_the_flag_exits_before_binding(tmp_path):
    home, rpc = _single_node_home(str(tmp_path / "home"), "port")
    res = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cmd",
                          "--home", home, "start"], cwd=str(ROOT),
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "NoDeviceError" in res.stderr
    s = socket.socket()
    s.bind(("127.0.0.1", rpc))  # nothing was bound there
    s.close()
    assert not Path(home, "data", "blockstore.db").exists()
    for argv in (["light", "c", "--primary", "127.0.0.1:1",
                  "--trust-height", "1", "--trust-hash", "00"],
                 ["replay"], ["signer", "--connect", "tcp://127.0.0.1:1"]):
        res = subprocess.run(
            [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home",
             home, *argv], cwd=str(ROOT), env=_env(CUDA_VISIBLE_DEVICES=""),
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 1 and "NoDeviceError" in res.stderr, argv


def test_misbehavior_is_refused_without_the_variable(tmp_path):
    got = {}
    for k in CMDS:
        home, _ = _single_node_home(str(tmp_path / k), k)
        argv = ["--home", home, "start", "--misbehavior",
                "double-prevote@3"]
        if k == "port":
            argv += ["--device", "cpu"]
        proc = _spawn(k, argv)
        try:
            rc = proc.wait(120)
        finally:
            out = _stop(proc)
        got[k] = (rc, out.strip().splitlines()[-1])
    assert got["port"] == got["reference"]
    assert got["port"][0] == 1 and "TM_TPU_ENABLE_MAVERICK=1" in \
        got["port"][1]


def test_the_parsers_take_the_reference_arguments():
    """Every reference subcommand parses the same argument lists in the
    port (which adds --device where the reference reads JAX's
    variable)."""
    cases = [
        ["init", "--chain-id", "x"],
        ["start", "--proxy_app", "kvstore", "--p2p.laddr", "tcp://a:1",
         "--rpc.laddr", "tcp://a:2", "--p2p.persistent_peers", "id@a:3",
         "--fast_sync", "false", "--log_level", "debug", "--misbehavior",
         "double-prevote@5"],
        ["testnet", "--v", "2", "--o", "out", "--chain-id", "c",
         "--starting-port", "1000"],
        ["light", "c", "--primary", "h:1", "--witnesses", "h:2,h:3",
         "--trust-height", "1", "--trust-hash", "ab", "--trust-period", "9",
         "--store", "s", "--interval", "0.5", "--once", "--laddr", "h:4"],
        ["replay"], ["replay-console"], ["unsafe-reset-all",
                                         "--keep-addr-book"],
        ["unsafe-reset-priv-validator"],
        ["signer", "--connect", "tcp://h:5", "--chain-id", "c"],
        ["debug", "kill", "12", "out.tgz", "--rpc-laddr", "h:1",
         "--pprof-laddr", "h:2"],
        ["debug", "dump", "dir", "--interval", "2", "--count", "1",
         "--profile-seconds", "0.5"],
        ["debug", "trace", "t.json", "--seconds", "3"],
        ["probe-upnp", "--timeout", "1"], ["gen-validator"],
        ["show-validator"], ["gen-node-key"], ["show-node-id"], ["version"],
    ]
    for argv in cases:
        for home in (["--home", "H"], []):
            a = home + argv
            pa = vars(pcmd.build_parser().parse_args(a))
            ja = vars(jcmd.build_parser().parse_args(a))
            assert pa.pop("fn").__name__ == ja.pop("fn").__name__
            assert pa.pop("device", "cuda") == "cuda"
            assert pa == ja, a
    sub = [a for a in pcmd.build_parser()._actions
           if a.dest == "command"][0]
    assert set(sub.choices) == {a[0] for a in cases}
    assert {n for n in sub.choices
            if "--device" in sub.choices[n].format_usage()} == \
        {"start", "replay", "light", "signer"}
