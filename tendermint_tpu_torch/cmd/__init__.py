"""Command-line interface (reference: tendermint_tpu/cmd/__init__.py;
Go cmd/tendermint/main.go:15-45).

    python -m tendermint_tpu_torch.cmd --home H init
    python -m tendermint_tpu_torch.cmd --home H start [--device cpu]

Subcommands: init, start, testnet, light, replay, replay-console,
unsafe-reset-all, unsafe-reset-priv-validator, signer, debug
kill|dump|trace, gen-validator, show-validator, gen-node-key,
show-node-id, probe-upnp, version: the reference's arguments and printed
lines. Homes are the reference's files, byte for byte, so a home either
package writes starts with the other.

`start`, `replay`, `light` and `signer` run on the card unless the
caller asks for the CPU with `--device cpu` (device.set_default_device,
called before anything is built). Without a GPU and without the flag
they exit non-zero with NoDeviceError's message before binding a port:
nothing carries on on the CPU unasked. The reference reads
JAX_PLATFORMS instead; the port reads no JAX variable."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import shutil
import sys
import time

VERSION = "tendermint-tpu/0.1.0"


def _load_config(home: str):
    from ..config import Config

    path = os.path.join(home, "config", "config.toml")
    if os.path.exists(path):
        cfg = Config.load(path)
        # Reject typo'd values loudly (e.g. tx_index.indexer =
        # "nulll" silently meaning "kv") instead of running with a
        # config the operator didn't ask for — reference
        # config.ValidateBasic on the CLI load path. Clean one-line
        # CLI error, not a traceback.
        try:
            cfg.validate_basic()
        except ValueError as e:
            raise SystemExit(f"invalid config {path}: {e}")
    else:
        cfg = Config()
    cfg.base.home = home
    return cfg


def cmd_init(args) -> int:
    """Go reference: cmd/tendermint/commands/init.go."""
    from ..config import Config
    from ..p2p.key import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    home = args.home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    cfg = Config()
    cfg.base.home = home

    key_file = cfg.base.resolve(cfg.base.priv_validator_key_file)
    state_file = cfg.base.resolve(cfg.base.priv_validator_state_file)
    if os.path.exists(key_file):
        pv = FilePV.load(key_file, state_file)
        print(f"Found private validator: {key_file}")
    else:
        pv = FilePV.generate(key_file, state_file)
        print(f"Generated private validator: {key_file}")

    nk_file = cfg.base.resolve(cfg.base.node_key_file)
    NodeKey.load_or_gen(nk_file)
    print(f"Node key: {nk_file}")

    gen_file = cfg.base.resolve(cfg.base.genesis_file)
    if not os.path.exists(gen_file):
        gdoc = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{os.urandom(3).hex()}",
            genesis_time=time.time_ns(),
            validators=[GenesisValidator(pv.get_pub_key(), 10)],
        )
        gdoc.validate_and_complete()
        gdoc.save(gen_file)
        print(f"Generated genesis file: {gen_file}")
    else:
        print(f"Found genesis file: {gen_file}")

    cfg_file = os.path.join(home, "config", "config.toml")
    if not os.path.exists(cfg_file):
        cfg.save(cfg_file)
        print(f"Generated config: {cfg_file}")
    return 0


def _select_device(args) -> int:
    """Pin the port's device from `--device` before anything is built:
    "cpu" runs every kernel wrapper's plain version; "cuda" (the
    default) needs a card, else NoDeviceError's message and 1."""
    from .. import device

    if args.device == "cpu":
        device.set_default_device("cpu")
        return 0
    device.set_default_device(None)
    try:
        device.default_device()
    except device.NoDeviceError as e:
        print(f"{type(e).__name__}: {e} (or pass --device cpu)",
              file=sys.stderr, flush=True)
        return 1
    return 0


def cmd_start(args) -> int:
    """Go reference: cmd/tendermint/commands/run_node.go:100."""
    if _select_device(args):
        return 1
    from ..node import Node

    logging.basicConfig(
        level=logging.DEBUG if args.log_level == "debug" else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    cfg = _load_config(args.home)
    if args.proxy_app:
        cfg.base.proxy_app = args.proxy_app
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.persistent_peers:
        cfg.p2p.persistent_peers = args.persistent_peers
    if args.fast_sync is not None:
        cfg.base.fast_sync = args.fast_sync == "true"

    async def run():
        node = Node.default_new_node(cfg)
        # Maverick mode (Go reference: test/maverick — a SEPARATE node
        # binary with pluggable misbehaviors): --misbehavior
        # double-prevote@H. Equivocation bypasses the PrivValidator
        # double-sign guard and gets a production validator slashed,
        # so the flag is inert unless TM_TPU_ENABLE_MAVERICK=1 marks
        # the process as a test node.
        if args.misbehavior:
            if os.environ.get("TM_TPU_ENABLE_MAVERICK") != "1":
                raise SystemExit(
                    "--misbehavior deliberately equivocates (slashable);"
                    " refusing without TM_TPU_ENABLE_MAVERICK=1")
            logging.getLogger("node").warning(
                "MAVERICK MODE: this node will misbehave: %s",
                args.misbehavior)
            from ..consensus.misbehavior import MISBEHAVIORS

            for spec in args.misbehavior.split(","):
                name, _, h = spec.partition("@")
                node.misbehaviors[int(h)] = MISBEHAVIORS[name]()
        await node.start()
        logging.getLogger("node").info(
            "node %s started: p2p %s rpc port %s",
            cfg.base.moniker, node.p2p_addr,
            getattr(node, "rpc_port", "off"))
        stop = asyncio.Event()
        import signal

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # pragma: no cover
                pass
        await stop.wait()
        await node.stop()

    asyncio.run(run())
    return 0


def cmd_testnet(args) -> int:
    """Generate N validator home dirs wired as a full mesh
    (Go reference: cmd/tendermint/commands/testnet.go)."""
    from ..config import Config
    from ..p2p.key import NodeKey
    from ..privval import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    n = args.v
    out = args.o
    pvs, node_keys, cfgs = [], [], []
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        cfg = Config()
        cfg.base.home = home
        cfg.base.moniker = f"node{i}"
        pv = FilePV.generate(
            cfg.base.resolve(cfg.base.priv_validator_key_file),
            cfg.base.resolve(cfg.base.priv_validator_state_file))
        nk = NodeKey.load_or_gen(cfg.base.resolve(cfg.base.node_key_file))
        pvs.append(pv)
        node_keys.append(nk)
        cfgs.append(cfg)

    gdoc = GenesisDoc(
        chain_id=args.chain_id or f"testnet-{os.urandom(3).hex()}",
        genesis_time=time.time_ns(),
        validators=[GenesisValidator(pv.get_pub_key(), 10) for pv in pvs],
    )
    gdoc.validate_and_complete()

    base_p2p = args.starting_port
    base_rpc = args.starting_port + 1000
    for i, cfg in enumerate(cfgs):
        gdoc.save(cfg.base.resolve(cfg.base.genesis_file))
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_p2p + i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_rpc + i}"
        cfg.p2p.persistent_peers = ",".join(
            f"{node_keys[j].id}@127.0.0.1:{base_p2p + j}"
            for j in range(n) if j != i)
        cfg.save(os.path.join(cfg.base.home, "config", "config.toml"))
    print(f"Successfully initialized {n} node directories in {out}")
    return 0


def cmd_light(args) -> int:
    """Light client daemon: follow a chain through an RPC primary,
    verifying every header (Go reference: cmd/tendermint/commands/
    light.go + light/proxy)."""
    if _select_device(args):
        return 1
    from ..libs.db import FileDB, MemDB
    from ..light import Client, LightStore, TrustOptions
    from ..light.provider import RPCProvider

    host, _, port = args.primary.rpartition(":")
    primary = RPCProvider(host or "127.0.0.1", int(port))
    witnesses = []
    for w in (args.witnesses or "").split(","):
        if w:
            wh, _, wp = w.rpartition(":")
            witnesses.append(RPCProvider(wh or "127.0.0.1", int(wp)))
    store = LightStore(FileDB(args.store) if args.store else MemDB())

    async def run():
        cl = Client(
            args.chain_id,
            TrustOptions(period_ns=args.trust_period * 10**9,
                         height=args.trust_height,
                         hash=bytes.fromhex(args.trust_hash)),
            primary, witnesses, store)
        lb = await cl.initialize()
        print(f"trusted root at height {lb.height()}: "
              f"{lb.hash().hex()[:16]}…")
        proxy = None
        if args.laddr:
            from ..light.proxy import LightProxy
            from ..rpc.jsonrpc import HTTPClient

            lh, _, lp = args.laddr.rpartition(":")
            proxy = LightProxy(
                cl, forward_client=HTTPClient(host or "127.0.0.1",
                                              int(port)))
            p = await proxy.listen(lh or "127.0.0.1", int(lp))
            print(f"light proxy: verified RPC on {lh or '127.0.0.1'}:{p}")
        try:
            while True:
                new = await cl.update()
                if new is not None:
                    print(f"verified height {new.height()}: "
                          f"{new.hash().hex()[:16]}…")
                if args.once:
                    return
                await asyncio.sleep(args.interval)
        finally:
            if proxy is not None:
                proxy.close()

    asyncio.run(run())
    return 0


def cmd_replay(args) -> int:
    """Replay the consensus WAL through the app (Go reference:
    cmd/tendermint/commands/replay.go → consensus.RunReplayFile)."""
    if _select_device(args):
        return 1
    from ..node import Node

    cfg = _load_config(args.home)

    async def run():
        node = Node.default_new_node(cfg)
        await node._build()
        # handshake already replayed blocks into the app; starting
        # consensus replays the WAL tail for the current height
        await node.consensus_state.start()
        h = node.consensus_state.rs.height
        print(f"replay complete; consensus at height {h}")
        # stop what _build and the replay started; the node itself never
        # started (the reference's node.stop() raises NotStarted here)
        await node.consensus_state.stop()
        await node.proxy_app.stop()

    asyncio.run(run())
    return 0


def cmd_replay_console(args) -> int:
    """Interactive WAL replay (Go reference: replay.go ReplayConsoleCmd →
    RunReplayFile(console=true)): step through the consensus WAL
    message by message — Enter advances one message, a number advances
    that many, 'q' quits. Read-only: decodes the WAL without mutating
    any store, so it is safe on a live node's data directory copy."""
    from ..consensus import wal as walmod

    cfg = _load_config(args.home)
    wal_path = cfg.base.resolve(cfg.consensus.wal_file)
    if not os.path.exists(wal_path):
        print(f"no WAL at {wal_path}")
        return 1
    # Strictly read-only (works on a read-only mount) and streamed one
    # segment at a time — a full WAL group is up to 1 GiB on disk, far
    # more as decoded Python objects.
    segs = [p for p in walmod.segment_paths(wal_path) if os.path.exists(p)]
    print(f"WAL group: {len(segs)} segment(s) at {wal_path}")
    i = 0
    step = 0
    for seg in segs:
        for tm in walmod.WAL.decode_iter(seg):
            if step <= 0:
                try:
                    line = input(f"[{i}] Enter=next, N=skip N, "
                                 "q=quit > ").strip()
                except EOFError:
                    line = "q"
                if line == "q":
                    return 0
                step = int(line) if line.isdigit() else 1
            step -= 1
            print(f"  #{i} t={tm.time_ns} "
                  f"{type(tm.msg).__name__}: {tm.msg}")
            i += 1
    print(f"end of WAL ({i} messages)")
    return 0


def cmd_unsafe_reset_all(args) -> int:
    """Go reference: cmd/tendermint/commands/reset_priv_validator.go
    ResetAll — remove data + WAL (+ addrbook unless --keep-addr-book),
    reset the validator's last-sign state."""
    cfg = _load_config(args.home)
    data = cfg.base.resolve(cfg.base.db_dir)
    if os.path.isdir(data):
        shutil.rmtree(data)
        os.makedirs(data)
        print(f"Removed all data in {data}")
    book = cfg.base.resolve("config/addrbook.json")
    if getattr(args, "keep_addr_book", False):
        print("The address book remains intact")
    elif os.path.exists(book):
        os.remove(book)
        print(f"Removed existing address book {book}")
    state_file = cfg.base.resolve(cfg.base.priv_validator_state_file)
    if os.path.exists(state_file):
        os.remove(state_file)
    print("Reset private validator state")
    return 0


def cmd_unsafe_reset_priv_validator(args) -> int:
    """Go reference: reset_priv_validator.go ResetPrivValidatorCmd —
    reset ONLY this node's validator to genesis state: regenerate the
    key file if missing and wipe the last-sign state (the double-sign
    guard's HRS record). Data/WAL/addrbook stay intact."""
    from ..privval import FilePV

    cfg = _load_config(args.home)
    key_file = cfg.base.resolve(cfg.base.priv_validator_key_file)
    state_file = cfg.base.resolve(cfg.base.priv_validator_state_file)
    if os.path.exists(state_file):
        os.remove(state_file)
        print(f"Reset private validator state {state_file}")
    if os.path.exists(key_file):
        print(f"Private validator key intact at {key_file}")
    else:
        FilePV.generate(key_file, state_file)
        print(f"Generated private validator key {key_file}")
    return 0


def cmd_signer(args) -> int:
    """Remote-signer sidecar (the tmkms role; Go reference privval/
    signer_server.go + SignerDialerEndpoint): load this home's file
    key and DIAL the validator node's priv_validator_laddr, answering
    sign requests. Reconnects forever — the signer outliving node
    restarts is the point of running it out of process."""
    if _select_device(args):
        return 1
    import asyncio as _asyncio

    from ..libs.net import split_laddr
    from ..p2p.key import NodeKey
    from ..privval import FilePV
    from ..privval.signer import SignerServer
    from ..types.genesis import GenesisDoc

    cfg = _load_config(args.home)
    pv = FilePV.load_or_generate(
        cfg.base.resolve(cfg.base.priv_validator_key_file),
        cfg.base.resolve(cfg.base.priv_validator_state_file))
    chain_id = args.chain_id
    if not chain_id:
        chain_id = GenesisDoc.load(
            cfg.base.resolve(cfg.base.genesis_file)).chain_id
    host, port = split_laddr(args.connect, default_host="127.0.0.1")
    # SecretConnection identity for the link (matches the node side,
    # which keys the handshake on ITS node key): never plaintext TCP.
    conn_key = NodeKey.load_or_gen(
        cfg.base.resolve(cfg.base.node_key_file)).priv_key
    server = SignerServer(pv, chain_id, conn_key=conn_key)
    print(f"signer for validator "
          f"{pv.get_pub_key().address().hex()[:12]}… dialing "
          f"{host}:{port}", flush=True)
    # operators copy this into the node's priv_validator_signer_id to
    # pin the link (required when the laddr is not loopback-only)
    print(f"signer link id: "
          f"{conn_key.pub_key().address().hex()}", flush=True)
    try:
        _asyncio.run(server.dial_and_serve(
            host, port, retries=None, retry_delay=1.0,
            on_event=lambda msg: print(msg, flush=True)))
    except KeyboardInterrupt:
        pass
    return 0


def cmd_gen_validator(args) -> int:
    from ..privval import FilePV

    pv = FilePV.generate()
    print(json.dumps({
        "priv_key": pv.priv_key.bytes().hex(),
        "pub_key": pv.get_pub_key().bytes().hex(),
        "address": pv.get_pub_key().address().hex().upper(),
    }, indent=2))
    return 0


def cmd_show_validator(args) -> int:
    cfg = _load_config(args.home)
    from ..privval import FilePV

    pv = FilePV.load(cfg.base.resolve(cfg.base.priv_validator_key_file),
                     cfg.base.resolve(cfg.base.priv_validator_state_file))
    print(json.dumps({"type": "ed25519",
                      "value": pv.get_pub_key().bytes().hex()}))
    return 0


def cmd_gen_node_key(args) -> int:
    from ..p2p.key import NodeKey

    cfg = _load_config(args.home)
    path = cfg.base.resolve(cfg.base.node_key_file)
    if os.path.exists(path):
        print(f"node key already exists at {path}", file=sys.stderr)
        return 1
    nk = NodeKey.generate()
    nk.save(path)
    print(nk.id)
    return 0


def cmd_show_node_id(args) -> int:
    from ..p2p.key import NodeKey

    cfg = _load_config(args.home)
    nk = NodeKey.load(cfg.base.resolve(cfg.base.node_key_file))
    print(nk.id)
    return 0


def cmd_probe_upnp(args) -> int:
    """Go reference: cmd/tendermint/commands/probe_upnp.go."""
    from ..p2p.upnp import UPnPError, discover

    async def go() -> int:
        try:
            igd = await discover(timeout=args.timeout)
        except UPnPError as e:
            print(json.dumps({"success": False, "error": str(e)}))
            return 1
        out = {"success": True, "control_url": igd.control_url,
               "local_ip": igd.local_ip}
        try:
            out["external_ip"] = igd.external_ip()
        except UPnPError as e:
            out["external_ip_error"] = str(e)
        print(json.dumps(out))
        return 0

    return asyncio.run(go())


def cmd_version(args) -> int:
    print(VERSION)
    return 0


def _device_flag(sp) -> None:
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the kernels on the card (default) or their "
                         "plain versions on the CPU")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tendermint-tpu",
                                description=__doc__)
    p.add_argument("--home", default=os.path.expanduser("~/.tendermint_tpu"))
    _sub = p.add_subparsers(dest="command")

    # --home works in BOTH positions (`--home H start` and
    # `start --home H`), like cobra persistent flags: every subparser
    # inherits it via a parent with SUPPRESS so an omitted
    # subcommand-level flag never clobbers the top-level value.
    _home_parent = argparse.ArgumentParser(add_help=False)
    _home_parent.add_argument("--home", default=argparse.SUPPRESS)

    class _Sub:
        def add_parser(self, name, **kw):
            # fresh list: never mutate a caller-shared parents list
            kw["parents"] = [*kw.get("parents", []), _home_parent]
            return _sub.add_parser(name, **kw)

    sub = _Sub()

    sp = sub.add_parser("init", help="initialize a home directory")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run a node")
    sp.add_argument("--proxy_app", default="")
    sp.add_argument("--p2p.laddr", dest="p2p_laddr", default="")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="")
    sp.add_argument("--p2p.persistent_peers", dest="persistent_peers",
                    default="")
    sp.add_argument("--fast_sync", choices=("true", "false"), default=None)
    sp.add_argument("--log_level", default="info")
    sp.add_argument("--misbehavior", default="",
                    help="maverick mode: NAME@HEIGHT[,NAME@HEIGHT...] "
                         "(e.g. double-prevote@3)")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("testnet", help="generate a local testnet")
    sp.add_argument("--v", type=int, default=4)
    sp.add_argument("--o", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("light", help="run a verifying light client")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="host:rpc-port")
    sp.add_argument("--witnesses", default="")
    sp.add_argument("--trust-height", type=int, required=True)
    sp.add_argument("--trust-hash", required=True)
    sp.add_argument("--trust-period", type=int, default=168 * 3600)
    sp.add_argument("--store", default="")
    sp.add_argument("--interval", type=float, default=1.0)
    sp.add_argument("--once", action="store_true")
    sp.add_argument("--laddr", default="",
                    help="host:port to serve verified RPC (light proxy)")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser("replay", help="replay the consensus WAL")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("replay-console",
                        help="step through the consensus WAL "
                             "interactively (read-only)")
    sp.set_defaults(fn=cmd_replay_console)

    sp = sub.add_parser("unsafe-reset-all",
                        help="wipe data and addrbook, keep keys "
                             "and config")
    sp.add_argument("--keep-addr-book", action="store_true",
                    help="keep the address book intact")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("unsafe-reset-priv-validator",
                        help="reset only this node's validator to "
                             "genesis state (wipes last-sign state)")
    sp.set_defaults(fn=cmd_unsafe_reset_priv_validator)

    sp = sub.add_parser("signer",
                        help="remote-signer sidecar: dial a "
                             "validator's priv_validator_laddr and "
                             "answer sign requests with this home's "
                             "file key")
    sp.add_argument("--connect", required=True,
                    help="validator's priv_validator_laddr, e.g. "
                         "tcp://127.0.0.1:26659")
    sp.add_argument("--chain-id", default="",
                    help="chain id (default: from this home's genesis)")
    _device_flag(sp)
    sp.set_defaults(fn=cmd_signer)

    from .debug import register as register_debug

    register_debug(sub)

    sp = sub.add_parser("probe-upnp",
                        help="probe for a UPnP internet gateway")
    sp.add_argument("--timeout", type=float, default=3.0)
    sp.set_defaults(fn=cmd_probe_upnp)

    sub.add_parser("gen-validator").set_defaults(fn=cmd_gen_validator)
    sub.add_parser("show-validator").set_defaults(fn=cmd_show_validator)
    sub.add_parser("gen-node-key").set_defaults(fn=cmd_gen_node_key)
    sub.add_parser("show-node-id").set_defaults(fn=cmd_show_node_id)
    sub.add_parser("version").set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)
