"""abci-cli — a console for ABCI apps (reference: tendermint_tpu/abci/cli.py;
Go abci/cmd/abci-cli).

Run an example app as a server:
    python -m tendermint_tpu_torch.abci.cli kvstore --address tcp://127.0.0.1:26658
Drive any ABCI server interactively or from a script:
    python -m tendermint_tpu_torch.abci.cli console --address ...
    python -m tendermint_tpu_torch.abci.cli batch < script.abci
    python -m tendermint_tpu_torch.abci.cli echo hello / info / deliver_tx "abc" / ...

Output format mirrors the Go reference's printResponse (abci/cmd/
abci-cli/abci-cli.go): `-> code: OK`, `-> data: ...`, `-> data.hex:
0x...`, query extras — so golden files diff the same way its
abci/tests/test_cli goldens do.

The transport is the socket one (abci/server.py, abci/client.py).
`--abci grpc` is refused with NotImplementedError: the gRPC transport
is not ported (ROADMAP Queue A, gRPC), as the node refuses
`base.abci = "grpc"`.
"""

from __future__ import annotations

import argparse
import asyncio
import shlex
import sys

from . import types as t
from .client import Client, SocketClient
from .server import SocketServer


def _parse_bytes(arg: str) -> bytes:
    """Reference semantics: quoted strings are raw; 0x... is hex."""
    if arg.startswith("0x"):
        return bytes.fromhex(arg[2:])
    if len(arg) >= 2 and arg[0] == '"' and arg[-1] == '"':
        arg = arg[1:-1]
    return arg.encode()


def _printable(b: bytes) -> bool:
    return all(0x20 <= c < 0x7F for c in b)


def _print_response(res, out=sys.stdout) -> None:
    code = getattr(res, "code", 0)
    out.write(f"-> code: {'OK' if code == 0 else code}\n")
    if isinstance(res, t.ResponseEcho):
        data = res.message.encode()
    else:
        data = getattr(res, "data", b"")
        if isinstance(data, str):
            data = data.encode()
    log = getattr(res, "log", "")
    if data:
        if _printable(data):
            out.write(f"-> data: {data.decode()}\n")
        out.write(f"-> data.hex: 0x{data.hex().upper()}\n")
    if log:
        out.write(f"-> log: {log}\n")
    if isinstance(res, t.ResponseQuery):
        out.write(f"-> height: {res.height}\n")
        if res.key:
            if _printable(res.key):
                out.write(f"-> key: {res.key.decode()}\n")
            out.write(f"-> key.hex: {res.key.hex().upper()}\n")
        if res.value:
            if _printable(res.value):
                out.write(f"-> value: {res.value.decode()}\n")
            out.write(f"-> value.hex: {res.value.hex().upper()}\n")


async def _exec_line(client: Client, line: str, out=sys.stdout) -> bool:
    """Run one command line; returns False on unknown command."""
    parts = shlex.split(line, posix=False)
    if not parts:
        return True
    cmd, args = parts[0], parts[1:]
    if cmd == "echo":
        res = await client.echo(args[0] if args else "")
    elif cmd == "info":
        res = await client.info(t.RequestInfo(version="abci-cli"))
    elif cmd == "deliver_tx":
        res = await client.deliver_tx(
            t.RequestDeliverTx(_parse_bytes(args[0] if args else "")))
    elif cmd == "check_tx":
        res = await client.check_tx(
            t.RequestCheckTx(_parse_bytes(args[0] if args else "")))
    elif cmd == "commit":
        res = await client.commit()
    elif cmd == "query":
        res = await client.query(
            t.RequestQuery(data=_parse_bytes(args[0] if args else "")))
    else:
        out.write(f"-> error: unknown command {cmd!r}\n")
        return False
    _print_response(res, out)
    return True


def _addr(s: str) -> tuple[str, int]:
    from ..libs.net import split_laddr

    return split_laddr(s, default_host="127.0.0.1")


def _refuse_grpc(args) -> None:
    if args.abci == "grpc":
        raise NotImplementedError(
            "abci-cli --abci grpc: the gRPC ABCI transport is not "
            "ported (ROADMAP Queue A, gRPC)")


def _new_client(args) -> Client:
    _refuse_grpc(args)
    host, port = _addr(args.address)
    return SocketClient(host, port)


async def _run_lines(args, lines, echo_input: bool) -> int:
    client = _new_client(args)
    await client.start()
    ok = True
    try:
        first = True
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if echo_input:
                if not first:
                    sys.stdout.write("\n")
                sys.stdout.write(f"> {line}\n")
            first = False
            ok = await _exec_line(client, line) and ok
        # nonzero on any unknown command, like the reference abci-cli
        return 0 if ok else 1
    finally:
        await client.stop()


async def _console(args) -> int:
    client = _new_client(args)
    await client.start()
    try:
        loop = asyncio.get_running_loop()
        while True:
            sys.stdout.write("> ")
            sys.stdout.flush()
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line:
                return 0
            await _exec_line(client, line.strip())
    finally:
        await client.stop()


async def _serve(args, app) -> int:
    _refuse_grpc(args)
    host, port = _addr(args.address)
    server = SocketServer(app, host, port)
    await server.start()
    print(f"serving {type(app).__name__} abci={args.abci} "
          f"on {host}:{server.port}", flush=True)
    stop = asyncio.Event()
    import signal

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    await stop.wait()
    await server.stop()
    return 0


def main(argv=None) -> int:
    # Flags accepted both before and after the subcommand. SUPPRESS
    # keeps a subparser from clobbering a value parsed at the top
    # level; real defaults are set once via set_defaults below.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--address", default=argparse.SUPPRESS)
    common.add_argument("--abci", choices=("socket", "grpc"),
                        default=argparse.SUPPRESS)
    p = argparse.ArgumentParser(prog="abci-cli", description=__doc__,
                                parents=[common])
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("echo", "info", "deliver_tx", "check_tx", "commit",
                 "query"):
        sp = sub.add_parser(name, parents=[common])
        sp.add_argument("arg", nargs="?", default="")
    sub.add_parser("batch", parents=[common],
                   help="read commands from stdin")
    sub.add_parser("console", parents=[common],
                   help="interactive prompt")
    sub.add_parser("kvstore", parents=[common],
                   help="serve the in-memory kvstore app")
    sub.add_parser("counter", parents=[common],
                   help="serve the counter app")
    args = p.parse_args(argv)
    # Defaults applied AFTER parsing: with parents, the action objects
    # are shared between the top parser and every subparser, so a
    # parser-level default would let the subparser clobber a value
    # given before the subcommand.
    if not hasattr(args, "address"):
        args.address = "tcp://127.0.0.1:26658"
    if not hasattr(args, "abci"):
        args.abci = "socket"

    if args.command == "batch":
        return asyncio.run(
            _run_lines(args, sys.stdin.readlines(), echo_input=True))
    if args.command == "console":
        return asyncio.run(_console(args))
    if args.command == "kvstore":
        from .kvstore import KVStoreApp

        return asyncio.run(_serve(args, KVStoreApp()))
    if args.command == "counter":
        from .counter import CounterApp

        return asyncio.run(_serve(args, CounterApp()))
    line = args.command
    if args.arg:
        line += " " + args.arg
    return asyncio.run(_run_lines(args, [line], echo_input=False))


if __name__ == "__main__":
    sys.exit(main())
