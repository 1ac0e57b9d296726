"""`tendermint-tpu debug kill|dump` — diagnostics bundles from a
running node (reference: tendermint_tpu/cmd/debug.py; Go
cmd/tendermint/commands/debug/kill.go, dump.go, util.go). The node is
read over its RPC and its debug server (libs/debugsrv.py), so a bundle
from a port node holds its launch ledger's records in metrics.txt.

Both commands aggregate, into a .tar.gz archive:

  status.json           RPC `status`
  net_info.json         RPC `net_info`
  consensus_state.json  RPC `dump_consensus_state`
  goroutine.txt         debug server /debug/pprof/goroutine
                        (asyncio-task + thread stacks)
  heap.txt              debug server /debug/pprof/heap
  trace.json            debug server /debug/trace (span timeline,
                        Chrome trace-event JSON for Perfetto)
  trace_rollup.json     per-span-kind p50/p95/p99 rollup
  metrics.txt           debug server /metrics (Prometheus exposition)
  node_health.json      debug server /status (liveness verdict)
  config.toml           the node's config file
  cs.wal/               copy of the consensus WAL directory

`kill` additionally SIGABRTs the process afterwards (the reference
sends SIGABRT to force a Go runtime dump; here it still produces a
core-style termination and a crash log). `dump` polls, producing one
timestamped bundle per interval, optionally including a CPU profile
from /debug/pprof/profile.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tarfile
import tempfile
import time
import urllib.error
import urllib.request


def _rpc_call(rpc_addr: str, method: str) -> dict:
    req = urllib.request.Request(
        f"http://{rpc_addr}/",
        data=json.dumps({
            "jsonrpc": "2.0", "method": method, "params": {}, "id": 1,
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        body = json.loads(resp.read())
    if "error" in body and body["error"]:
        raise RuntimeError(f"{method}: {body['error']}")
    return body.get("result", {})


def _pprof_get(pprof_addr: str, path: str,
               timeout: float = 30.0) -> bytes:
    with urllib.request.urlopen(
            f"http://{pprof_addr}{path}", timeout=timeout) as resp:
        return resp.read()


def _collect(tmp: str, rpc_addr: str, pprof_addr: str, home: str,
             profile_seconds: float = 0.0) -> list[str]:
    """Gather every artifact into `tmp`; returns notes about pieces
    that could not be collected (best-effort, like the reference)."""
    notes = []
    for method, fname in (
        ("status", "status.json"),
        ("net_info", "net_info.json"),
        ("dump_consensus_state", "consensus_state.json"),
    ):
        try:
            result = _rpc_call(rpc_addr, method)
            with open(os.path.join(tmp, fname), "w") as f:
                json.dump(result, f, indent=2, default=str)
        except Exception as e:
            notes.append(f"{fname}: {e!r}")

    for path, fname in (
        ("/debug/pprof/goroutine", "goroutine.txt"),
        ("/debug/pprof/heap", "heap.txt"),
        ("/debug/trace", "trace.json"),
        ("/debug/trace/rollup", "trace_rollup.json"),
        ("/metrics", "metrics.txt"),
        ("/status", "node_health.json"),
    ):
        try:
            data = _pprof_get(pprof_addr, path)
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(data)
        except Exception as e:
            notes.append(f"{fname}: {e!r}")
    if profile_seconds > 0:
        try:
            data = _pprof_get(
                pprof_addr,
                f"/debug/pprof/profile?seconds={profile_seconds}",
                timeout=profile_seconds + 30.0)
            with open(os.path.join(tmp, "profile.txt"), "wb") as f:
                f.write(data)
        except Exception as e:
            notes.append(f"profile.txt: {e!r}")

    # Filesystem copies stay best-effort too: the node is live, so the
    # WAL directory can rotate/truncate mid-copy.
    try:
        cfg_file = os.path.join(home, "config", "config.toml")
        if os.path.exists(cfg_file):
            shutil.copy(cfg_file, os.path.join(tmp, "config.toml"))
        else:
            notes.append(f"config.toml: not found at {cfg_file}")
    except OSError as e:
        notes.append(f"config.toml: {e!r}")
    try:
        wal_dir = os.path.join(home, "data", "cs.wal")
        if os.path.isdir(wal_dir):
            shutil.copytree(wal_dir, os.path.join(tmp, "cs.wal"))
        else:
            notes.append(f"cs.wal: not found at {wal_dir}")
    except OSError as e:
        notes.append(f"cs.wal: {e!r}")

    if notes:
        with open(os.path.join(tmp, "INCOMPLETE.txt"), "w") as f:
            f.write("\n".join(notes) + "\n")
    return notes


def _bundle(tmp: str, out_file: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with tarfile.open(out_file, "w:gz") as tar:
        for name in sorted(os.listdir(tmp)):
            tar.add(os.path.join(tmp, name), arcname=name)


def cmd_debug_kill(args) -> int:
    """Go reference: cmd/tendermint/commands/debug/kill.go."""
    pid = args.pid
    with tempfile.TemporaryDirectory(prefix="tm_debug_") as tmp:
        notes = _collect(tmp, args.rpc_laddr, args.pprof_laddr, args.home)
        _bundle(tmp, args.output_file)
    for n in notes:
        print(f"warning: {n}")
    print(f"wrote debug bundle: {args.output_file}")
    try:
        os.kill(pid, signal.SIGABRT)
        print(f"sent SIGABRT to pid {pid}")
    except ProcessLookupError:
        print(f"warning: no such process {pid}")
        return 1
    return 0


def cmd_debug_trace(args) -> int:
    """Capture the node's span-tracer ring as a Perfetto-loadable
    Chrome trace-event JSON file (plus the per-stage rollup on
    stdout). The lightweight sibling of kill/dump for the question
    'where did the last N seconds actually go'."""
    try:
        raw = _pprof_get(
            args.pprof_laddr,
            f"/debug/trace?seconds={args.seconds}"
            if args.seconds else "/debug/trace")
        trace = json.loads(raw)
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("response is not Chrome trace-event JSON")
    except Exception as e:
        print(f"error: trace capture failed: {e!r}")
        return 1
    try:
        out_dir = os.path.dirname(os.path.abspath(args.output_file))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.output_file, "wb") as f:
            f.write(raw)
    except OSError as e:
        print(f"error: cannot write {args.output_file}: {e!r}")
        return 1
    print(f"wrote {len(events)} spans: {args.output_file} "
          "(open in https://ui.perfetto.dev or chrome://tracing)")
    try:
        rollup = json.loads(_pprof_get(
            args.pprof_laddr,
            f"/debug/trace/rollup?seconds={args.seconds}"
            if args.seconds else "/debug/trace/rollup"))
        for kind, row in rollup.get("stages", {}).items():
            print(f"  {kind:<24} n={row['count']:<6} "
                  f"p50={row['p50_ms']}ms p95={row['p95_ms']}ms "
                  f"p99={row['p99_ms']}ms")
        dropped = rollup.get("spans_dropped", 0)
        if dropped:
            print(f"  WARNING: {dropped} spans evicted from the ring "
                  f"(capacity {rollup.get('capacity')}) — the timeline "
                  "above is a suffix, not the whole story")
    except Exception as e:
        print(f"warning: rollup unavailable: {e!r}")
    return 0


def cmd_debug_dump(args) -> int:
    """Go reference: cmd/tendermint/commands/debug/dump.go — poll forever
    (or --count times), one timestamped bundle per interval."""
    os.makedirs(args.output_dir, exist_ok=True)
    remaining = args.count
    while True:
        start = time.time()
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime())
        out_file = os.path.join(args.output_dir, f"{stamp}.tar.gz")
        with tempfile.TemporaryDirectory(prefix="tm_debug_") as tmp:
            notes = _collect(tmp, args.rpc_laddr, args.pprof_laddr,
                             args.home,
                             profile_seconds=args.profile_seconds)
            _bundle(tmp, out_file)
        for n in notes:
            print(f"warning: {n}")
        print(f"wrote debug bundle: {out_file}")
        if remaining is not None:
            remaining -= 1
            if remaining <= 0:
                return 0
        delay = args.interval - (time.time() - start)
        if delay > 0:
            time.sleep(delay)


def register(sub) -> None:
    """Attach the `debug` command group to the CLI parser."""
    import argparse

    sp = sub.add_parser("debug", help="debug a running node")
    dsub = sp.add_subparsers(dest="debug_command", required=True)
    # --home: SUPPRESS so these subparsers don't clobber the top-level
    # `tendermint-tpu --home ...` value (argparse subparser defaults
    # overwrite the parent namespace); the top-level flag provides the
    # actual default.
    common = {
        "--home": dict(default=argparse.SUPPRESS,
                       help="node home directory"),
        "--rpc-laddr": dict(default="127.0.0.1:26657",
                            help="node RPC address host:port"),
        "--pprof-laddr": dict(default="127.0.0.1:6060",
                              help="node debug/pprof address host:port"),
    }

    kp = dsub.add_parser(
        "kill", help="capture a debug bundle, then SIGABRT the node")
    kp.add_argument("pid", type=int, help="node process id")
    kp.add_argument("output_file", help="output .tar.gz path")
    for flag, kw in common.items():
        kp.add_argument(flag, **kw)
    kp.set_defaults(fn=cmd_debug_kill)

    tp = dsub.add_parser(
        "trace", help="capture a span trace (Perfetto/Chrome JSON)")
    tp.add_argument("output_file", help="output trace.json path")
    tp.add_argument("--seconds", type=float, default=0.0,
                    help="window to the trailing N seconds "
                         "(default: the whole span ring)")
    for flag, kw in common.items():
        tp.add_argument(flag, **kw)
    tp.set_defaults(fn=cmd_debug_trace)

    dp = dsub.add_parser(
        "dump", help="periodically capture debug bundles")
    dp.add_argument("output_dir", help="directory for .tar.gz bundles")
    dp.add_argument("--interval", type=float, default=30.0,
                    help="seconds between bundles")
    dp.add_argument("--count", type=int, default=None,
                    help="stop after N bundles (default: forever)")
    dp.add_argument("--profile-seconds", type=float, default=0.0,
                    help="include a CPU profile of this length")
    for flag, kw in common.items():
        dp.add_argument(flag, **kw)
    dp.set_defaults(fn=cmd_debug_dump)
