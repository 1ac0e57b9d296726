"""Soak test: a live perturbed testnet under tx load for N minutes,
then a sweep of every node log for silent task deaths (reference: the
repository's root tools/soak.py, the same schedule and log sweep, over
the port's e2e Runner).

A gossip-routine crash in the reference was once SILENT — the task died,
the log line scrolled by, and the net limped. This harness makes that
class of failure loud: after the run, any Traceback / "died" /
"Task exception" line in any node log fails the soak.

    python -m tendermint_tpu_torch.tools.soak [--minutes 5] [--nodes 4]
        [--out DIR] [--chaos] [--device {cuda,cpu}]

--chaos interleaves failpoint injections (libs/failpoints.py via each
node's POST /debug/failpoint) with the process-level perturbations:
slow fsyncs, slow DB writes, ABCI delivery stalls and a dead device
window — the graceful-degradation paths must carry the net through
without a wedge or a silent task death. Every node runs on --device
(default the card).
"""

import asyncio
import os
import re
import shutil
import sys

# Hard markers are NEVER excused — a dead task line that happens to
# mention churn words ("timed out", "connection lost") is still a dead
# task. Weak markers can be excused by the churn whitelist.
HARD = re.compile(
    rb"Traceback|routine for .* died|Task exception|exception was never")
WEAK = re.compile(rb"AssertionError|attribute")

# Benign, expected log noise (peer churn during perturbations).
ALLOWED = re.compile(
    rb"stopping peer|unreachable|reconnect|rejected inbound|timed out"
    rb"|connection lost|flood")


# The --chaos injection rotation: degrade-don't-kill shapes (a crash
# is the `kill` op's job). Each arms for a few seconds on one node.
CHAOS_ROTATION = (
    {"failpoint": "wal.fsync", "action": "delay", "delay_ms": 25},
    {"failpoint": "db.set", "action": "delay", "delay_ms": 10},
    {"failpoint": "device.verify", "action": "error"},
    {"failpoint": "abci.deliver", "action": "delay", "delay_ms": 10},
)


# Injected faults legitimately log tracebacks (the degradation
# handlers use logger.exception). In chaos mode a HARD line whose
# following ~40 lines mention the injection is EXPECTED noise; a
# traceback without that fingerprint is still a real bug.
_INJECTED = re.compile(rb"FailpointError|injected failpoint")
_EXCUSE_WINDOW = 40


def _sweep_log(log_path: str, node_i: int, chaos: bool) -> list:
    """Streaming sweep — soak logs can run to hundreds of MB, so the
    chaos excuse window is a bounded pending list, never a whole-file
    buffer."""
    bad = []
    pending = []  # chaos mode: (line_no, text) HARD hits awaiting excuse
    with open(log_path, "rb") as f:
        for line_no, line in enumerate(f, 1):
            if chaos:
                if _INJECTED.search(line):
                    pending.clear()  # everything in-window is excused
                else:
                    while pending and \
                            line_no - pending[0][0] > _EXCUSE_WINDOW:
                        bad.append((node_i,) + pending.pop(0))
            if HARD.search(line):
                text = line.rstrip()[:160]
                if chaos:
                    pending.append((line_no, text))
                else:
                    bad.append((node_i, line_no, text))
            elif WEAK.search(line) and not ALLOWED.search(line):
                bad.append((node_i, line_no, line.rstrip()[:160]))
    bad.extend((node_i,) + p for p in pending)  # unexcused at EOF
    return bad


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--out", default="./soak-net")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    minutes, nodes, out, chaos = (args.minutes, args.nodes, args.out,
                                  args.chaos)

    from ..e2e import Manifest, Runner
    from ..e2e.runner import BASE_PORT

    m = Manifest.from_dict(soak_manifest(minutes, nodes, chaos))
    # the soak's own range, apart from the e2e default's
    runner = Runner(m, out, base_port=BASE_PORT + 1000,
                    device=args.device)
    report = asyncio.run(asyncio.wait_for(
        runner.run(), timeout=minutes * 60 + 600))
    print("run report:", report)

    bad = []
    for i in range(nodes):
        bad.extend(_sweep_log(
            os.path.join(out, f"node{i}", "node.log"), i, chaos))
    if bad:
        print(f"SOAK FAILED: {len(bad)} suspect log lines:")
        for node_i, line_no, line in bad[:40]:
            print(f"  node{node_i}:{line_no}: "
                  f"{line.decode(errors='replace')}")
        return 1
    print(f"soak clean: {nodes} nodes, {minutes} min, "
          f"{report['txs_sent']} txs, height {report['height']}, "
          "no silent task deaths")
    shutil.rmtree(out, ignore_errors=True)
    return 0


def soak_manifest(minutes: float, nodes: int, chaos: bool) -> dict:
    """The soak's manifest: a perturbation a minute spread over the
    run, every node hit, and with `chaos` a failpoint window a minute
    offset from them (the reference's schedule)."""
    # Perturbation schedule spread over the soak: every node gets hit.
    height_per_min = 60_000 // 400  # ~150 heights/min at 400ms commits
    total_h = int(minutes * height_per_min * 0.5)  # conservative bar
    perturbs = []
    for k in range(int(minutes)):
        perturbs.append({
            "node": k % nodes,
            "op": ("kill", "pause", "restart", "disconnect",
                   "disconnect_hard")[k % 5],
            "at_height": 5 + k * max(5, total_h // max(int(minutes), 1)),
            "duration": 3.0,
        })
    if chaos:
        # offset from the process perturbations so both fault classes
        # are live in the same run without hitting the same node at
        # the same instant
        for k in range(int(minutes)):
            perturbs.append({
                "node": (k + 1) % nodes,
                "op": "chaos",
                "at_height": 8 + k * max(
                    5, total_h // max(int(minutes), 1)),
                "duration": 4.0,
                **CHAOS_ROTATION[k % len(CHAOS_ROTATION)],
            })
    return {
        "chain_id": "soak-chain",
        "nodes": nodes,
        "wait_height": max(20, total_h),
        "load_tx_rate": 10.0,
        "timeout_commit_ms": 400,
        "perturbations": perturbs,
    }


if __name__ == "__main__":
    sys.exit(main())
