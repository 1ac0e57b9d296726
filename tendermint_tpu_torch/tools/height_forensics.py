"""Fleet height-forensics collector: pull /debug/trace from every
node, merge onto one clock, print per-height TIMELINE lines (reference:
the repository's root tools/height_forensics.py, the same lines and
exit codes, over the port's tools/forensics.py).

Usage:
    python -m tendermint_tpu_torch.tools.height_forensics \
        --node val0=127.0.0.1:6060 --node val1=127.0.0.1:6061 ... \
        [--height H | --last N] [--json]

Per node it fetches:
    /debug/trace/anchor          monotonic<->wall clock anchor
    /debug/trace?height=H        that height's spans only (the
                                 server-side filter keeps a 4-node
                                 poll per height in the tens of KB)

Each node's span timestamps are process-local perf_counter_ns; the
anchor (wall_ns - mono_ns, sampled back-to-back server-side) maps them
onto the shared wall-clock axis, which is what makes "node B received
the part 3.1 ms after node A sent it" a meaningful sentence across
processes. In-process nets don't need this tool — they read the shared
TRACER ring via tendermint_tpu_torch.tools.forensics.timeline_from_ring.

Output: one `TIMELINE {...}` JSON line per height (the same dict
tendermint_tpu_torch/tools/forensics.py documents) + a `TIMELINE_SUMMARY`
line with per-stage p50/p99 and the blame histogram. A node whose
ring dropped spans is reported — its heights may be unattributable
and the coverage field will say so.

Exit codes: 0 ok, 1 no height could be reconstructed, 2 bad usage.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from . import forensics


def _get_json(base: str, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(f"http://{base}{path}",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


def parse_nodes(specs: list[str]) -> dict[str, str]:
    """--node label=host:port pairs -> {label: host:port}; a bare
    host:port gets an auto label nodeN."""
    out = {}
    for i, spec in enumerate(specs):
        label, sep, addr = spec.partition("=")
        if not sep:
            label, addr = f"node{i}", spec
        out[label] = addr
    return out


def collect_height(nodes: dict[str, str], height: int,
                   anchors: dict[str, dict]) -> dict | None:
    """Merge one height's spans across the fleet into a TIMELINE."""
    views: dict[str, forensics.NodeView] = {}
    for label, addr in nodes.items():
        try:
            doc = _get_json(addr, f"/debug/trace?height={height}")
        except Exception as e:
            print(f"warning: {label} ({addr}) trace fetch failed: {e!r}",
                  file=sys.stderr)
            continue
        off = anchors.get(label, {}).get("offset_ns", 0)
        views.update(forensics.from_chrome(doc, height, label,
                                           offset_ns=off))
    return forensics.build_timeline(views, height)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cross-node per-height critical-path attribution")
    ap.add_argument("--node", action="append", default=[],
                    metavar="LABEL=HOST:PORT", dest="nodes",
                    help="a node's debug server (repeat per node)")
    ap.add_argument("--height", type=int, default=0,
                    help="reconstruct exactly this height")
    ap.add_argument("--last", type=int, default=5,
                    help="without --height: the last N committed "
                         "heights visible in the fleet's rings")
    ap.add_argument("--json", action="store_true",
                    help="bare JSON lines (no TIMELINE prefix)")
    args = ap.parse_args(argv)
    if not args.nodes:
        ap.error("at least one --node is required")
    nodes = parse_nodes(args.nodes)

    # Clock anchors first: offset = wall - mono per node. Fetched once
    # — perf_counter and the wall clock drift apart over hours, but a
    # forensics poll is seconds wide.
    anchors: dict[str, dict] = {}
    dropped_any = False
    for label, addr in nodes.items():
        try:
            a = _get_json(addr, "/debug/trace/anchor")
            anchors[label] = {"offset_ns": a["wall_ns"] - a["mono_ns"]}
            if a.get("spans_dropped"):
                dropped_any = True
                print(f"warning: {label} ring dropped "
                      f"{a['spans_dropped']} spans (capacity "
                      f"{a.get('capacity')}) — older heights may be "
                      "unattributable", file=sys.stderr)
        except Exception as e:
            print(f"warning: {label} ({addr}) anchor fetch failed: "
                  f"{e!r} (offset 0 — same-process only)",
                  file=sys.stderr)

    if args.height:
        heights = [args.height]
    else:
        # candidates: commit spans anywhere in the fleet's rings
        seen: set[int] = set()
        for label, addr in nodes.items():
            try:
                doc = _get_json(addr, "/debug/trace")
            except Exception:
                continue
            for ev in doc.get("traceEvents", []):
                if ev.get("name") == "consensus.commit":
                    h = (ev.get("args") or {}).get("height")
                    if h:
                        seen.add(h)
        heights = sorted(seen)[-args.last:]

    timelines = []
    for h in heights:
        tl = collect_height(nodes, h, anchors)
        if tl is None:
            print(f"warning: height {h}: not reconstructable",
                  file=sys.stderr)
            continue
        timelines.append(tl)
        prefix = "" if args.json else "TIMELINE "
        print(f"{prefix}{json.dumps(tl, sort_keys=True)}")

    if not timelines:
        print("error: no height could be reconstructed", file=sys.stderr)
        return 1
    summary = forensics.timeline_summary(timelines)
    summary["rings_dropped_spans"] = dropped_any
    prefix = "" if args.json else "TIMELINE_SUMMARY "
    print(f"{prefix}{json.dumps(summary, sort_keys=True)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
