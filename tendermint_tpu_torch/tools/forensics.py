"""Height forensics: cross-node timeline reconstruction + per-height
critical-path attribution from span-tracer rings (reference:
tendermint_tpu/tools/forensics.py).

The span tracer (libs/tracing.py) answers "where did time go in THIS
process"; this module answers the fleet question — for a committed
height, how did the wall time split across

    propose   proposer's block build (height start → propose-step end
              on the node whose propose span carries proposer=True)
    gossip    block-part dissemination (build done → a quorum of
              validators holds the full part set)
    verify    vote pipeline (quorum part-complete → the precommit
              quorum landing on a quorum of validators)
    commit    finalize (precommit quorum → a quorum done with the
              COMMIT step)

and which node each boundary waited on. Stage boundaries come from
attrs the consensus state machine stamps on its height/step spans
(consensus/state.py: proposer, parts_complete_ns, precommit_quorum_ns)
— no span joins, no new hot-path span sites.

Inputs are per-node span views. In-process nets (tests, sim) read the
shared TRACER ring directly via `from_ring`; subprocess nets go through
the reference's root tools/height_forensics.py (not yet ported), which
pulls GET /debug/trace?height=H per node and maps each node's
perf_counter clock onto a shared wall axis using the
/debug/trace/anchor offset (`from_chrome` + `offset_ns`).

Quorum semantics follow the consensus rule: q = 2n//3 + 1 of the
height's participating nodes. Boundaries take the q-th smallest
timestamp — the node supplying it is the straggler that gated the
quorum, and it gets the blame for the stage.

Output is the TIMELINE dict (one JSON line per height when serialized):

    {"height": H, "round": R, "wall_ms": ..., "proposer": "val0",
     "quorum": 3, "nodes": ["val0", ...],
     "stages": {"propose": {"ms": ..., "node": "val0"}, ...},
     "coverage": 0.97,
     "blame": {"stage": "gossip", "node": "val2", "ms": ...}}

coverage = sum(stage ms)/wall: < 0.9 means an anchor was missing
(node restarted mid-height, ring overflowed...) and the line must not
be read as a complete attribution.
"""

from __future__ import annotations

STAGES = ("propose", "gossip", "verify", "commit")


class NodeView:
    """One node's spans for one height, on a common clock: boundary
    timestamps in ns (None when the anchor is missing)."""

    __slots__ = ("node", "height", "round", "height_t0", "proposer",
                 "propose_end", "parts_complete", "precommit_quorum",
                 "commit_end", "origin_nodes")

    def __init__(self, node: str, height: int):
        self.node = node
        self.height = height
        self.round = 0
        self.height_t0 = None
        self.proposer = False
        self.propose_end = None
        self.parts_complete = None
        self.precommit_quorum = None
        self.commit_end = None
        self.origin_nodes: set[str] = set()


def from_ring(records, height: int,
              node: str | None = None) -> dict[str, NodeView]:
    """Build per-node views for `height` from tracer snapshot()
    tuples (kind, span_id, parent_id, tid, t0_ns, dur_ns, attrs).
    In-process nets interleave every node's spans in ONE ring; the
    node= attr (ConsensusState.trace_node) demultiplexes them. `node`
    overrides attribution for single-node rings without the attr."""
    views: dict[str, NodeView] = {}

    def view(label: str) -> NodeView:
        if label not in views:
            views[label] = NodeView(label, height)
        return views[label]

    for kind, _sid, _pid, _tid, t0, dur, attrs in records:
        a = attrs or {}
        if a.get("height") != height:
            continue
        label = node or a.get("node")
        if not label:
            continue
        v = view(label)
        if kind == "consensus.height":
            v.height_t0 = t0
            if "parts_complete_ns" in a:
                v.parts_complete = a["parts_complete_ns"]
            if "precommit_quorum_ns" in a:
                v.precommit_quorum = a["precommit_quorum_ns"]
        elif kind == "consensus.propose":
            if a.get("proposer"):
                v.proposer = True
                v.propose_end = t0 + dur
                v.round = max(v.round, a.get("round", 0))
        elif kind == "consensus.commit":
            end = t0 + dur
            if v.commit_end is None or end > v.commit_end:
                v.commit_end = end
            v.round = max(v.round, a.get("round", 0))
        if "origin_node" in a:
            v.origin_nodes.add(a["origin_node"])
    return views


def from_chrome(doc: dict, height: int, node: str,
                offset_ns: int = 0) -> dict[str, NodeView]:
    """Build views from a /debug/trace?height=H chrome_trace export of
    ONE node's ring. `offset_ns` (wall_ns - mono_ns from the node's
    /debug/trace/anchor) shifts its perf_counter timestamps onto the
    shared wall axis; ts/dur are µs in the export."""
    records = []
    for ev in doc.get("traceEvents", []):
        args = dict(ev.get("args") or {})
        sid = args.pop("span_id", 0)
        pid = args.pop("parent_id", 0)
        records.append((
            ev["name"], sid, pid, ev.get("tid", 0),
            int(ev["ts"] * 1e3) + offset_ns, int(ev["dur"] * 1e3),
            args,
        ))
    # anchor attrs are perf_counter ns too: shift them the same way
    views = from_ring(records, height, node=node)
    if offset_ns:
        for v in views.values():
            if v.parts_complete is not None:
                v.parts_complete += offset_ns
            if v.precommit_quorum is not None:
                v.precommit_quorum += offset_ns
    return views


def _quorum_nth(pairs, q):
    """(timestamp, node) of the q-th smallest defined timestamp, or
    (None, None) when fewer than q nodes have it."""
    have = sorted((t, n) for n, t in pairs if t is not None)
    if len(have) < q:
        return None, None
    return have[q - 1]


def build_timeline(views: dict[str, NodeView],
                   height: int) -> dict | None:
    """The TIMELINE dict for one height, or None when the views cannot
    support one (no proposer span, no quorum of commit ends)."""
    if not views:
        return None
    nodes = sorted(views)
    n = len(nodes)
    q = (2 * n) // 3 + 1

    proposers = [v for v in views.values() if v.proposer]
    if not proposers:
        return None
    # re-proposals: the last round's proposer owns the commit path
    prop = max(proposers, key=lambda v: v.round)
    t_start = prop.height_t0
    t_build = prop.propose_end

    t_gossip, n_gossip = _quorum_nth(
        ((v.node, v.parts_complete) for v in views.values()), q)
    t_verify, n_verify = _quorum_nth(
        ((v.node, v.precommit_quorum) for v in views.values()), q)
    t_commit, n_commit = _quorum_nth(
        ((v.node, v.commit_end) for v in views.values()), q)
    if t_start is None or t_commit is None:
        return None

    # Clamp each boundary monotonic (running max): an anchor can land
    # marginally before the previous boundary on a racing net; a
    # negative stage would be nonsense, 0 ms is the honest reading.
    bounds = [t_start]
    stage_nodes = [prop.node, n_gossip, n_verify, n_commit]
    for t in (t_build, t_gossip, t_verify, t_commit):
        bounds.append(max(bounds[-1], t) if t is not None else None)

    wall_ms = (t_commit - t_start) / 1e6
    stages = {}
    prev = bounds[0]
    covered = 0.0
    for name, bound, who in zip(STAGES, bounds[1:], stage_nodes):
        if bound is None or prev is None:
            stages[name] = {"ms": None, "node": who}
            prev = bound if bound is not None else prev
            continue
        ms = (bound - prev) / 1e6
        stages[name] = {"ms": round(ms, 3), "node": who}
        covered += ms
        prev = bound

    blame = None
    attributed = [(s, d) for s, d in stages.items() if d["ms"] is not None]
    if attributed:
        bs, bd = max(attributed, key=lambda kv: kv[1]["ms"])
        blame = {"stage": bs, "node": bd["node"], "ms": bd["ms"]}

    return {
        "height": height,
        "round": prop.round,
        "wall_ms": round(wall_ms, 3),
        "proposer": prop.node,
        "quorum": q,
        "nodes": nodes,
        "stages": stages,
        "coverage": round(covered / wall_ms, 4) if wall_ms > 0 else 0.0,
        "blame": blame,
    }


def timeline_from_ring(records, height: int) -> dict | None:
    """One-call form for in-process nets: snapshot() tuples in, the
    TIMELINE dict out."""
    return build_timeline(from_ring(records, height), height)


def committed_heights(records) -> list[int]:
    """Heights with at least one finished consensus.commit span in the
    records — the candidates timeline_from_ring can attribute."""
    hs = {r[6]["height"] for r in records
          if r[0] == "consensus.commit" and r[6] and "height" in r[6]}
    return sorted(hs)


def orphan_origins(records, known_nodes) -> list[str]:
    """origin_node values rehydrated into recv spans that name a node
    outside `known_nodes` — non-empty means a stamp/label mismatch
    (the cross-node link would dangle). The tier-1 4-net test pins
    this empty."""
    known = set(known_nodes)
    bad = []
    for r in records:
        a = r[6] or {}
        o = a.get("origin_node")
        if o and o not in known:
            bad.append(o)
    return sorted(set(bad))


def timeline_summary(timelines) -> dict:
    """Run-level rollup over TIMELINE dicts: per-stage p50/p99 ms,
    wall p50/p99, and a blame histogram — the payload bench.py / the
    e2e runner embed in their reports."""
    tls = [t for t in timelines if t]
    if not tls:
        return {"heights": 0}

    def pcts(vals):
        vals = sorted(vals)
        n = len(vals)

        def pct(p):
            return round(vals[min(n - 1, int(p * n))], 3)

        return {"p50_ms": pct(0.50), "p99_ms": pct(0.99)}

    out = {"heights": len(tls),
           "wall": pcts([t["wall_ms"] for t in tls]),
           "coverage_min": min(t["coverage"] for t in tls),
           "stages": {}, "blame": {}}
    for s in STAGES:
        vals = [t["stages"][s]["ms"] for t in tls
                if t["stages"][s]["ms"] is not None]
        if vals:
            out["stages"][s] = pcts(vals)
    for t in tls:
        if t["blame"]:
            key = t["blame"]["stage"]
            out["blame"][key] = out["blame"].get(key, 0) + 1
    return out


def timeline_fingerprint(timelines) -> list[tuple]:
    """The deterministic projection of a timeline run: stage DURATIONS
    are wall-clock (perf_counter) and vary run to run even under the
    sim's virtual clock, but WHICH heights committed, who proposed
    them, and which stages got attributed are seed-determined. The
    sim determinism pin compares this."""
    fp = []
    for t in timelines:
        if not t:
            continue
        fp.append((t["height"], t["round"], t["proposer"],
                   tuple(s for s in STAGES
                         if t["stages"][s]["ms"] is not None)))
    return fp
