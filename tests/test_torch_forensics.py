"""Height forensics (tendermint_tpu_torch/tools/forensics.py) against
the JAX package's (tendermint_tpu/tools/forensics.py).

On the same synthetic span lists (made from a seed with numpy: a few
heights over five nodes, with re-proposals, missing anchors, a node
that restarts mid-height, spans of other heights and recv spans carrying
origin tags, some naming no known node), from_ring, from_chrome (the
same spans as a /debug/trace chrome export with a clock offset),
build_timeline, timeline_from_ring, committed_heights, orphan_origins,
timeline_summary and timeline_fingerprint give equal output. Then a
port sim run with collect_timeline=True passes timeline_attribution and
gives the reference's heights, rounds, proposers, quorums and node sets
(the stage milliseconds are wall time and may differ). Tolerance:
exact."""

import numpy as np
import pytest

from tendermint_tpu.tools import forensics as ref_forensics
from tendermint_tpu_torch.tools import forensics as port_forensics

from test_torch_sim import run

NODES = [f"val{i}" for i in range(5)]


def synthetic_records(seed: int) -> list[tuple]:
    """Tracer snapshot() tuples (kind, span_id, parent_id, tid, t0_ns,
    dur_ns, attrs) for heights 3-8 over five nodes."""
    rng = np.random.default_rng(seed)
    recs = []
    sid = 1

    def add(kind, t0, dur, **attrs):
        nonlocal sid
        recs.append((kind, sid, 0, int(rng.integers(1, 4)), int(t0),
                     int(dur), attrs))
        sid += 1

    t = 1_000_000_000
    for h in range(3, 9):
        rounds = 2 if h == 5 else 1
        proposer = NODES[h % 5]
        skip = NODES[(h + 2) % 5] if h == 6 else None  # lost anchors
        for node in NODES:
            if node == skip:
                add("consensus.height", t, 9_000_000, height=h, node=node)
                continue
            start = t + int(rng.integers(0, 2_000_000))
            parts = start + int(rng.integers(5_000_000, 30_000_000))
            quorum = parts + int(rng.integers(1_000_000, 20_000_000))
            height_attrs = dict(height=h, node=node)
            if not (h == 7 and node == NODES[1]):
                height_attrs["parts_complete_ns"] = parts
            if not (h == 8 and node == NODES[2]):
                height_attrs["precommit_quorum_ns"] = quorum
            add("consensus.height", start, quorum - start + 4_000_000,
                **height_attrs)
            for r in range(rounds):
                is_prop = node == proposer if r == rounds - 1 else \
                    node == NODES[(h + 1) % 5]
                add("consensus.propose", start + r * 1_000_000,
                    int(rng.integers(1_000_000, 4_000_000)),
                    height=h, round=r, node=node, proposer=is_prop)
            add("consensus.commit", quorum,
                int(rng.integers(500_000, 3_000_000)), height=h,
                round=rounds - 1, node=node)
            if h == 4 and node == NODES[3]:  # a restart re-commits
                add("consensus.commit", quorum + 9_000_000, 1_000_000,
                    height=h, round=0, node=node)
            for _ in range(3):
                origin = NODES[int(rng.integers(0, 5))]
                if rng.random() < 0.1:
                    origin = "stranger"
                add("p2p.recv_msg", start + int(rng.integers(0, 9_000_000)),
                    50_000, height=h, node=node, origin_node=origin)
        add("consensus.height", t, 1_000, height=h)  # no node: dropped
        t += 100_000_000
    add("crypto.verify", t, 1_000, lanes=4)
    return recs


def chrome_doc(records, node: str) -> dict:
    """One node's spans as /debug/trace's chrome export (ts/dur in us,
    span ids in args), its clock shifted back by 5 ms."""
    events = []
    for kind, sid, pid, tid, t0, dur, attrs in records:
        if (attrs or {}).get("node") != node:
            continue
        args = {k: v for k, v in attrs.items() if k != "node"}
        for k in ("parts_complete_ns", "precommit_quorum_ns"):
            if k in args:
                args[k] -= 5_000_000
        args.update(span_id=sid, parent_id=pid)
        events.append({"name": kind, "ph": "X", "tid": tid,
                       "ts": (t0 - 5_000_000) / 1e3, "dur": dur / 1e3,
                       "args": args})
    return {"traceEvents": events}


def views_dict(views) -> dict:
    return {k: {s: (sorted(getattr(v, s)) if s == "origin_nodes"
                    else getattr(v, s)) for s in v.__slots__}
            for k, v in views.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_spans_reconstruct_equally(seed):
    recs = synthetic_records(seed)
    mods = (ref_forensics, port_forensics)
    assert port_forensics.STAGES == ref_forensics.STAGES
    heights = [m.committed_heights(recs) for m in mods]
    assert heights[0] == heights[1] == list(range(3, 9))
    timelines = []
    for m in mods:
        out = []
        for h in heights[0] + [2, 99]:
            views = m.from_ring(recs, h)
            out.append((views_dict(views), m.build_timeline(views, h),
                        m.timeline_from_ring(recs, h),
                        views_dict(m.from_ring(recs, h, node="solo"))))
        chrome = []
        for node in NODES:
            for h in (4, 5, 7):
                v = m.from_chrome(chrome_doc(recs, node), h, node,
                                  offset_ns=5_000_000)
                chrome.append(views_dict(v))
                chrome.append(views_dict(m.from_chrome(
                    chrome_doc(recs, node), h, node)))
        tls = [o[2] for o in out]
        timelines.append((out, chrome, m.orphan_origins(recs, NODES),
                          m.timeline_summary(tls),
                          m.timeline_fingerprint(tls),
                          m.build_timeline({}, 3)))
    assert timelines[0] == timelines[1]
    out, _chrome, orphans, summary, fingerprint, empty = timelines[1]
    assert empty is None and summary["heights"] >= 5
    assert orphans in ([], ["stranger"])
    assert [f[0] for f in fingerprint] == [t["height"] for t in
                                           (o[2] for o in out) if t]
    assert port_forensics.timeline_summary([None]) == {"heights": 0}


def test_a_port_sim_timeline_equals_the_reference_but_its_stage_ms():
    """A healthy 4-net with collect_timeline=True: the timeline
    attribution invariant holds in the port, every stage is attributed
    on every height, and heights, rounds, proposers, quorums and node
    sets equal the reference's run of the same pair."""
    def project(r):
        return [(t["height"], t["round"], t["proposer"], t["quorum"],
                 t["nodes"]) for t in r["timeline"] if t]

    reports = [run(p, "smoke_quorum", 7, collect_timeline=True)
               for p in ("tendermint_tpu", "tendermint_tpu_torch")]
    ref, port = reports
    assert ref["violations"] == [] and port["violations"] == []
    assert project(port) == project(ref) and len(project(port)) >= 3
    assert port["app_hashes"] == ref["app_hashes"]
    assert port_forensics.timeline_fingerprint(port["timeline"]) == \
        ref_forensics.timeline_fingerprint(ref["timeline"])
    for t in filter(None, port["timeline"]):
        assert t["proposer"] in {f"sim{i}" for i in range(4)}
        assert all(t["stages"][s]["ms"] is not None
                   for s in port_forensics.STAGES)
        assert t["coverage"] >= 0.9
    assert port["timeline_dropped_spans"] == 0
