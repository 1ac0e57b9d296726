"""The port's span tracer (tendermint_tpu_torch/libs/tracing.py) held
against the JAX package's (tendermint_tpu/libs/tracing.py).

The cases of the reference's tests/test_tracing.py about the tracer
itself run on both packages (parametrised); the same span records from
a numpy seed render to the same Chrome trace and the same stage rollup
in both; the kind registry and the origin tag's bytes are equal. The
reference's lint and overhead-budget case is left out (its tools are
not ported); this file asserts no wall-clock budget."""

from __future__ import annotations

import asyncio
import json
import threading

import numpy as np
import pytest

from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.crypto.cuda import ledger as pledger
from tendermint_tpu_torch.libs import tracing as ptracing

PACKAGES = {"port": ptracing, "reference": jtracing}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_span_nesting_and_parent_links(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=64)
    with t.span(tr.CONSENSUS_HEIGHT, height=7) as root:
        with t.span(tr.CONSENSUS_PROPOSE) as child:
            assert t.current() is child
        assert t.current() is root
    assert t.current() is None
    recs = {r[0]: r for r in t.snapshot()}
    assert recs[tr.CONSENSUS_PROPOSE][2] == root.span_id
    assert recs[tr.CONSENSUS_HEIGHT][2] == 0
    assert recs[tr.CONSENSUS_HEIGHT][6] == {"height": 7}
    assert recs[tr.CONSENSUS_PROPOSE][5] <= recs[tr.CONSENSUS_HEIGHT][5]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_span_nesting_across_executor_handoff(pkg):
    """run_in_executor does not carry the caller's Context; TRACER.wrap
    does."""
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=64)
    seen = {}

    async def go():
        loop = asyncio.get_running_loop()

        def work():
            cur = t.current()
            seen["inside"] = cur.span_id if cur else 0
            with t.span(tr.CRYPTO_BATCH, lanes=3):
                pass

        def bare():
            cur = t.current()
            seen["bare"] = cur.span_id if cur else 0

        with t.span(tr.CONSENSUS_VOTE_BATCH, lanes=3) as parent:
            seen["parent"] = parent.span_id
            await loop.run_in_executor(None, t.wrap(work))
            await loop.run_in_executor(None, bare)

    asyncio.run(go())
    assert seen["inside"] == seen["parent"] != 0
    assert seen["bare"] == 0
    recs = {r[0]: r for r in t.snapshot()}
    assert recs[tr.CRYPTO_BATCH][2] == seen["parent"]
    assert recs[tr.CRYPTO_BATCH][3] != recs[tr.CONSENSUS_VOTE_BATCH][3]


def test_wrap_carries_the_launch_workload_into_the_thread():
    """The port keeps the launch ledger's workload tag beside the active
    span, so the same handoff carries both."""
    out = {}

    def work():
        out["wrapped"] = pledger.current_workload()

    def bare():
        out["bare"] = pledger.current_workload()

    with pledger.workload("speculation"):
        a = threading.Thread(target=ptracing.TRACER.wrap(work))
        b = threading.Thread(target=bare)
        a.start(), b.start()
        a.join(), b.join()
    assert out == {"wrapped": "speculation", "bare": "consensus"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ring_buffer_eviction_under_overflow(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=8)
    for i in range(50):
        with t.span(tr.CRYPTO_PACK, lanes=i):
            pass
    assert len(t) == 8
    assert [r[6]["lanes"] for r in t.snapshot()] == list(range(42, 50))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ring_eviction_counts_dropped_spans(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=8)
    sunk = []
    t.set_drop_sink(sunk.append)
    for i in range(50):
        with t.span(tr.CRYPTO_PACK, lanes=i):
            pass
    assert t.dropped == 42 and sum(sunk) == 42
    t.set_drop_sink(lambda n: 1 / 0)
    with t.span(tr.CRYPTO_PACK, lanes=99):
        pass
    assert t.dropped == 43
    t.clear()
    assert t.dropped == 0 and len(t) == 0


def test_origin_tag_bytes_equal_and_cross_decode():
    for args in ((12345, 3, "sim2", 0xDEADBEEF), (1, 0, "x" * 200, 0),
                 (2**64 - 1, 2**32 - 1, "välidator", 7)):
        pb, jb = ptracing.encode_origin(*args), jtracing.encode_origin(*args)
        assert pb == jb
        assert tuple(ptracing.decode_origin(jb)) == \
            tuple(jtracing.decode_origin(pb))
    for garbage in (b"", b"\x01\x02", b"\xff" + pb[1:], pb[:5], None):
        assert ptracing.decode_origin(garbage) is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_origin_stamp_and_rehydrate_attach_to_current_span(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=32)
    tok = tr._CURRENT.set(None)
    try:
        with t.span(tr.CONSENSUS_PROPOSE, height=9) as send_sp:
            tag = tr.origin_stamp("val1", 9, 2)
        dec = tr.decode_origin(tag)
        assert (dec.node, dec.height, dec.round, dec.span_id) == \
            ("val1", 9, 2, send_sp.span_id)
        with t.span(tr.P2P_RECV_MSG, chan=0x21):
            tr.rehydrate_origin(tag)
        recv = t.snapshot()[-1][6]
        assert (recv["origin_node"], recv["origin_height"],
                recv["origin_round"], recv["origin_span"]) == \
            ("val1", 9, 2, send_sp.span_id)
        bare = tr.origin_stamp("val1", 10, 0)
        assert tr.decode_origin(bare).span_id == 0
        tr.rehydrate_origin(bare)
        tr.rehydrate_origin(b"not-a-tag")
    finally:
        tr._CURRENT.reset(tok)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_disabled_tracer_records_nothing(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=8, enabled=False)
    with t.span(tr.CRYPTO_PACK, lanes=1) as sp:
        assert sp is tr.NOOP_SPAN and t.current() is None
    assert len(t) == 0 and t.begin(tr.CRYPTO_PACK) is tr.NOOP_SPAN


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_unregistered_kind_rejected(pkg):
    tr = PACKAGES[pkg]
    with pytest.raises(ValueError, match="unregistered span kind"):
        tr.Tracer(capacity=8).begin("adhoc.kind")


def test_the_kind_registry_is_the_references():
    base = {k for k in jtracing.registered_kinds()
            if not k.startswith("test.")}
    assert base <= ptracing.registered_kinds()
    assert {k for k in ptracing.registered_kinds()
            if not k.startswith("test.")} == base
    for step in ("PROPOSE", "PREVOTE", "PRECOMMIT_WAIT", "COMMIT",
                 "NEW_HEIGHT"):
        assert ptracing.consensus_step_kind(step) == \
            jtracing.consensus_step_kind(step)


def _seeded_records(seed: int, n: int = 60) -> list[tuple]:
    """Span tuples (kind, id, parent, tid, t0_ns, dur_ns, attrs) from a
    numpy seed, over the kinds both registries hold."""
    rng = np.random.default_rng(seed)
    kinds = sorted(jtracing.registered_kinds() - {"test.kind"})
    out = []
    t0 = 10**12
    for i in range(n):
        t0 += int(rng.integers(1, 10**6))
        attrs = ({"lanes": int(rng.integers(1, 1024))}
                 if rng.integers(2) else None)
        out.append((kinds[rng.integers(len(kinds))], i + 1,
                    int(rng.integers(0, i + 1)), int(rng.integers(1, 4)),
                    t0, int(rng.integers(1, 5 * 10**7)), attrs))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_equal_on_the_same_spans(seed):
    recs = _seeded_records(seed)
    meta = {"capacity": 64, "dropped": 3}
    p = json.loads(json.dumps(ptracing.chrome_trace(recs, meta)))
    j = json.loads(json.dumps(jtracing.chrome_trace(recs, meta)))
    assert p == j
    assert p["displayTimeUnit"] == "ms" and p["tm_tpu"] == meta
    for e in p["traceEvents"]:
        assert e["ph"] == "X" and e["cat"] == e["name"].partition(".")[0]
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert isinstance(e["args"]["span_id"], int)


@pytest.mark.parametrize("seed", [3, 4])
def test_stage_rollup_equal_on_the_same_spans(seed):
    recs = _seeded_records(seed)
    got = {}
    for k, tr in PACKAGES.items():
        t = tr.Tracer(capacity=128)
        t._ring.extend(recs)
        got[k] = (t.stage_rollup(), t.stage_rollup(prefix="crypto."),
                  t.stage_rollup(prefix="consensus."))
    assert got["port"] == got["reference"]
    full = got["port"][0]
    assert sum(v["count"] for v in full.values()) == len(recs)
    for v in full.values():
        assert v["p50_ms"] <= v["p95_ms"] <= v["p99_ms"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stage_rollup_windows_and_prefix(pkg):
    tr = PACKAGES[pkg]
    t = tr.Tracer(capacity=64)
    for i in range(10):
        with t.span(tr.CRYPTO_PACK, lanes=i):
            pass
    with t.span(tr.WAL_FSYNC):
        pass
    roll = t.stage_rollup()
    assert roll[tr.CRYPTO_PACK]["count"] == 10
    only = t.stage_rollup(prefix="crypto.")
    assert tr.WAL_FSYNC not in only and only[tr.CRYPTO_PACK]["count"] == 10
    assert t.stage_rollup(seconds=3600)[tr.WAL_FSYNC]["count"] == 1
