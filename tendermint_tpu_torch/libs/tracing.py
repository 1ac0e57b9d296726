"""Always-on span tracer (reference: tendermint_tpu/libs/tracing.py):
per-height consensus timelines and device-pipeline stage attribution.

Monotonic-clock spans with parent/child links over the hot paths:

  consensus.height                     one root span per height
    consensus.propose / .prevote / .precommit / .commit ...
      wal.fsync                        every write_sync
      state.apply_block                ApplyBlock wall time
        crypto.batch                   a BatchVerifier.verify call
          crypto.verify                one device verify
            crypto.pack                host byte packing (numpy)
            crypto.dispatch            kernel-launch enqueue
            crypto.device_exec         wait until the verdicts are ready
            crypto.readback            device->host verdict copy
  p2p.send_flush / p2p.recv_msg        wire-side attribution

It stays on: a fixed-size ring (deque(maxlen=N), default 16k spans),
time.perf_counter_ns() start and stop, the active span in a context
variable. Executor threads do not inherit it (run_in_executor ignores
the caller's Context), so a cross-thread handoff is explicit:
`loop.run_in_executor(None, TRACER.wrap(fn), ...)` carries the caller's
active span and its launch-ledger workload tag into the worker thread.
Span kinds are a closed registry; an unregistered kind raises at span
start.

The consensus wire's origin tag (Proposal, BlockPart, Vote; optional
proto field 15) carries the span id active at send time, and the
receiver folds it into its live p2p.recv_msg span.

Export: chrome_trace() renders the ring as Chrome trace-event JSON,
served at GET /debug/trace?seconds=N (libs/debugsrv.py); stage_rollup()
gives per-kind p50/p95/p99.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import struct
import threading
import time
from collections import deque
from typing import NamedTuple

# ---------------------------------------------------------------- registry

_KINDS: set[str] = set()


def register_kind(name: str) -> str:
    """Register a span kind. Instrumented modules use the constants
    below; tests may register their own (namespaced `test.*`)."""
    _KINDS.add(name)
    return name


def registered_kinds() -> frozenset[str]:
    return frozenset(_KINDS)


# Consensus timeline (one root per height; step children follow
# consensus/cstypes.py RoundStep names via consensus_step_kind()).
CONSENSUS_HEIGHT = register_kind("consensus.height")
CONSENSUS_PROPOSE = register_kind("consensus.propose")
CONSENSUS_PREVOTE = register_kind("consensus.prevote")
CONSENSUS_PREVOTE_WAIT = register_kind("consensus.prevote_wait")
CONSENSUS_PRECOMMIT = register_kind("consensus.precommit")
CONSENSUS_PRECOMMIT_WAIT = register_kind("consensus.precommit_wait")
CONSENSUS_COMMIT = register_kind("consensus.commit")
CONSENSUS_NEW_ROUND = register_kind("consensus.new_round")
CONSENSUS_VOTE_BATCH = register_kind("consensus.vote_batch")

_STEP_KINDS = {
    "PROPOSE": CONSENSUS_PROPOSE,
    "PREVOTE": CONSENSUS_PREVOTE,
    "PREVOTE_WAIT": CONSENSUS_PREVOTE_WAIT,
    "PRECOMMIT": CONSENSUS_PRECOMMIT,
    "PRECOMMIT_WAIT": CONSENSUS_PRECOMMIT_WAIT,
    "COMMIT": CONSENSUS_COMMIT,
}


def consensus_step_kind(step_name: str) -> str:
    """RoundStep name -> registered step-span kind (NEW_HEIGHT /
    NEW_ROUND transitions fold into consensus.new_round)."""
    return _STEP_KINDS.get(step_name, CONSENSUS_NEW_ROUND)


# Device pipeline (crypto/batch.py, crypto/tpu/verify.py + expanded.py).
CRYPTO_BATCH = register_kind("crypto.batch")
CRYPTO_VERIFY = register_kind("crypto.verify")
CRYPTO_PACK = register_kind("crypto.pack")
CRYPTO_DISPATCH = register_kind("crypto.dispatch")
CRYPTO_DEVICE_EXEC = register_kind("crypto.device_exec")
CRYPTO_READBACK = register_kind("crypto.readback")
CRYPTO_HOST_VERIFY = register_kind("crypto.host_verify")

# Verify-ahead pipeline (consensus/speculation.py + crypto/tpu/
# resident.py): speculate = an ahead-of-commit verification launch,
# patch = a delta splice into the device-resident arena, reconcile =
# the commit-time serve (template match + miss fallback).
SPECULATION_SPECULATE = register_kind("speculation.speculate")
SPECULATION_PATCH = register_kind("speculation.patch")
SPECULATION_RECONCILE = register_kind("speculation.reconcile")

# State machine + durability + wire.
STATE_APPLY_BLOCK = register_kind("state.apply_block")
WAL_FSYNC = register_kind("wal.fsync")
P2P_SEND_FLUSH = register_kind("p2p.send_flush")
P2P_RECV_MSG = register_kind("p2p.recv_msg")


# ---------------------------------------------------------------- spans

_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tm_tpu_trace_span", default=None
)

_ids = itertools.count(1)  # CPython: count.__next__ is GIL-atomic


# ---------------------------------------------------------------- workload
#
# The launch ledger's workload tag (crypto/cuda/ledger.py) lives here,
# beside the active span, so that TRACER.wrap carries both into an
# executor thread: a launch made there is tagged with its plane, not
# "unknown" or the default.

WORKLOAD: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tm_tpu_launch_workload", default="consensus")


def _workload_of() -> str:
    return WORKLOAD.get()


def _set_workload(tag: str):
    return WORKLOAD.set(tag)


def _reset_workload(token) -> None:
    WORKLOAD.reset(token)


class Span:
    """A live span. end() seals it into the tracer's ring buffer as a
    plain tuple; no reference is kept after that beyond the ring."""

    __slots__ = ("kind", "span_id", "parent_id", "tid", "t0", "attrs",
                 "_tracer", "_done")

    def __init__(self, tracer: "Tracer", kind: str, parent_id: int,
                 attrs: dict | None):
        self.kind = kind
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.tid = threading.get_ident()
        self.attrs = attrs
        self._tracer = tracer
        self._done = False
        self.t0 = time.perf_counter_ns()

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def end(self) -> None:
        if self._done:  # idempotent: height/step spans end via two paths
            return
        self._done = True
        t1 = time.perf_counter_ns()
        tracer = self._tracer
        # Ring-overflow accounting: deque(maxlen=N) evicts silently, so
        # a truncated timeline would be indistinguishable from a complete
        # one. len() on a deque is O(1); the increment is GIL-atomic
        # enough for a monitoring counter (exactness is not load-bearing,
        # non-zero-ness is).
        if len(tracer._ring) >= tracer.capacity:
            tracer._dropped += 1
            dsink = tracer.drop_sink
            if dsink is not None:
                try:
                    dsink(1)
                except Exception:
                    pass
        tracer._ring.append((
            self.kind, self.span_id, self.parent_id, self.tid,
            self.t0, t1 - self.t0, self.attrs,
        ))
        # tracing→metrics bridge: the same close feeds the kind's
        # Prometheus histogram (libs/metrics.py span_metrics_sink) —
        # one instrumentation point, two exports. Monitoring must
        # never take down the instrumented path, hence the blanket
        # except; the sink itself is a dict lookup + bucket scan.
        sink = tracer.metrics_sink
        if sink is not None:
            try:
                sink(self.kind, (t1 - self.t0) / 1e9)
            except Exception:
                pass


class _NoopSpan:
    """Shared do-nothing span for the disabled tracer (and a safe
    parent placeholder): keeps call sites branch-free."""

    __slots__ = ()
    kind = ""
    span_id = 0
    parent_id = 0

    def set_attr(self, key, value) -> None:
        pass

    def end(self) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _SpanCtx:
    """Context manager: starts a span parented on the task-local
    current span, makes it current for the body, seals it on exit."""

    __slots__ = ("_tracer", "_kind", "_attrs", "_span", "_token")

    def __init__(self, tracer, kind, attrs):
        self._tracer = tracer
        self._kind = kind
        self._attrs = attrs

    def __enter__(self) -> Span:
        self._span = self._tracer.begin(self._kind, **(self._attrs or {}))
        # disabled tracer: skip the contextvar set/reset entirely
        self._token = (None if self._span is NOOP_SPAN
                       else _CURRENT.set(self._span))
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
        self._span.end()
        return False


class _AttachCtx:
    """Context manager: make an existing span the task-local current
    span (explicit handoff) without starting or ending anything."""

    __slots__ = ("_span", "_token")

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        self._token = _CURRENT.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        _CURRENT.reset(self._token)
        return False


# ---------------------------------------------------------------- tracer

DEFAULT_CAPACITY = int(os.environ.get("TM_TPU_TRACE_CAPACITY", "16384"))


class Tracer:
    """Ring-buffered span recorder. Thread-safe by construction: the
    only shared mutation is deque.append / popleft-on-overflow, both
    atomic under the GIL; snapshots copy the ring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)
        self._dropped = 0
        # tracing→metrics bridge: fn(kind, seconds) called on every
        # span close (libs/metrics.py installs span_metrics_sink on
        # the global TRACER). None = no bridge (private test tracers).
        self.metrics_sink = None
        # eviction bridge: fn(n) on every ring overflow — feeds
        # tracing_spans_dropped_total. Same None-means-no-bridge rule.
        self.drop_sink = None

    def set_metrics_sink(self, sink) -> None:
        self.metrics_sink = sink

    def set_drop_sink(self, sink) -> None:
        self.drop_sink = sink

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring since the last clear() — a
        non-zero value means snapshot() is a suffix, not the history."""
        return self._dropped

    # -- recording --

    def begin(self, kind: str, parent: Span | None = None, **attrs) -> Span:
        """Start a span. Parent defaults to the task-local current
        span; pass `parent=` to link manually-managed spans (the
        consensus height/step timeline). Returns NOOP_SPAN when
        disabled — callers never branch."""
        if not self.enabled:
            return NOOP_SPAN
        if kind not in _KINDS:
            raise ValueError(f"unregistered span kind {kind!r} "
                             "(register_kind)")
        if parent is None:
            parent = _CURRENT.get()
        return Span(self, kind, parent.span_id if parent else 0,
                    attrs or None)

    def span(self, kind: str, **attrs) -> _SpanCtx:
        """`with TRACER.span(KIND, k=v): ...` — the instrumented-site
        form. Nested spans parent automatically via the task context."""
        return _SpanCtx(self, kind, attrs)

    def current(self) -> Span | None:
        return _CURRENT.get()

    def attach(self, span: Span | None) -> _AttachCtx:
        """Make `span` current for a block — used to hang with-block
        children under a manually-managed span (e.g. the commit step
        span during finalize) regardless of which task runs the code."""
        return _AttachCtx(span)

    def wrap(self, fn):
        """Explicit executor handoff: capture the caller's active span
        and launch-ledger workload tag NOW; the returned callable
        re-activates both in whatever thread runs fn.
        `loop.run_in_executor(None, TRACER.wrap(f), *a)`."""
        parent = _CURRENT.get()
        tag = _workload_of()

        def _with_parent(*args, **kwargs):
            token = _CURRENT.set(parent)
            wtoken = _set_workload(tag)
            try:
                return fn(*args, **kwargs)
            finally:
                _reset_workload(wtoken)
                _CURRENT.reset(token)

        return _with_parent

    # -- reading --

    def clear(self) -> None:
        self._ring.clear()
        self._dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self, seconds: float | None = None) -> list[tuple]:
        """Finished spans, oldest first; `seconds` keeps only spans
        that ENDED within the trailing window."""
        recs = list(self._ring)
        if seconds is None:
            return recs
        cutoff = time.perf_counter_ns() - int(seconds * 1e9)
        return [r for r in recs if r[4] + r[5] >= cutoff]

    def stage_rollup(self, seconds: float | None = None,
                     prefix: str | None = None) -> dict[str, dict]:
        """Per-kind latency rollup {kind: {count, p50_ms, p95_ms,
        p99_ms, total_ms}} over the ring (optionally windowed /
        prefix-filtered)."""
        by_kind: dict[str, list[int]] = {}
        for r in self.snapshot(seconds):
            if prefix is not None and not r[0].startswith(prefix):
                continue
            by_kind.setdefault(r[0], []).append(r[5])
        out: dict[str, dict] = {}
        for kind, durs in sorted(by_kind.items()):
            durs.sort()
            n = len(durs)

            def pct(p):
                return durs[min(n - 1, int(p * n))] / 1e6

            out[kind] = {
                "count": n,
                "p50_ms": round(pct(0.50), 4),
                "p95_ms": round(pct(0.95), 4),
                "p99_ms": round(pct(0.99), 4),
                "total_ms": round(sum(durs) / 1e6, 4),
            }
        return out


# Process-global tracer — the instrument every module records into.
TRACER = Tracer()


# ---------------------------------------------------------------- origin tags
#
# Cross-node trace context. A compact binary tag rides the consensus
# wire messages that define the block lifecycle (Proposal, BlockPart,
# Vote): the sender stamps (height, round, its node label, the span id
# active at send time), the receiver rehydrates the tag into the attrs
# of its live p2p.recv_msg span. A part's recv span on node B thus
# names its send span on node A — zero new hot-path span sites, and
# peers that never set the field are untouched (the wire field is
# optional; old decoders skip it as an unknown proto field).

_ORIGIN_VERSION = 1
_ORIGIN_HDR = struct.Struct(">BQIQ")  # version, height, round, span_id
_ORIGIN_MAX_NODE = 64  # label bytes cap: tags stay wire-cheap


class OriginTag(NamedTuple):
    height: int
    round: int
    node: str
    span_id: int


def encode_origin(height: int, round_: int, node: str,
                  span_id: int = 0) -> bytes:
    """Binary origin tag: 21-byte fixed header + UTF-8 node label
    (truncated to 64 bytes). Total ≤ 85 bytes per stamped message."""
    label = node.encode("utf-8", "replace")[:_ORIGIN_MAX_NODE]
    return _ORIGIN_HDR.pack(
        _ORIGIN_VERSION, height & (2**64 - 1), round_ & (2**32 - 1),
        span_id & (2**64 - 1)) + label


def decode_origin(data: bytes | None) -> OriginTag | None:
    """Parse an origin tag; never raises. None on absent/short/
    unknown-version payloads — a garbled tag degrades to 'no tag',
    it must not take down message decode."""
    if not data or len(data) < _ORIGIN_HDR.size:
        return None
    try:
        ver, height, round_, span_id = _ORIGIN_HDR.unpack_from(data)
        if ver != _ORIGIN_VERSION:
            return None
        node = data[_ORIGIN_HDR.size:].decode("utf-8", "replace")
        return OriginTag(height, round_, node, span_id)
    except Exception:
        return None


def origin_stamp(node: str, height: int, round_: int) -> bytes:
    """Send-side: build the tag for an outgoing lifecycle message,
    capturing the task-local active span (0 if none — the node/height/
    round triple still carries the cross-node link)."""
    cur = _CURRENT.get()
    return encode_origin(height, round_, node,
                         cur.span_id if cur is not None else 0)


def rehydrate_origin(data: bytes | None) -> OriginTag | None:
    """Recv-side: decode an incoming tag and fold it into the attrs of
    the live current span (the p2p.recv_msg span wrapping reactor
    dispatch), linking this receive to the sender's send-side span."""
    tag = decode_origin(data)
    if tag is None:
        return None
    cur = _CURRENT.get()
    if cur is not None:
        cur.set_attr("origin_node", tag.node)
        cur.set_attr("origin_height", tag.height)
        cur.set_attr("origin_round", tag.round)
        if tag.span_id:
            cur.set_attr("origin_span", tag.span_id)
    return tag


# ---------------------------------------------------------------- export

_PID = os.getpid()


def chrome_trace(records: list[tuple], meta: dict | None = None) -> dict:
    """Chrome trace-event JSON (the `traceEvents` array object form)
    from snapshot() tuples: one "X" (complete) event per span, ts/dur
    in microseconds, parent links + attributes under args. Loads
    directly in Perfetto / chrome://tracing; nesting renders from
    ts/dur containment per (pid, tid) track, and args.parent_id gives
    exact cross-thread lineage. `meta` (ring capacity, drop counter,
    clock anchor...) lands under a top-level "tm_tpu" key — viewers
    ignore unknown top-level keys, collectors read it."""
    events = []
    for kind, span_id, parent_id, tid, t0, dur, attrs in records:
        args = {"span_id": span_id}
        if parent_id:
            args["parent_id"] = parent_id
        if attrs:
            args.update(attrs)
        events.append({
            "name": kind,
            "cat": kind.partition(".")[0],
            "ph": "X",
            "ts": t0 / 1e3,
            "dur": dur / 1e3,
            "pid": _PID,
            "tid": tid,
            "args": args,
        })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta is not None:
        out["tm_tpu"] = meta
    return out
