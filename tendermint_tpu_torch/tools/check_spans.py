"""Span-tracing lint + overhead budget over the port (reference: the
repository's root tools/check_spans.py; run as ``python -m
tendermint_tpu_torch.tools.check_spans`` or from
tests/test_torch_lints.py).

Two checks keep the tracer honest as instrumentation spreads:

1. No ad-hoc span strings. Every `TRACER.span(...)` / `TRACER.begin(...)`
   call site in tendermint_tpu_torch/ must name a registered constant
   from libs/tracing.py, never a string literal — the registry is what makes
   `/debug/trace` rollups and the BENCH stage_breakdown enumerable, and
   a typo'd literal would otherwise mint a new timeline row silently.
   (The tracer also rejects unregistered kinds at runtime; this lint
   catches the literal-at-call-site pattern statically so the failure
   is a test run, not a production span.)

2. Overhead stays bounded. Tracing is ALWAYS ON in production, so the
   per-span cost is a hard budget, not a vibe: a microbench times
   enter/exit of an attribute-carrying span with the tracer enabled and
   disabled and asserts both against fixed per-span ceilings. The
   ceilings are deliberately loose (single-core CI box, GC noise) —
   they exist to catch an accidental O(ring) scan or allocation storm
   in the span path, not to benchmark it.

The lint walks the port's own tree, this module included (its
microbench passes a registered constant). The rule is the reference's:
any `.span(<literal>)` or `.begin(<literal>)` call is a span site, so
a launch-ledger ``begin`` must name its kernel through a variable too.
"""

from __future__ import annotations

import ast
import os
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

# Per-span ceilings (seconds), the reference's: they leave ~10x
# headroom over a span's cost, so only a real regression (per-span
# allocation storm, O(ring) work) trips them.
ENABLED_BUDGET_S = 50e-6
DISABLED_BUDGET_S = 10e-6

_SPAN_METHODS = {"span", "begin"}

# Stage-taxonomy kinds the rollup/export surfaces (BENCH
# stage_breakdown, /debug/trace/rollup, the tracer-pinned acceptance
# tests) depend on BY NAME: renaming or dropping one silently empties
# a dashboard row, so their registration is linted, not assumed.
REQUIRED_KINDS = frozenset({
    "consensus.height", "consensus.propose", "consensus.commit",
    "consensus.vote_batch",
    "crypto.batch", "crypto.verify", "crypto.pack", "crypto.dispatch",
    "crypto.device_exec", "crypto.readback", "crypto.host_verify",
    "speculation.speculate", "speculation.patch",
    "speculation.reconcile",
    "state.apply_block", "wal.fsync",
    # height forensics reads these two by name: recv spans carry the
    # rehydrated origin tags, send_flush is the wire-side counterpart
    "p2p.recv_msg", "p2p.send_flush",
})


def missing_required_kinds() -> list[str]:
    """REQUIRED_KINDS entries absent from the live registry (empty =
    clean). Imported lazily so the lint half stays import-free."""
    from ..libs import tracing

    return sorted(REQUIRED_KINDS - tracing.registered_kinds())


def find_ad_hoc_spans(root: str = PKG) -> list[str]:
    """Call sites passing a string LITERAL as the span kind. Returns
    ["path:line: message", ...] (paths relative to the repository);
    empty means clean. libs/tracing.py itself is exempt —
    register_kind() literals are the registry."""
    problems = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, REPO)
            if rel.replace(os.sep, "/") == \
                    "tendermint_tpu_torch/libs/tracing.py":
                continue
            with open(path, "rb") as f:
                try:
                    tree = ast.parse(f.read(), filename=rel)
                except SyntaxError as e:  # pragma: no cover
                    problems.append(f"{rel}: unparseable: {e}")
                    continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fobj = node.func
                if not (isinstance(fobj, ast.Attribute)
                        and fobj.attr in _SPAN_METHODS):
                    continue
                if not node.args:
                    continue
                first = node.args[0]
                if isinstance(first, ast.Constant) and \
                        isinstance(first.value, str):
                    problems.append(
                        f"{rel}:{node.lineno}: ad-hoc span kind "
                        f"{first.value!r} — use a registered constant "
                        "from libs.tracing")
                elif isinstance(first, ast.JoinedStr):
                    problems.append(
                        f"{rel}:{node.lineno}: f-string span kind — "
                        "kinds are a closed registry, not a format "
                        "namespace")
    return problems


# The three consensus wire messages that carry a cross-node origin tag
# (libs/tracing.py encode_origin; consensus/messages.py field 15).
_LIFECYCLE_MSGS = {"ProposalMessage", "BlockPartMessage", "VoteMessage"}


def find_origin_parity_problems() -> list[str]:
    """Send-side stamp <-> recv-side rehydrate parity lint for the
    consensus reactor (the module that owns every lifecycle send):

      * every `encode_consensus_msg(<LifecycleMessage>(...))` call
        outside the `_stamped` helper is a problem — a raw encode of a
        freshly-constructed lifecycle message ships WITHOUT an origin
        tag and its recv span on the far node dangles;
      * `_stamped` itself must call tracing.origin_stamp;
      * `receive` must call tracing.rehydrate_origin.

    Empty list = clean."""
    path = os.path.join(PKG, "consensus", "reactor.py")
    rel = os.path.relpath(path, REPO)
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=rel)

    problems = []
    reactor = next(
        (n for n in tree.body
         if isinstance(n, ast.ClassDef) and n.name == "ConsensusReactor"),
        None)
    if reactor is None:
        return [f"{rel}: ConsensusReactor class not found"]

    def calls_named(fn: ast.AST, name: str) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == name) or \
                        (isinstance(f, ast.Name) and f.id == name):
                    return True
        return False

    methods = {n.name: n for n in reactor.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    stamped = methods.get("_stamped")
    if stamped is None:
        problems.append(f"{rel}: ConsensusReactor._stamped missing")
    elif not calls_named(stamped, "origin_stamp"):
        problems.append(
            f"{rel}:{stamped.lineno}: _stamped does not call "
            "tracing.origin_stamp")
    recv = methods.get("receive")
    if recv is None:
        problems.append(f"{rel}: ConsensusReactor.receive missing")
    elif not calls_named(recv, "rehydrate_origin"):
        problems.append(
            f"{rel}:{recv.lineno}: receive does not call "
            "tracing.rehydrate_origin")

    for name, fn in methods.items():
        if name == "_stamped":
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            is_encode = (isinstance(f, ast.Attribute)
                         and f.attr == "encode_consensus_msg") or \
                (isinstance(f, ast.Name) and f.id == "encode_consensus_msg")
            if not is_encode or not node.args:
                continue
            arg = node.args[0]
            if not isinstance(arg, ast.Call):
                continue
            cf = arg.func
            cls = cf.attr if isinstance(cf, ast.Attribute) else \
                cf.id if isinstance(cf, ast.Name) else ""
            if cls in _LIFECYCLE_MSGS:
                problems.append(
                    f"{rel}:{node.lineno}: {name} encodes {cls} without "
                    "an origin stamp — route it through self._stamped")
    return problems


def measure_overhead(n: int = 20000) -> tuple[float, float]:
    """(enabled_s_per_span, disabled_s_per_span) for an enter/exit of
    an attribute-carrying span on a private tracer. Best-of-3 batches:
    the budget polices the span path, not the box's scheduler.

    The enabled tracer carries the REAL tracing→metrics bridge sink
    (libs/metrics.py span_metrics_sink), so the budget covers the full
    production span close: ring append + histogram observe."""
    from ..libs import metrics, tracing

    kind = tracing.CRYPTO_PACK  # a real registered hot-path kind

    def run(tracer: tracing.Tracer) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n):
                with tracer.span(kind, lanes=i):
                    pass
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    bridged = tracing.Tracer(capacity=4096, enabled=True)
    bridged.set_metrics_sink(metrics.span_metrics_sink)
    enabled = run(bridged)
    disabled = run(tracing.Tracer(capacity=4096, enabled=False))
    return enabled, disabled


def main() -> int:
    problems = find_ad_hoc_spans()
    problems += find_origin_parity_problems()
    problems += [f"required span kind {k!r} not registered "
                 "(libs/tracing.py)" for k in missing_required_kinds()]
    for p in problems:
        print(f"LINT: {p}")
    enabled, disabled = measure_overhead()
    print(f"span overhead: enabled {enabled * 1e6:.2f} us "
          f"(budget {ENABLED_BUDGET_S * 1e6:.0f}), "
          f"disabled {disabled * 1e6:.2f} us "
          f"(budget {DISABLED_BUDGET_S * 1e6:.0f})")
    ok = not problems
    if enabled > ENABLED_BUDGET_S:
        print("FAIL: enabled per-span overhead over budget")
        ok = False
    if disabled > DISABLED_BUDGET_S:
        print("FAIL: disabled per-span overhead over budget")
        ok = False
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
