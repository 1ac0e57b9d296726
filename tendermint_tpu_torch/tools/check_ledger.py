"""Launch-ledger lint + overhead budget over the port (reference: the
repository's root tools/check_ledger.py; run as ``python -m
tendermint_tpu_torch.tools.check_ledger`` or from
tests/test_torch_lints.py).

The ledger's value is TOTALITY — "every device dispatch site emits one
record" is only true while something enforces it. Four checks:

1. Every known dispatch site still records. The DISPATCH_SITES catalog
   pins (file, qualified function) pairs that launch device kernels;
   each must contain a `ledger.launch(...)` / `ledger.begin(...)` /
   `ledger.record(...)` / `ledger.group(...)` call (a LaunchGroup adds
   one record a kernel launch). A new verify path added without ledger
   instrumentation shows up here the moment someone adds it to the
   catalog — and the reverse check makes forgetting the catalog loud:
   any such call site under crypto/cuda/ NOT in the catalog is
   flagged, so the catalog and reality can't drift apart.
2. Workload tags are a closed set. Every `workload("tag")` literal in
   the port (and chip_smoke.py, whose timing runs carry `bench`) names
   an entry in ledger.WORKLOADS, and every non-default tag has at
   least one call site — a plane whose tag nothing sets would silently
   report as `consensus`.
3. Docs stay honest: the ledger's document has the "Launch ledger &
   silicon watchdog" section and names every workload tag; every
   catalog dispatch site is exercised by name in tests/test_torch_*.py.
4. Recording overhead stays bounded. The ledger is ALWAYS ON, so one
   disarmed record (build + ring append, no consumers reading) is
   budgeted against the SAME per-event ceiling as an enabled span
   (tools/check_spans.py ENABLED_BUDGET_S) — a launch is milliseconds,
   its record must stay microseconds.

The ledger's document is docs/OBSERVABILITY.md (read, never edited):
the port's ledger (crypto/cuda/ledger.py) keeps the reference's record
and workload tags, stamping `gpu` for the card, and has no document of
its own. The table build (K1) and the arena's splice and clear (K6,
K8's) record no launch in either package — the verify launch they feed
does — so they are not dispatch sites; their wrappers count their
launches (`.launches`).
"""

from __future__ import annotations

import ast
import os
import re
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TESTS = os.path.join(REPO, "tests")
DOCS = os.path.join(REPO, "docs", "OBSERVABILITY.md")
DOCS_HEADING = "## Launch ledger & silicon watchdog"

# Every function that dispatches a verify kernel: K4 (verify_batch),
# K3 and K5 (_traced_verify, both forms), K7 (ResidentArena.launch),
# K8's verify (MeshResidentArena.launch) and K9 (verify_batch_sr).
# Adding a dispatch path? Add it here AND make it record — the suite
# fails on either half alone.
DISPATCH_SITES = {
    ("tendermint_tpu_torch/crypto/cuda/verify.py", "verify_batch"),
    ("tendermint_tpu_torch/crypto/cuda/expanded.py",
     "ExpandedKeys._traced_verify"),
    ("tendermint_tpu_torch/crypto/cuda/resident.py",
     "ResidentArena.launch"),
    ("tendermint_tpu_torch/crypto/cuda/resident.py",
     "MeshResidentArena.launch"),
    ("tendermint_tpu_torch/crypto/cuda/sr_verify.py", "verify_batch_sr"),
}

_RECORD_METHODS = {"launch", "begin", "record", "group"}
_LEDGER_MODULE = "tendermint_tpu_torch/crypto/cuda/ledger.py"
# the record the overhead microbench opens (a name, not a literal: the
# span lint reads any `.begin(<literal>)` as a span site)
_BENCH_KERNEL = "general"


def _qualnames_calling_ledger(path: str) -> dict[str, list[int]]:
    """{qualified function name: [lines]} of ledger.launch/begin/record
    calls in one file (attribute calls on a name containing 'ledger')."""
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=path)
    out: dict[str, list[int]] = {}

    def walk(node, stack):
        for ch in ast.iter_child_nodes(node):
            nstack = stack
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                nstack = stack + [ch.name]
            elif isinstance(ch, ast.Call):
                f = ch.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _RECORD_METHODS
                        and isinstance(f.value, ast.Name)
                        and "ledger" in f.value.id):
                    out.setdefault(".".join(stack) or "<module>",
                                   []).append(ch.lineno)
            walk(ch, nstack)

    walk(tree, [])
    return out


def check_dispatch_sites() -> list[str]:
    problems = []
    by_file: dict[str, dict[str, list[int]]] = {}
    for rel, qual in sorted(DISPATCH_SITES):
        path = os.path.join(REPO, rel)
        if rel not in by_file:
            if not os.path.exists(path):
                problems.append(f"{rel}: cataloged dispatch file missing")
                by_file[rel] = {}
                continue
            by_file[rel] = _qualnames_calling_ledger(path)
        if qual not in by_file[rel]:
            problems.append(
                f"{rel}: {qual} is a cataloged dispatch site but makes "
                "no ledger.launch/begin/record call — this launch path "
                "is invisible to cost attribution")
    # reverse: un-cataloged recording sites under crypto/cuda (the
    # ledger module itself is exempt)
    cuda_dir = os.path.join(PKG, "crypto", "cuda")
    for fn in sorted(os.listdir(cuda_dir)):
        if not fn.endswith(".py"):
            continue
        rel = f"tendermint_tpu_torch/crypto/cuda/{fn}"
        if rel == _LEDGER_MODULE:
            continue
        calls = by_file.get(rel)
        if calls is None:
            calls = _qualnames_calling_ledger(os.path.join(REPO, rel))
        cataloged = {q for r, q in DISPATCH_SITES if r == rel}
        for qual in sorted(set(calls) - cataloged):
            problems.append(
                f"{rel}: {qual} records launches but is not in the "
                "tools/check_ledger.py DISPATCH_SITES catalog")
    return problems


def workload_call_sites() -> dict[str, list[str]]:
    """{tag: ["relpath:line", ...]} over every `workload("tag")` call
    with a string-literal argument, across tendermint_tpu_torch/ and
    chip_smoke.py."""
    roots = [PKG, os.path.join(REPO, "chip_smoke.py")]
    out: dict[str, list[str]] = {}
    paths = []
    for root in roots:
        if os.path.isfile(root):
            paths.append(root)
            continue
        for dirpath, _dn, filenames in os.walk(root):
            paths += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                      if fn.endswith(".py")]
    for path in paths:
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if rel == _LEDGER_MODULE:
            continue
        with open(path, "rb") as f:
            try:
                tree = ast.parse(f.read(), filename=rel)
            except SyntaxError:  # pragma: no cover
                continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name != "workload":
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and \
                    isinstance(first.value, str):
                out.setdefault(first.value, []).append(
                    f"{rel}:{node.lineno}")
    return out


def check_workloads() -> list[str]:
    from ..crypto.cuda.ledger import WORKLOADS

    problems = []
    sites = workload_call_sites()
    for tag, where in sorted(sites.items()):
        if tag not in WORKLOADS:
            problems.append(
                f"{tag}: workload() call site(s) {where} use an "
                "unregistered tag (ledger.WORKLOADS is a closed set)")
    default = "consensus"  # the contextvar default needs no call site
    for tag in sorted(set(WORKLOADS) - set(sites) - {default}):
        problems.append(
            f"{tag}: registered workload tag with no workload() call "
            "site — that plane's launches report as the default")
    return problems


def docs_section(path: str = DOCS) -> str | None:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(rf"^{re.escape(DOCS_HEADING)}$(.*?)(?=^## )", text,
                  re.M | re.S)
    return m.group(1) if m else None


def check_docs_and_tests() -> list[str]:
    from ..crypto.cuda.ledger import WORKLOADS

    problems = []
    section = docs_section()
    if section is None:
        return [f"docs/OBSERVABILITY.md: no '{DOCS_HEADING}' section"]
    for tag in WORKLOADS:
        if tag not in section:
            problems.append(
                f"{tag}: workload tag undocumented in the "
                f"docs/OBSERVABILITY.md '{DOCS_HEADING}' section")
    # every cataloged dispatch function is exercised by name in the
    # port's tests
    names = {qual.rsplit(".", 1)[-1] if "." in qual else qual
             for _rel, qual in DISPATCH_SITES}
    found: set[str] = set()
    for dirpath, _dn, filenames in os.walk(TESTS):
        for fn in sorted(filenames):
            if not (fn.startswith("test_torch_") and fn.endswith(".py")):
                continue
            try:
                text = open(os.path.join(dirpath, fn),
                            encoding="utf-8").read()
            except OSError:  # pragma: no cover
                continue
            found |= {n for n in names if n in text}
    for n in sorted(names - found):
        problems.append(
            f"{n}: cataloged dispatch site not exercised (or even "
            "named) by any tests/test_torch_*.py file")
    return problems


def measure_overhead(n: int = 20000) -> float:
    """Seconds per disarmed record: begin -> fill the hot-path fields
    -> done() (ring append + metric inc), nobody reading. Best-of-3
    batches, same convention as tools/check_spans.py."""
    from ..crypto.cuda import ledger

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n):
            rec = ledger.begin(_BENCH_KERNEL)
            rec.lanes = i
            rec.capacity = 1024
            rec.bytes_h2d = 4096
            rec.verdict = "ok"
            rec.device = "cuda:0"
            rec.done()
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def collect_problems() -> list[str]:
    return (check_dispatch_sites() + check_workloads()
            + check_docs_and_tests())


def main() -> int:
    problems = collect_problems()
    for p in problems:
        print(f"LINT: {p}")
    # budget shared with the span tracer: one always-on record per
    # launch must cost no more than one enabled span
    from .check_spans import ENABLED_BUDGET_S

    per = measure_overhead()
    print(f"ledger overhead: {per * 1e6:.2f} us per disarmed record "
          f"(budget {ENABLED_BUDGET_S * 1e6:.0f})")
    ok = not problems
    if per > ENABLED_BUDGET_S:
        print("FAIL: per-record ledger overhead over budget")
        ok = False
    print(f"{len(DISPATCH_SITES)} dispatch sites cataloged; "
          f"{sum(len(v) for v in workload_call_sites().values())} "
          "workload tag sites")
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
