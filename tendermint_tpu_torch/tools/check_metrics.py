"""Metrics-catalog lint over the port (reference: the repository's root
tools/check_metrics.py; run as ``python -m
tendermint_tpu_torch.tools.check_metrics`` or from
tests/test_torch_lints.py).

Keeps the Prometheus surface honest as instrumentation spreads:

1. Every metric registered in the process-global registry belongs to a
   per-module Metrics dataclass (libs/metrics.py) — no ad-hoc
   DEFAULT.counter(...) calls minting families outside the declared
   catalog.
2. Names and namespaces follow the reference convention:
   `<namespace>_<snake_case_name>`, namespace from the known module
   set, counters ending in `_total` or a documented legacy name.
3. Help text is non-empty (the exposition output is the docs for
   whoever scrapes it).
4. The docs table (docs/OBSERVABILITY.md "Metrics catalog") stays in
   sync: every registered metric appears in the table and every table
   row names a real metric.

The port declares the reference's families under the reference's
names (the `tpu` namespace included: the families a GPU's launches
feed keep it, so a dashboard reads either package), so the docs table
is the reference's docs/OBSERVABILITY.md, read and never edited.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOCS = os.path.join(REPO, "docs", "OBSERVABILITY.md")

# The per-module namespaces libs/metrics.py declares. `crypto` and
# `tpu` are this framework's additions; the rest mirror the reference
# docs/nodes/metrics.md module list.
NAMESPACES = {
    "consensus", "crypto", "p2p", "mempool", "admission", "light",
    "speculation", "blockchain", "statesync", "evidence", "state",
    "abci", "tpu", "tracing", "failpoint", "rpc", "overload",
    "recovery",
}

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Launch-ledger / silicon-watchdog families the observability contract
# depends on (crypto/cuda/{ledger,watchdog}.py feed them; the /status
# device check and docs/OBSERVABILITY.md state table read them): a
# refactor must not silently drop any from the catalog.
REQUIRED = {
    "tpu_effective_backend",
    "tpu_launch_ledger_records_total",
    "tpu_launch_ledger_evictions_total",
    "tpu_hbm_resident_bytes",
    # mesh self-healing (per-device breakers + live reshard): the
    # /status device check, the mesh degradation runbook and
    # bench_trend's degraded-round separation read these
    "tpu_device_breaker_state",
    "tpu_mesh_evictions_total",
    "tpu_reshard_seconds",
    "tpu_mesh_active_devices",
}


def collect_problems() -> list[str]:
    """All lint findings, empty means clean."""
    from ..libs.metrics import DEFAULT, all_module_metrics

    problems: list[str] = []
    declared = all_module_metrics()

    # 1. registry <-> dataclass ownership (by object identity). Extra
    # metrics registered by tests into DEFAULT are tolerated only if
    # they live outside the product namespaces.
    declared_ids = {id(m) for m in declared.values()}
    with DEFAULT._lock:
        registered = list(DEFAULT._metrics)
    seen_names: set[str] = set()
    for m in registered:
        ns = m.name.partition("_")[0]
        if id(m) not in declared_ids and ns in NAMESPACES:
            problems.append(
                f"{m.name}: registered in DEFAULT but not declared in "
                "any per-module Metrics dataclass (libs/metrics.py)")
        if ns in NAMESPACES:
            if m.name in seen_names:
                problems.append(f"{m.name}: duplicate registration")
            seen_names.add(m.name)

    # 2. naming conventions + 3. help text.
    for name, m in declared.items():
        if not _NAME_RE.match(name):
            problems.append(f"{name}: not snake_case")
        if m.namespace not in NAMESPACES:
            problems.append(
                f"{name}: namespace {m.namespace!r} not in the known "
                f"module set {sorted(NAMESPACES)}")
        elif not name.startswith(m.namespace + "_"):
            problems.append(
                f"{name}: name does not start with its namespace "
                f"{m.namespace!r}")
        if not (m.help or "").strip():
            problems.append(f"{name}: empty help text")

    # 4. required families (ledger/watchdog observability contract).
    for name in sorted(REQUIRED - set(declared)):
        problems.append(
            f"{name}: required launch-ledger/watchdog metric missing "
            "from the declared catalog")

    # 5. docs table sync.
    problems.extend(check_docs_table(set(declared)))
    return problems


def docs_table_names(path: str = DOCS) -> set[str]:
    """Metric names from the docs catalog table: rows of the form
    `| \\`name\\` | type | ...` between the catalog heading and the
    next heading."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## Metrics catalog$(.*?)(?=^## )", text,
                  re.M | re.S)
    if m is None:
        return set()
    return set(re.findall(r"^\|\s*`([a-z0-9_]+)`\s*\|", m.group(1), re.M))


def check_docs_table(declared: set[str]) -> list[str]:
    problems = []
    if not os.path.exists(DOCS):
        return [f"{DOCS}: missing"]
    documented = docs_table_names()
    if not documented:
        return ["docs/OBSERVABILITY.md: no '## Metrics catalog' table "
                "found"]
    for name in sorted(declared - documented):
        problems.append(
            f"{name}: declared in libs/metrics.py but missing from the "
            "docs/OBSERVABILITY.md catalog table")
    for name in sorted(documented - declared):
        problems.append(
            f"{name}: listed in docs/OBSERVABILITY.md but not declared "
            "in libs/metrics.py")
    return problems


def main() -> int:
    problems = collect_problems()
    for p in problems:
        print(f"LINT: {p}")
    from ..libs.metrics import all_module_metrics

    print(f"{len(all_module_metrics())} metrics declared across "
          f"{len(NAMESPACES)} namespaces")
    print("OK" if not problems else "FAILED")
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
