"""Crash-recovery coverage lint over the port (reference: the
repository's root tools/check_recovery.py, the same four rules; run as
``python -m tendermint_tpu_torch.tools.check_recovery`` or from
tests/test_torch_e2e_tools.py).

Keeps the durability story honest as the commit pipeline grows:

1. Every libs/failpoints.py COMMIT_PIPELINE point is a registered
   catalog entry and has a crash spec in tools/crash_sweep.py
   SWEEP_SPECS — and the sweep carries no spec for a point that left
   the pipeline.
2. Every commit-pipeline point appears in the docs/CHAOS.md
   "Crash-recovery runbook" table (the persistence-order table IS the
   operator contract), and every table row names a real point.
3. Every consensus/replay.py REPAIR_KINDS repair is documented in the
   runbook's repairs table, every documented repair is a real kind,
   and every kind is actually produced by a record() call site.
4. Every commit-pipeline point is exercised by name from the port's
   tests (tests/test_torch_*.py).

The catalog and the repairs are the reference's, name for name, so the
runbook is the reference's docs/CHAOS.md, read and never edited.
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TESTS = os.path.join(REPO, "tests")
DOCS = os.path.join(REPO, "docs", "CHAOS.md")


def _runbook_section(path: str | None = None) -> str:
    path = path or DOCS
    if not os.path.exists(path):
        return ""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## Crash-recovery runbook$(.*?)(?=^## |\Z)", text,
                  re.M | re.S)
    return m.group(1) if m else ""


def _table_names(section: str) -> set[str]:
    """First-column backticked names from every markdown table row."""
    return set(re.findall(r"^\|\s*`([a-z0-9_.]+)`\s*\|", section, re.M))


def _tests_mentioning(names: set[str]) -> set[str]:
    found: set[str] = set()
    for fn in sorted(os.listdir(TESTS)):
        if not (fn.startswith("test_torch_") and fn.endswith(".py")):
            continue
        try:
            text = open(os.path.join(TESTS, fn), encoding="utf-8").read()
        except OSError:  # pragma: no cover
            continue
        for n in names - found:
            if n in text:
                found.add(n)
    return found


def collect_problems() -> list[str]:
    from ..consensus.replay import REPAIR_KINDS
    from ..libs.failpoints import BY_NAME, COMMIT_PIPELINE
    from . import crash_sweep

    problems: list[str] = []
    pipeline = set(COMMIT_PIPELINE)

    # 1. pipeline <-> catalog <-> sweep specs
    for name in sorted(pipeline - set(BY_NAME)):
        problems.append(
            f"{name}: in COMMIT_PIPELINE but not a registered failpoint")
    for name in sorted(pipeline - set(crash_sweep.SWEEP_SPECS)):
        problems.append(
            f"{name}: commit-pipeline point with no crash spec in "
            "tools/crash_sweep.py SWEEP_SPECS")
    for name in sorted(set(crash_sweep.SWEEP_SPECS) - pipeline):
        problems.append(
            f"{name}: swept by tools/crash_sweep.py but not in "
            "COMMIT_PIPELINE")

    # 2 + 3. docs runbook tables
    section = _runbook_section()
    if not section:
        problems.append(
            "docs/CHAOS.md: no '## Crash-recovery runbook' section")
    else:
        documented = _table_names(section)
        for name in sorted(pipeline - documented):
            problems.append(
                f"{name}: commit-pipeline point missing from the "
                "docs/CHAOS.md runbook table")
        for name in sorted(set(REPAIR_KINDS) - documented):
            problems.append(
                f"{name}: repair kind missing from the docs/CHAOS.md "
                "runbook repairs table")
        for name in sorted(documented - pipeline - set(REPAIR_KINDS)):
            problems.append(
                f"{name}: named in the docs/CHAOS.md runbook tables "
                "but neither a commit-pipeline point nor a repair kind")

    # 3b. every repair kind is actually produced somewhere
    replay_src = open(os.path.join(PKG, "consensus", "replay.py"),
                      encoding="utf-8").read()
    produced = set(re.findall(r"record\(\s*\n?\s*\"([a-z_]+)\"",
                              replay_src))
    for kind in sorted(set(REPAIR_KINDS) - produced):
        problems.append(
            f"{kind}: repair kind declared but no record() call site "
            "in consensus/replay.py produces it")

    # 4. the port's tests name every pipeline point
    tested = _tests_mentioning(pipeline)
    for name in sorted(pipeline - tested):
        problems.append(
            f"{name}: commit-pipeline point not exercised (or even "
            "named) by any tests/test_torch_*.py file")
    return problems


def main() -> int:
    problems = collect_problems()
    for p in problems:
        print(f"LINT: {p}")
    from ..libs.failpoints import COMMIT_PIPELINE

    print(f"{len(COMMIT_PIPELINE)} commit-pipeline crash points swept")
    print("OK" if not problems else "FAILED")
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
