"""Scenario-factory lint over the port (reference: the repository's root
tools/check_scenarios.py; run as ``python -m
tendermint_tpu_torch.tools.check_scenarios`` or from
tests/test_torch_lints.py).

Keeps the simulation surface honest as scenarios and byzantine kinds
spread:

1. Every BYZANTINE_KINDS entry is documented in the docs/CHAOS.md
   "Byzantine catalog" table, and every table row names a registered
   kind.
2. Every byzantine kind is USED by at least one named scenario in
   sim/scenario.py SCENARIOS — a catalog entry no scenario can reach
   is dead documentation.
3. Every byzantine kind is named by at least one of the port's test
   files (tests/test_torch_*.py).
4. Every named scenario validates (Scenario.validate()) and carries a
   known tier.
5. Every INVARIANTS entry is documented in the docs/CHAOS.md
   "Scenario invariants" table, and every table row names a real
   invariant.

The catalog is the reference's, kind for kind and invariant for
invariant, so the tables are the reference's docs/CHAOS.md, read and
never edited.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TESTS = os.path.join(REPO, "tests")
DOCS = os.path.join(REPO, "docs", "CHAOS.md")


def _docs_table(section: str, path: str = DOCS) -> set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(rf"^##+ {re.escape(section)}$(.*?)(?=^##+ |\Z)", text,
                  re.M | re.S)
    if m is None:
        return set()
    return set(re.findall(r"^\|\s*`([a-z0-9_]+)`\s*\|", m.group(1), re.M))


def _tests_mentioning(names: set[str], root: str = TESTS) -> set[str]:
    found: set[str] = set()
    for dirpath, _d, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not (fn.startswith("test_torch_") and fn.endswith(".py")):
                continue
            try:
                text = open(os.path.join(dirpath, fn),
                            encoding="utf-8").read()
            except OSError:  # pragma: no cover
                continue
            for n in names - found:
                if n in text:
                    found.add(n)
    return found


def collect_problems() -> list[str]:
    from ..sim.byzantine import BYZANTINE_KINDS
    from ..sim.scenario import INVARIANTS, SCENARIOS

    problems: list[str] = []
    kinds = set(BYZANTINE_KINDS)

    # scenarios validate; collect the kinds they exercise
    used: set[str] = set()
    for name, factory in sorted(SCENARIOS.items()):
        try:
            sc = factory()
            sc.validate()
            if sc.name != name:
                problems.append(
                    f"{name}: registry key != scenario.name {sc.name!r}")
            for _idx, spec in sc.byzantine_specs():
                used.add(spec.get("kind"))
        except Exception as e:
            problems.append(f"{name}: scenario factory invalid: {e}")

    for kind in sorted(kinds - used):
        problems.append(
            f"{kind}: byzantine kind registered but used by no named "
            "scenario (sim/scenario.py SCENARIOS)")

    documented = _docs_table("Byzantine catalog")
    if not documented:
        problems.append(
            "docs/CHAOS.md: no '## Byzantine catalog' table found")
    else:
        for kind in sorted(kinds - documented):
            problems.append(
                f"{kind}: byzantine kind missing from the docs/CHAOS.md "
                "byzantine table")
        for kind in sorted(documented - kinds):
            problems.append(
                f"{kind}: in docs/CHAOS.md byzantine table but not "
                "registered (sim/byzantine.py)")

    tested = _tests_mentioning(kinds)
    for kind in sorted(kinds - tested):
        problems.append(
            f"{kind}: byzantine kind not named by any "
            "tests/test_torch_*.py file")

    inv_documented = _docs_table("Scenario invariants")
    if not inv_documented:
        problems.append(
            "docs/CHAOS.md: no '## Scenario invariants' table found")
    else:
        for inv in sorted(set(INVARIANTS) - inv_documented):
            problems.append(
                f"{inv}: invariant missing from the docs/CHAOS.md "
                "invariant table")
        for inv in sorted(inv_documented - set(INVARIANTS)):
            problems.append(
                f"{inv}: in docs/CHAOS.md invariant table but not in "
                "sim/scenario.py INVARIANTS")
    return problems


def main() -> int:
    problems = collect_problems()
    for p in problems:
        print(f"LINT: {p}")
    from ..sim.byzantine import BYZANTINE_KINDS
    from ..sim.scenario import INVARIANTS, SCENARIOS

    print(f"{len(BYZANTINE_KINDS)} byzantine kinds, "
          f"{len(SCENARIOS)} scenarios, {len(INVARIANTS)} invariants")
    print("OK" if not problems else "FAILED")
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
