"""Failpoint-catalog lint over the port (reference: the repository's
root tools/check_failpoints.py; run as ``python -m
tendermint_tpu_torch.tools.check_failpoints`` or from
tests/test_torch_lints.py).

Keeps the chaos surface honest as injection points spread:

1. Every `failpoints.hit("name")` call site in tendermint_tpu_torch/
   names a
   point registered in the libs/failpoints.py CATALOG — a typo'd name
   would silently never fire (hit() on an unregistered name is a
   no-op by design, so this lint is the only guard).
2. Every registered point HAS at least one call site — a catalog entry
   nothing hits is dead documentation.
3. Every registered point is documented in the docs/CHAOS.md catalog
   table, and every table row names a real point.
4. Every registered point appears in at least one of the port's test
   files (tests/test_torch_*.py) — each injection shape must be
   exercised, not just defined.

The catalog is the reference's, point for point, so the docs table is
the reference's docs/CHAOS.md, read and never edited.
"""

from __future__ import annotations

import ast
import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TESTS = os.path.join(REPO, "tests")
DOCS = os.path.join(REPO, "docs", "CHAOS.md")

# hit() appears as failpoints.hit(...), hit(...), the async variant
# failpoints.hit_async(...), or the `_failpoint` alias the
# consensus/execution crash sites import it as
_HIT_NAMES = {"hit", "hit_async", "_failpoint"}


def _iter_py(root: str, prefix: str = ""):
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.endswith(".py") and fn.startswith(prefix):
                yield os.path.join(dirpath, fn)


def call_sites(root: str = PKG) -> dict[str, list[str]]:
    """{literal-name: ["relpath:line", ...]} over every hit() call
    with a string-literal first argument. The registry module itself
    is exempt (its internal uses are the implementation)."""
    out: dict[str, list[str]] = {}
    for path in _iter_py(root):
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if rel == "tendermint_tpu_torch/libs/failpoints.py":
            continue
        with open(path, "rb") as f:
            try:
                tree = ast.parse(f.read(), filename=rel)
            except SyntaxError:  # pragma: no cover
                continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fobj = node.func
            name = fobj.attr if isinstance(fobj, ast.Attribute) else \
                getattr(fobj, "id", None)
            if name not in _HIT_NAMES:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and \
                    isinstance(first.value, str):
                out.setdefault(first.value, []).append(
                    f"{rel}:{node.lineno}")
    return out


def docs_table_names(path: str = DOCS) -> set[str]:
    """Point names from the CHAOS.md catalog table: rows of the form
    `| \\`name\\` | ...` under the '## Failpoint catalog' heading."""
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## Failpoint catalog$(.*?)(?=^## )", text,
                  re.M | re.S)
    if m is None:
        return set()
    return set(re.findall(r"^\|\s*`([a-z0-9_.]+)`\s*\|", m.group(1),
                          re.M))


def tests_mentioning(names: set[str], root: str = TESTS) -> set[str]:
    """Subset of `names` that appear (as string literals or otherwise)
    somewhere in the port's test files under `root`."""
    found: set[str] = set()
    want = set(names)
    for path in _iter_py(root, "test_torch_"):
        if not want - found:
            break
        try:
            text = open(path, encoding="utf-8").read()
        except OSError:  # pragma: no cover
            continue
        for n in want - found:
            if n in text:
                found.add(n)
    return found


def collect_problems() -> list[str]:
    from ..libs.failpoints import BY_NAME

    problems: list[str] = []
    registered = set(BY_NAME)

    sites = call_sites()
    for name, where in sorted(sites.items()):
        if name not in registered:
            problems.append(
                f"{name}: hit() call site(s) {where} name an "
                "UNREGISTERED failpoint (libs/failpoints.py CATALOG)")
    for name in sorted(registered - set(sites)):
        # probes in crypto/batch.py hit device.verify; every point
        # must have at least one product call site
        problems.append(
            f"{name}: registered but no hit() call site in "
            "tendermint_tpu_torch/")

    documented = docs_table_names()
    if not documented:
        problems.append(
            "docs/CHAOS.md: no '## Failpoint catalog' table found")
    else:
        for name in sorted(registered - documented):
            problems.append(
                f"{name}: registered but missing from the docs/CHAOS.md "
                "catalog table")
        for name in sorted(documented - registered):
            problems.append(
                f"{name}: listed in docs/CHAOS.md but not registered")

    tested = tests_mentioning(registered)
    for name in sorted(registered - tested):
        problems.append(
            f"{name}: not exercised (or even named) by any "
            "tests/test_torch_*.py file")
    return problems


def main() -> int:
    problems = collect_problems()
    for p in problems:
        print(f"LINT: {p}")
    from ..libs.failpoints import CATALOG

    print(f"{len(CATALOG)} failpoints registered; "
          f"{sum(len(v) for v in call_sites().values())} call sites")
    print("OK" if not problems else "FAILED")
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
