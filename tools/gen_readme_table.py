"""Render README's test-tier table from a live pytest count, so the counts
the README states are never hand-maintained.

Usage:
  python tools/gen_readme_table.py [--check]

Rewrites the marked block in README.md in place; --check only verifies the
README matches (exit 1 on drift). Test counts come from
`pytest --collect-only` per tier.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

TIERS = [
    ("smoke", ["-m", "smoke"],
     "every force/integrator class touched once"),
    ("middle", ["-m", "not slow"],
     "everything except trajectory/statistics runs"),
    ("full", [],
     "incl. NVE-drift, KE-distribution (χ²), ΔG end-to-end, HREX mesh "
     "parity"),
]


def count_tests(markers):
    cmd = [sys.executable, "-m", "pytest", "--collect-only", "-q",
           os.path.join(ROOT, "tests")] + markers
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           timeout=600)
    except Exception:
        return None
    m = re.search(r"(\d+)(?:/\d+)? tests? collected", r.stdout)
    if not m:
        m = re.search(r"(\d+) selected", r.stdout)
    return int(m.group(1)) if m else None


def tier_table():
    lines = ["| tier | command | scope | tests |", "|---|---|---|---|"]
    for name, markers, scope in TIERS:
        n = count_tests(markers)
        cmd = ("pytest tests/ -q" if not markers
               else f"pytest -m \"{markers[1]}\" -q"
               if " " in markers[1] else f"pytest -m {markers[1]} -q")
        lines.append(
            f"| {name} | `{cmd}` | {scope} | "
            f"{n if n is not None else '—'} |")
    return "\n".join(lines)


def splice(text, marker, payload):
    start, end = f"<!-- {marker}_START -->", f"<!-- {marker}_END -->"
    if start not in text or end not in text:
        raise SystemExit(f"README.md is missing the {marker} markers")
    pre = text.split(start)[0]
    post = text.split(end)[1]
    return f"{pre}{start}\n{payload}\n{end}{post}"


def main():
    check = "--check" in sys.argv
    readme = os.path.join(ROOT, "README.md")
    with open(readme) as f:
        text = f.read()
    out = splice(text, "TIER_TABLE", tier_table())
    if check:
        if out != text:
            print("README tier table drifts from the live count — rerun "
                  "tools/gen_readme_table.py", file=sys.stderr)
            raise SystemExit(1)
        print("README tier table matches", file=sys.stderr)
        return
    with open(readme, "w") as f:
        f.write(out)
    print("README tier table regenerated", file=sys.stderr)


if __name__ == "__main__":
    main()
