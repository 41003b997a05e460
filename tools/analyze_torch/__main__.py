"""The CLI: ``python -m tools.analyze_torch [--strict] [--baseline
FILE] [--device D]``.

Exit codes: 0 = no non-baselined error findings (or not --strict),
1 = strict mode with non-baselined errors, 2 = internal pass failure
(a packed pass asked for the card where there is none included).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

from . import PASS_NAMES, run_all
from .common import REPO_ROOT, load_baseline, write_baseline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.analyze_torch",
        description="The port's static analysis (tools/analyze for "
                    "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined error finding")
    ap.add_argument("--baseline",
                    default=os.path.join(REPO_ROOT, "tools",
                                         "analyze_torch", "baseline.json"),
                    help="baseline file of accepted findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline with current findings")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of: %s"
                    % ",".join(PASS_NAMES))
    ap.add_argument("--device", default="cuda",
                    help="device of the packed pass's deployments "
                    "(default cuda; cpu to run it without a card)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON on stdout")
    args = ap.parse_args(argv)

    passes = None
    if args.passes:
        passes = tuple(p.strip() for p in args.passes.split(",") if
                       p.strip())
        unknown = set(passes) - set(PASS_NAMES)
        if unknown:
            ap.error("unknown pass(es): %s" % ", ".join(sorted(unknown)))

    src = os.path.join(REPO_ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)

    t0 = time.perf_counter()
    try:
        findings = run_all(passes=passes, device=args.device)
    except Exception as e:               # a broken pass must not pass CI
        print("analyzer internal error: %s: %s"
              % (type(e).__name__, e), file=sys.stderr)
        return 2
    seconds = time.perf_counter() - t0

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print("wrote %d finding(s) to %s"
              % (len(findings), args.baseline))
        return 0

    baseline = set(load_baseline(args.baseline))
    fresh = [f for f in findings if f.key() not in baseline]
    stale = baseline - {f.key() for f in findings}

    if args.json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "fresh": [f.to_json() for f in fresh],
            "seconds": seconds,
        }, indent=2))
    else:
        for f in sorted(findings, key=lambda f: (f.path, f.line)):
            mark = "" if f.key() in baseline else " [NEW]"
            print(f.render() + mark)
        by_rule = collections.Counter(f.rule for f in findings)
        print("%d finding(s), %d new, %d baselined, %d stale baseline "
              "entr%s; by rule %s; %.1f s"
              % (len(findings), len(fresh), len(findings) - len(fresh),
                 len(stale), "y" if len(stale) == 1 else "ies",
                 dict(sorted(by_rule.items())), seconds))

    if args.strict and any(f.severity == "error" for f in fresh):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
