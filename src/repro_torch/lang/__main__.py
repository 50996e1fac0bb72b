"""``python -m repro_torch.lang --check-registry [names...]`` — spec validation.

Exit status 0 when every registered kernel spec builds and validates; 1
with one line per diagnostic otherwise.  CI runs this before any analysis
timing section so malformed specs fail fast with authoring-level errors.
"""
from __future__ import annotations

import argparse
import sys

from .check import check_registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lang")
    ap.add_argument("--check-registry", action="store_true",
                    help="build + validate every registered kernel spec")
    ap.add_argument("names", nargs="*",
                    help="restrict the check to these registry names")
    ap.add_argument("--scale", type=int, default=1,
                    help="structure-parameter scale to build at")
    args = ap.parse_args(argv)
    if not args.check_registry:
        ap.error("nothing to do (pass --check-registry)")
    failures = check_registry(args.names or None, scale=args.scale)
    from ..core.registry import kernel_names
    checked = args.names or kernel_names()
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        print(f"registry check: {len(failures)} failure(s) across "
              f"{len(checked)} kernel(s)", file=sys.stderr)
        return 1
    print(f"registry check: {len(checked)} kernel spec(s) valid")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
