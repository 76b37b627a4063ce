"""Validate telemetry JSONL streams against the committed schema.

    python -m repro_torch.obs.check run.jsonl [more.jsonl ...]

Counterpart of ``repro/obs/check.py``.  The exit code is the number of
invalid files.
"""

from __future__ import annotations

import sys

from .schema import validate_stream


def main(argv: list[str]) -> int:
    if not argv:
        sys.exit("usage: python -m repro_torch.obs.check run.jsonl [...]")
    bad = 0
    for path in argv:
        errors = validate_stream(path)
        if errors:
            bad += 1
            print(f"FAIL {path}")
            for e in errors:
                print(f"  {e}")
        else:
            print(f"ok   {path}")
    return bad


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
