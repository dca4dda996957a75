"""Chrome trace-event JSON validator (exporter schema; a copy of
``repro/obs/validate.py`` with its own entry point).

Used by tests and the CI trace-smoke step to guarantee emitted traces
stay Perfetto-loadable:

    PYTHONPATH=src python -m repro_torch.obs.validate trace.json [more.json...]

Exits non-zero with one line per violation otherwise.
"""
from __future__ import annotations

import json
import sys
from typing import Any, List

VALID_PH = {"X", "B", "E", "i", "I", "M", "C"}


def validate_chrome_trace(obj: Any, *, require_events: bool = True) -> List[str]:
    """Return a list of schema violations (empty == valid).

    Accepts both container forms Chrome/Perfetto load: a dict with a
    ``traceEvents`` list, or a bare event list.
    """
    errs: List[str] = []
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level dict has no 'traceEvents' list"]
    elif isinstance(obj, list):
        events = obj
    else:
        return [f"expected dict or list at top level, got {type(obj).__name__}"]

    n_real = 0
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: missing/empty 'name'")
        ph = ev.get("ph")
        if ph not in VALID_PH:
            errs.append(f"{where}: bad phase {ph!r} (allowed: {sorted(VALID_PH)})")
            continue
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            errs.append(f"{where}: 'ts' must be a number >= 0")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errs.append(f"{where}: '{k}' must be an int")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errs.append(f"{where}: complete event needs 'dur' >= 0")
            n_real += 1
        elif ph in ("i", "I"):
            n_real += 1
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            errs.append(f"{where}: 'args' must be an object")
    if require_events and n_real == 0:
        errs.append("trace contains no span/instant events")
    return errs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.obs.validate <trace.json> [...]")
        return 2
    bad = 0
    for path in argv:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable/invalid JSON: {e}")
            bad += 1
            continue
        errs = validate_chrome_trace(obj)
        if errs:
            bad += 1
            for e in errs[:20]:
                print(f"{path}: {e}")
            if len(errs) > 20:
                print(f"{path}: ... {len(errs) - 20} more")
        else:
            n = len(obj["traceEvents"]) if isinstance(obj, dict) else len(obj)
            print(f"{path}: OK ({n} events)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
