"""Where a dry-run record's peak lies: what is alive on one device at the
step's highest memory, by the code that made it.

    PYTHONPATH=src python tools/peak_site.py --arch olmoe --shape train_4k
    PYTHONPATH=src python tools/peak_site.py --arch zamba2-7b \\
        --shape prefill_32k --mesh multi --top 10

Runs ``launch/dryrun.py``'s record on fake tensors (no card needed) with a
ledger that tags each storage with the op that made it and the innermost
frames of ``repro_torch`` on the Python stack then (an autograd op of the
backward has none of its own: its frames are the step's backward call).
Each time the peak has risen by ``--step`` (a fraction) since the last
look, it takes the live bytes by tag; the last look lies within that
fraction of the peak. Prints one JSON object: the record's peak, the op
and frames that set it, and the ``--top`` tags by live bytes then (the
step's arguments under "argument").
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import defaultdict

from repro_torch.launch import dryrun

ROOT_MARK = "repro_torch"


def _frames(depth: int = 3) -> tuple:
    out, f = [], sys._getframe(2)
    while f is not None and len(out) < depth:
        name = f.f_code.co_filename
        if ROOT_MARK in name and not name.endswith(("dryrun.py", "peak_site.py")):
            out.append(f"{name.split(ROOT_MARK + '/')[-1]}:{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return tuple(out)


class SiteLedger(dryrun.Ledger):
    step = 0.0025

    def __init__(self, device_type: str = "cuda"):
        super().__init__(device_type)
        self._tag: dict = {}
        self._op = "argument"
        self.snapshot: dict = {}
        self.peak_site = None
        self._looked = 0

    def track(self, t) -> None:
        before = self.peak
        t = dryrun._local(t)
        key = id(t.untyped_storage()) if t.device.type == self.device_type else None
        fresh = key is not None and key not in self._live
        super().track(t)
        if fresh:
            self._tag[key] = ("argument",) if self._op == "argument" else (
                self._op, *_frames())
        if self.peak > before:
            self.peak_site = self._tag.get(key)
            if self.peak > self._looked * (1 + self.step):
                self._looked = self.peak
                by = defaultdict(int)
                for k, n in self._live.items():
                    by[" | ".join(self._tag.get(k, ("?",)))] += n
                self.snapshot = {"at": self.peak, "site": self.peak_site, "by": dict(by)}

    def _free(self, key) -> None:
        super()._free(key)
        self._tag.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)


@contextlib.contextmanager
def sites(step: float = SiteLedger.step):
    """Within: ``dryrun``'s records use a :class:`SiteLedger`; the dict
    yielded gets the last one made (``"ledger"``)."""
    seen = {}

    class Ledger(SiteLedger):
        def __init__(self, device_type="cuda"):
            super().__init__(device_type)
            self.step = step
            seen["ledger"] = self

    dryrun.Ledger, kept = Ledger, dryrun.Ledger
    try:
        yield seen
    finally:
        dryrun.Ledger = kept


def summary(rec: dict, led: SiteLedger, top: int) -> dict:
    by = sorted(led.snapshot["by"].items(), key=lambda kv: -kv[1])[:top]
    return {"peak_bytes": rec["memory_analysis"]["peak_bytes"],
            "argument_bytes": rec["memory_analysis"]["argument_size_in_bytes"],
            "trace_s": rec["trace_s"], "looked_at": led.snapshot["at"],
            "peak_set_by": led.peak_site, "live_by_site": dict(by)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe")
    ap.add_argument("--shape", default="train_4k", choices=list(dryrun.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--step", type=float, default=SiteLedger.step)
    ap.add_argument("--out-dir", default=None, help="where the record goes")
    args = ap.parse_args(argv)
    with sites(args.step) as seen:
        rec = dryrun.run_one(args.arch, args.shape, args.mesh, out_dir=args.out_dir)
    out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           **summary(rec, seen["ledger"], args.top)}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
