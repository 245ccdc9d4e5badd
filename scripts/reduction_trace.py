#!/usr/bin/env python3
"""Where one Table V reduction call's device time goes, for one checkout.

    python scripts/reduction_trace.py ROOT [--label LABEL] [--calls N]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``src/repro_torch`` (the reduction kernels built from ROOT's sources into
ROOT's ``build/``) and sums 2^24 f32 values from seed 0 in every mode, at
the 2-per-thread tile (512 elements, row 10d of PERF.md) and at the
default tile (rows 10-10c).  For each (tile, mode) it first times the
call on CUDA events with L2 flushed (the median of 20, as
``repro_torch.benchmarks.tablev`` does), then runs ``--calls`` calls
under ``torch.profiler``, each after an L2 flush, and reads every kernel
of the call from the trace: its name, grid, block and duration, and the
gap from the end of the kernel before it.  Prints one JSON line a
(tile, mode): the label, the card, the medians over the calls of each
launch's duration and gap (in launch order), of the call's span (first
start to last end), and the CUDA-event median.  Needs one CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

N = 1 << 24


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def calls_from_trace(path: Path) -> list:
    """The reduction kernels of the trace, one list a call: a call is the
    run of the port's kernels (``uisa::``) between two other kernels (the
    L2 flush)."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    events.sort(key=lambda e: e["ts"])
    calls, cur = [], []
    for e in events:
        if "uisa::" in e["name"]:
            cur.append(e)
        elif cur:
            calls.append(cur)
            cur = []
    if cur:
        calls.append(cur)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reduction_trace: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks.common import l2_flush_buffer, time_ms
    from repro_torch.kernels import _build, reduction
    dev = torch.device("cuda", 0)
    _build.build(["reduction"])
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn(N, generator=g, device=dev)
    flush = l2_flush_buffer(dev)
    card = card_line()
    for tile in (2 * reduction.THREADS, reduction.TILE):
        for mode in reduction.MODES:
            def fn(mode=mode, tile=tile):
                return reduction.reduce_sum_kernel(x, mode, tile)
            ms = time_ms(fn, flush=flush)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    flush.amax()
                    fn()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(path))
                calls = calls_from_trace(path)
            shapes = {len(c) for c in calls}
            if len(shapes) != 1:
                print(f"reduction_trace: calls of {shapes} kernels",
                      file=sys.stderr)
                return 1
            launches = []
            for i, e in enumerate(calls[0]):
                durs = [c[i]["dur"] for c in calls]
                gaps = [c[i]["ts"] - (c[i - 1]["ts"] + c[i - 1]["dur"])
                        for c in calls] if i else None
                launches.append(dict(
                    name=e["name"], grid=e["args"].get("grid"),
                    block=e["args"].get("block"),
                    us=statistics.median(durs), us_min=min(durs),
                    gap_us=statistics.median(gaps) if gaps else None))
            spans = [c[-1]["ts"] + c[-1]["dur"] - c[0]["ts"] for c in calls]
            print(json.dumps({"label": args.label or str(root), "card": card,
                              "tile": tile, "mode": mode, "ms": ms,
                              "span_us": statistics.median(spans),
                              "calls": len(calls), "launches": launches}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
