#!/usr/bin/env python3
"""Time the native int8 kernel rows of one checkout (6a-6i of PERF.md).

    python scripts/kernel_rows.py ROOT [--label LABEL]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``chip_smoke.py`` and ``src/repro_torch`` (the kernels built from ROOT's
sources into ROOT's ``build/``), builds the cases of ROOT's
``chip_smoke.q8_kernel_cases`` at granite-8b's widths from their seeds,
checks each native q8 kernel against its plain version, times it with
``chip_smoke.time_ms`` (CUDA events, L2 flushed between calls), and prints
one JSON line: the label, the card, the build directory and the ms of each
case by name.  Needs one CUDA card.  To compare two checkouts, run it in
turns on one card (parent, change, change, parent) and compare the cases
both print.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("smoke", root /
                                                  "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, fused
    from repro_torch.models.attention import quantize_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    cases = smoke.q8_kernel_cases(fused, quantize_kv, dev,
                                  get_config("granite-8b"))
    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {}
    for case in cases:
        name = case["name"]
        _, row_err, rms_err = smoke.compare(case["kernel"](), case["plain"]())
        if row_err > smoke.TOL_ROW or rms_err > smoke.TOL_RMS:
            print(f"kernel_rows: {name} disagrees with its plain version "
                  f"({row_err}, {rms_err})", file=sys.stderr)
            return 1
        out[name] = smoke.time_ms(case["kernel"], flush=flush)
    print(json.dumps({"label": args.label or str(root),
                      "card": smoke.card_line(),
                      "build_dir": str(_build.build_dir()), "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
