#!/usr/bin/env python3
"""Time the native kernel rows of one checkout (phase 3 of chip_smoke.py).

    python scripts/kernel_rows.py ROOT [--label LABEL]
        [--rows q8|bf16|norms|ssd|decode] [--smoke PATH]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``chip_smoke.py`` and ``src/repro_torch`` (the kernels built from ROOT's
sources into ROOT's ``build/``), builds the native cases of ROOT's
phase 3 from their seeds: the int8 rows (``--rows q8``, the default:
``q8_kernel_cases`` at granite-8b's widths, 6a-6i of PERF.md) or the bf16
rows (``--rows bf16``: ``kernel_cases`` at granite-8b's widths and
``moe_kernel_cases`` at granite-moe-3b-a800m's, rows 1-8 of PERF.md) or
the row norms (``--rows norms``: the rmsnorm and add_rmsnorm cases of
``moe_kernel_cases`` and ``mamba_norm_cases``, rows 5-5b and 7-7h) or the
SSD kernels (``--rows ssd``: the ssd_scan and ssd_decode cases of
``ssd_kernel_cases`` at mamba2-2.7b's widths, rows 12-12d, 13 and 13b,
each on y and the state) or the decode attention + wo rows (``--rows
decode``: every ``pos`` and paged case of ``kernel_cases``,
``moe_kernel_cases``, ``q8_kernel_cases`` and ``arch_kernel_cases``, with
the mode rows the last makes: 3c, 4, 4b, 4c, 6h, 6i, 6j, 6n, Q4, N4, L4,
S4 and mistral-large's L4m, L5 and L4q).  ``--smoke PATH`` takes the
cases from another checkout's ``chip_smoke.py`` (default ROOT's), so that
a parent checkout's kernels run the change's cases.
It checks each kernel against its plain version with phase 3's
tolerances, times it and the case's PyTorch library call with
``chip_smoke.time_ms`` (CUDA events, L2 flushed between calls; the row
norms and the SSD kernels as the median of ``chip_smoke.LIBRARY_READINGS``
readings, ``chip_smoke.library_ms``), and
prints one JSON line: the label, the card, the build directory, and the
ms and library ms (null where the case has no library call) of each case
by name.  Needs one CUDA card.  To compare two checkouts, run it in turns
on one card (parent, change, change, parent) and compare the cases both
print; the library call is the same PyTorch code in both, so each turn
adds a reading of it.
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
    ap.add_argument("--rows", choices=("q8", "bf16", "norms", "ssd",
                                       "decode"), default="q8")
    ap.add_argument("--smoke", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "smoke", args.smoke or root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, attention, fused, rmsnorm, ssd
    from repro_torch.models.attention import quantize_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    timer = smoke.time_ms
    if args.rows == "q8":
        cases = smoke.q8_kernel_cases(fused, quantize_kv, dev,
                                      get_config("granite-8b"))
    elif args.rows == "norms":
        cases = [c for c in smoke.moe_kernel_cases(
            fused, rmsnorm, attention, dev,
            get_config("granite-moe-3b-a800m"))
            + smoke.mamba_norm_cases(rmsnorm, dev, get_config("mamba2-2.7b"))
            if c["counter"] in ("rmsnorm", "add_rmsnorm")]
        timer = smoke.library_ms
    elif args.rows == "ssd":
        cases = [c for c in smoke.ssd_kernel_cases(
            ssd, dev, get_config("mamba2-2.7b"))
            if c["counter"] in ("ssd_scan", "ssd_decode")]
        timer = smoke.library_ms
    elif args.rows == "decode":
        arch_cfgs = {a: get_config(a) for a in (
            smoke.NEMO, smoke.QWEN, smoke.LLAVA, smoke.WHISPER, smoke.LARGE,
            smoke.SCOUT)}
        cases = [c for c in (
            smoke.kernel_cases(fused, dev, get_config("granite-8b"))
            + smoke.moe_kernel_cases(fused, rmsnorm, attention, dev,
                                     get_config("granite-moe-3b-a800m"))
            + smoke.q8_kernel_cases(fused, quantize_kv, dev,
                                    get_config("granite-8b"))
            + smoke.arch_kernel_cases(fused, rmsnorm, dev, arch_cfgs))
            if c["counter"].startswith(("paged_attention_matmul",
                                        "flash_attention_matmul_pos",
                                        "flash_attention_matmul_q8_pos"))]
    else:
        cases = (smoke.kernel_cases(fused, dev, get_config("granite-8b"))
                 + smoke.moe_kernel_cases(
                     fused, rmsnorm, attention, dev,
                     get_config("granite-moe-3b-a800m")))
    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out, library = {}, {}
    for case in cases:
        name = case["name"]
        outs, refs = case["kernel"](), case["plain"]()
        if len(case.get("outputs", ("out",))) == 1:
            outs, refs = (outs,), (refs,)
        errs = [smoke.compare(o, r) for o, r in zip(outs, refs)]
        row_err, rms_err = max(e[1] for e in errs), max(e[2] for e in errs)
        if row_err > smoke.TOL_ROW or rms_err > smoke.TOL_RMS:
            print(f"kernel_rows: {name} disagrees with its plain version "
                  f"({row_err}, {rms_err})", file=sys.stderr)
            return 1
        out[name] = timer(case["kernel"], flush=flush)
        library[name] = (timer(case["library"], flush=flush)
                         if case["library"] is not None else None)
    print(json.dumps({"label": args.label or str(root),
                      "card": smoke.card_line(),
                      "build_dir": str(_build.build_dir()), "ms": out,
                      "library_ms": library}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
