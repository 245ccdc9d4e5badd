#!/usr/bin/env python3
"""Where one 512-token prefill's device time goes, for one checkout.

    python scripts/prefill_breakdown.py ROOT [--label LABEL] [--int8]
        [--model granite-8b|mamba2-2.7b]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``chip_smoke.py`` and ``src/repro_torch`` (the kernels built from ROOT's
sources into ROOT's ``build/``), builds granite-8b at full width and all
its 36 layers under the fused policy (``--int8``: the int8 policy, the
bf16 weights quantized on the card leaf by leaf, as phase 16 of
chip_smoke.py does), or mamba2-2.7b (``--model mamba2-2.7b``: all 64
layers under ``ParallelConfig(fuse_epilogues=True)``, phase 9's policy),
random weights from seed 0 in bf16, and runs the
model's ``prefill`` on one prompt of 512 random tokens: two calls to
warm up, five timed on CUDA events (their median is the prefill
time), then one under ``torch.profiler``, whose kernels give the device
time per kernel.  Prints one JSON line: the label, the card, the prefill
ms, the profiled device busy ms, the ms and launches of each kernel by
name (sorted by time), and, for mamba2-2.7b, ``ssd_scan``'s ms and share
of the busy ms (its kernels by name).  Needs one CUDA card.  To compare two checkouts,
run it in turns on one card (parent, change, change, parent).
"""
import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

TOKENS = 512


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--model", choices=("granite-8b", "mamba2-2.7b"),
                    default="granite-8b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_breakdown: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("smoke", root /
                                                  "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, common
    from repro_torch.models.config import ParallelConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    cfg = get_config(args.model)
    if args.model == "mamba2-2.7b":
        policy = dict(fuse_epilogues=True)
    else:
        policy = (smoke.INT8_POLICY if args.int8
                  else dict(fuse_epilogues=True, use_pallas_attn=True))
    model = build_model(cfg, ParallelConfig(**policy), device=dev)
    params = model.init_params(0)
    if args.int8:
        smoke.quantize_in_place(params, common)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    tokens = torch.randint(2, cfg.vocab_size, (1, TOKENS), generator=g,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    with torch.no_grad():
        for _ in range(2):
            model.prefill(params, batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.prefill(params, batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch)
            torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels[e.key] = {"ms": us / 1e3, "launches": e.count}
    ranked = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))
    busy = sum(k["ms"] for k in kernels.values())
    scan = {}
    if args.model == "mamba2-2.7b":
        scan_ms = sum(k["ms"] for n, k in kernels.items() if "ssd_scan" in n)
        scan = {"ssd_scan_ms": scan_ms, "ssd_scan_share": scan_ms / busy}
    print(json.dumps({
        "label": args.label or str(root), "card": smoke.card_line(),
        "model": cfg.name, "layers": cfg.num_layers, "int8": args.int8,
        "tokens": TOKENS, "prefill_ms": statistics.median(times),
        "prefill_ms_readings": times,
        "busy_ms": busy, **scan, "kernels": ranked}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
