#!/usr/bin/env python3
"""Where one decode attention + wo call's device time goes, for one checkout.

    python scripts/decode_breakdown.py ROOT [--label LABEL] [--heads H]
        [--d-model N]

ROOT is a checkout of this repository: the working tree, or a parent
commit unpacked with ``git archive``.  The script imports ROOT's
``chip_smoke.py`` and ``src/repro_torch`` (the kernels built from ROOT's
sources into ROOT's ``build/``) and builds granite-8b's decode operands in
bf16 from seed 0: 8 slots of 32/8 heads of 128 with frontiers of 128-543
keys, a dense 576-key cache, pools of 72 pages of 64 keys (bf16, and int8
with f32 per-token scales), wo [4096, 4096] in bf16 and in int8
(``--heads 96 --d-model 12288``: mistral-large-123b's 96/8 heads and wo
[12288, 12288], group 12).  For the
``pos`` shape, the paged shape and the paged shape over int8 pools with an
int8 wo, and for wo alone on the decode GEMV (``rmsnorm_matmul`` at
x [8, 4096], bf16 and int8): seven timings on CUDA events with L2 flushed
(``chip_smoke.time_ms``; their median and least), then twenty calls under
``torch.profiler``, whose kernels give each launch's mean device time (a
launch that is a programmatic dependent starts before the launch ahead of
it ends, so the times of one call overlap).  Prints one JSON line a case:
the label, the card, the case, the ms and the kernels' mean ms by name.
Needs one CUDA card.  To compare two checkouts, run it in turns on one
card (parent, change, change, parent).  Where ROOT's port has
``fused.decode_resident_blocks``, a first line gives the paged split
kernel's blocks an SM in every mode at groups 4, 8, 12 and 16 (bf16, D
128, one page of 64 a split, as these shapes plan it).
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

SLOTS, KV_HEADS, HEAD_DIM, MAX_LEN, PAGE = 8, 8, 128, 576, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=4096)
    args = ap.parse_args()
    heads, d_model = args.heads, args.d_model
    if not torch.cuda.is_available():
        print("decode_breakdown: no CUDA card is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("smoke", root /
                                                  "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, fused
    from repro_torch.models.attention import quantize_kv
    dev = torch.device("cuda", 0)
    _build.build(["flash_attention_matmul", "paged_attention_matmul",
                  "rmsnorm_matmul"])
    if hasattr(fused, "decode_resident_blocks"):
        blocks = {m: {g: fused.decode_resident_blocks(
            m, torch.bfloat16, group=g, head_dim=HEAD_DIM, chunk=PAGE,
            page_size=PAGE) for g in (4, 8, 12, 16)}
            for m in ("native",) + smoke.MODES}
        print(json.dumps({"label": args.label or str(root),
                          "card": smoke.card_line(),
                          "resident_blocks": blocks}), flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(128, MAX_LEN - 32, SLOTS).astype(
        np.int32)).to(dev)
    q = rand(SLOTS, heads, 1, HEAD_DIM)
    kd = rand(SLOTS, KV_HEADS, MAX_LEN, HEAD_DIM)
    vd = rand(SLOTS, KV_HEADS, MAX_LEN, HEAD_DIM)
    wo = rand(heads * HEAD_DIM, d_model, scale=(heads * HEAD_DIM) ** -0.5)
    woq, wos = fused.quantize_weight(wo)
    maxp = MAX_LEN // PAGE
    kp = rand(SLOTS * maxp, KV_HEADS, PAGE, HEAD_DIM)
    vp = rand(SLOTS * maxp, KV_HEADS, PAGE, HEAD_DIM)
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    tables = torch.from_numpy(rng.permutation(SLOTS * maxp).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(dev)
    x, w = rand(SLOTS, d_model), rand(d_model)
    cases = {
        "pos": lambda: fused.flash_attention_matmul(q, kd, vd, wo, pos=pos),
        "paged64": lambda: fused.paged_attention_matmul(
            q, kp, vp, wo, block_tables=tables, pos=pos),
        "paged64_q8": lambda: fused.flash_attention_matmul_q8(
            q, kq, vq, woq, w_scale=wos, k_scale=ks, v_scale=vs,
            block_tables=tables, pos=pos),
        "wo_gemv_alone": lambda: fused.rmsnorm_matmul(x, w, wo),
        "wo_gemv_q8_alone": lambda: fused.rmsnorm_matmul_q8(
            x, w, woq, w_scale=wos),
    }
    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name, fn in cases.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = sorted(smoke.time_ms(fn, flush=flush) for _ in range(7))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            t = (getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0))
            if t and "uisa" in e.key:
                kernels[e.key] = t / e.count / 1000.0
        print(json.dumps({"label": args.label or str(root),
                          "card": smoke.card_line(), "case": name,
                          "heads": heads, "d_model": d_model,
                          "ms_median": ms[3], "ms_least": ms[0],
                          "kernels_ms": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
