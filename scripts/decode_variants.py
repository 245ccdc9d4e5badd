#!/usr/bin/env python3
"""Time mistral-large-123b's decode attention + wo (PERF.md rows L4, L4m
and L4q) on builds of ``csrc/paged_attention_matmul.cu``: the checkout's,
a parent checkout's and edits of ``csrc/attention_decode.cuh``.

    python scripts/decode_variants.py [--parent DIR] [--turns 3]
        [--only NAME ...]

Builds, every ``nvcc`` in parallel with ``_build.NVCC_FLAGS`` and
``-Xptxas -v`` (each log under ``build/decode_variants/``): the checkout
(``checkout``), copies edited as :data:`VARIANTS` says, and ``DIR``'s
``src/repro_torch/csrc`` (``parent``, a checkout unpacked with ``git
archive``).  A build that does not compile is reported and left out (the
script then exits 1 after the rest).

On one card, from seed 0, mistral-large-123b's decode operands in bf16: 8
slots of 96/8 heads of 128 (group 12), frontiers of 128-543 keys, pools of
72 pages of 64 (bf16, and int8 with f32 per-token scales) and of 40 pages
of 128, wo [12288, 12288] in bf16 and in int8.  The cases: ``L4`` (native,
pages of 64), ``L4m`` (abstract and abstract+shuffle, pages of 128) and
``L4q`` (native, int8 pools and int8 wo, pages of 64).  For each build and
case: the route (``LAST_ROUTE``), the check against the plain version with
``chip_smoke.py``'s phase-3 tolerances, whether the output equals the
checkout's bit for bit, the median of ``--turns`` readings of
``chip_smoke.time_ms`` (CUDA events, L2 flushed, a mean of 10 each; the
builds in turns, in order on even turns and in reverse on odd ones, so
that ``parent`` runs first and last), then each launch's mean device time
over 20 calls under ``torch.profiler``.  Also each build's split kernel
blocks an SM at groups 4, 8, 12 and 16 (bf16, native, D 128, a page of 64
a split) where the build has ``uisa_paged_attention_decode_resident``.
Prints a line a reading, then one JSON line (also
``build/decode_variants/result.json``).  Needs one CUDA card.

The variants:

- ``threads256``: the GM 16 kernels at 256 threads (8 warps), not 512,
  warp w taking heads w and w + 8's softmax rows in turn and a thread
  four (head, d pair) units of P.V, at the same shared memory (the GM 8
  kernels are 256 threads in both);
- ``q_at_t`` (bf16 only: its shared memory sizes q at 2 bytes an
  element): q staged at the working dtype and widened at each use, not
  staged in f32 (the same values);
- ``splits2``: ``plan_decode`` plans about 2 split blocks an SM, not 4,
  for groups of 9-16 (at pages of 64, 5 splits of up to two pages, not 9
  of one), so that the GM 16 kernels' 2 resident blocks an SM take the
  grid in one wave, each block's second tile loading under its first.
"""
import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from _variants import ROOT, build, load_smoke

SLOTS, HEADS, KV_HEADS, HEAD_DIM, D_MODEL, MAX_LEN = \
    8, 96, 8, 128, 12288, 576
_HEADER = "attention_decode.cuh"
#: name -> {file: [(old, new), ...]}, exact edits of a copy of csrc/
VARIANTS = {
    "threads256": {_HEADER: [
        ("  return 32 * GM;", "  return 256;"),
        ("    } else if (w < G) {",
         "    } else for (int w = tid / 32; w < G; w += 8) {")]},
    "q_at_t": {_HEADER: [
        ("  float* qs = (float*)(ring + DEC_STAGES * 2 * DEC_KT * RBP);",
         "  T* qs = (T*)(ring + DEC_STAGES * 2 * DEC_KT * RBP);"),
        ("i < G * D; i += NT) qs[i] = to_f(q[i]);",
         "i < G * D; i += NT) qs[i] = q[i];"),
        ("        const float* qr = qs + hg * D;",
         "        const T* qr = qs + hg * D;"),
        ("dot = fmaf(qr[j * EPC + e], kv, dot);",
         "dot = fmaf(to_f(qr[j * EPC + e]), kv, dot);"),
        ("(size_t)G * D * sizeof(float) +", "(size_t)G * D * 2 +")]},
    "splits2": {_HEADER: [(
        "  long long s = (DEC_SPLITS_PER_SM * (long long)sms + base - 1) "
        "/ base;",
        "  const int per_sm = G > DEC_GNARROW ? 2 : DEC_SPLITS_PER_SM;\n"
        "  long long s = (per_sm * (long long)sms + base - 1) / base;")]},
}
ENTRIES = ("paged_attention_matmul", "paged_attention_matmul_workspace")


def bind(lib: Path):
    """({entry: ctypes function} of ``lib``, its resident-blocks query or
    None)."""
    from repro_torch.kernels import _launch
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ENTRIES:
        symbol, argtypes, *rest = _launch.SIGNATURES[entry]
        fn = getattr(cdll, symbol)
        fn.argtypes = argtypes
        fn.restype = rest[1] if rest else ctypes.c_int
        fns[entry] = fn
    resident = getattr(cdll, "uisa_paged_attention_decode_resident", None)
    if resident is not None:
        resident.argtypes = [ctypes.c_int] * 6
        resident.restype = ctypes.c_int
    return fns, resident


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA card is available", file=sys.stderr)
        return 2
    smoke = load_smoke()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _launch, fused
    from repro_torch.models.attention import quantize_kv
    dev = torch.device("cuda", 0)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    builds = {"checkout": (csrc, None)}
    builds.update({name: (csrc, VARIANTS[name]) for name in args.only})
    if args.parent is not None:
        builds["parent"] = (args.parent.resolve() / "src" / "repro_torch"
                            / "csrc", None)
    out_dir = ROOT / "build" / "decode_variants"
    libs = build("paged_attention_matmul", builds, out_dir)
    bound = {name: bind(lib) for name, lib in libs.items()}
    bf16 = _launch.dtype_code(torch.empty(0, dtype=torch.bfloat16))
    resident = {name: {g: query(_launch.MODE_CODES["native"], bf16, g,
                                HEAD_DIM, 64, 64) for g in (4, 8, 12, 16)}
                for name, (_, query) in bound.items() if query is not None}
    print(f"card: {smoke.card_line()}; blocks an SM {json.dumps(resident)}",
          flush=True)

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(128, MAX_LEN - 32, SLOTS).astype(
        np.int32)).to(dev)
    q = rand(SLOTS, HEADS, 1, HEAD_DIM)
    wo = rand(HEADS * HEAD_DIM, D_MODEL, scale=(HEADS * HEAD_DIM) ** -0.5)
    woq, wos = fused.quantize_weight(wo)

    def pools(ps):
        maxp = -(-MAX_LEN // ps)
        kp = rand(SLOTS * maxp, KV_HEADS, ps, HEAD_DIM)
        vp = rand(SLOTS * maxp, KV_HEADS, ps, HEAD_DIM)
        return kp, vp, torch.from_numpy(rng.permutation(SLOTS * maxp).astype(
            np.int32).reshape(SLOTS, maxp)).to(dev)
    kp, vp, tables = pools(64)
    kp128, vp128, tables128 = pools(128)
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)

    def paged(m, k, v, t):
        return (lambda: fused.paged_attention_matmul(
                    q, k, v, wo, block_tables=t, pos=pos, mode=m),
                lambda: fused.paged_attention_matmul_plain(
                    q, k, v, wo, block_tables=t, pos=pos, mode=m),
                _launch.count_name("paged_attention_matmul", m))
    cases = {"L4 native": paged("native", kp, vp, tables)}
    for m in smoke.MODES:
        cases[f"L4m {m}"] = paged(m, kp128, vp128, tables128)
    cases["L4q native"] = (
        lambda: fused.flash_attention_matmul_q8(
            q, kq, vq, woq, w_scale=wos, k_scale=ks, v_scale=vs,
            block_tables=tables, pos=pos),
        lambda: fused.flash_attention_matmul_q8_plain(
            q, kq, vq, woq, wos, block_tables=tables, pos=pos, k_scale=ks,
            v_scale=vs),
        "paged_attention_matmul_q8")
    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    names = [n for n in ("parent", "checkout", *args.only) if n in libs]
    readings, checks, outputs = {}, {}, {}
    failed = len(libs) < len(builds)
    try:
        for turn in range(args.turns):
            for name in names if turn % 2 == 0 else names[::-1]:
                _launch._bound.update(bound[name][0])
                for case, (kernel, plain, counter) in cases.items():
                    if turn == 0:
                        _launch.LAST_ROUTE.clear()
                        got = kernel()
                        route = _launch.LAST_ROUTE.get(counter)
                        err = smoke.compare(got, plain())
                        ok = (err[1] <= smoke.TOL_ROW
                              and err[2] <= smoke.TOL_RMS)
                        failed |= not ok
                        outputs[(name, case)] = got
                        checks[(name, case)] = dict(
                            route=route, max_abs_err=err[0], row_err=err[1],
                            rms_err=err[2], within_tolerance=ok)
                    ms = smoke.time_ms(kernel, flush=flush)
                    readings.setdefault((name, case), []).append(ms)
                    print(f"turn {turn} {name} {case}: {ms:.4f} ms",
                          flush=True)
        device = {}
        for name in names:
            _launch._bound.update(bound[name][0])
            for case, (kernel, _, _) in cases.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        flush.amax()
                        kernel()
                    torch.cuda.synchronize()
                device[f"{name} {case}"] = {
                    e.key[:90]: (getattr(e, "device_time_total", 0)
                                 or getattr(e, "cuda_time_total", 0))
                    / e.count / 1000.0
                    for e in prof.key_averages() if "uisa" in e.key}
    finally:
        for entry in ENTRIES:
            _launch._bound.pop(entry, None)
    for (name, case), c in checks.items():
        c["bits_equal_checkout"] = bool(torch.equal(
            outputs[(name, case)], outputs[("checkout", case)]))
    result = dict(
        card=smoke.card_line(), resident_blocks=resident,
        ms={f"{n} {c}": statistics.median(v)
            for (n, c), v in readings.items()},
        readings={f"{n} {c}": v for (n, c), v in readings.items()},
        checks={f"{n} {c}": v for (n, c), v in checks.items()},
        device_ms=device)
    (out_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
