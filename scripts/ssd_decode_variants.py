#!/usr/bin/env python3
"""Re-time ssd_decode (rows 13, 13b, 13m, 13bm of PERF.md) in every mode
beside a parent checkout's kernel and variants of ``csrc/ssd_decode.cu``.

    python scripts/ssd_decode_variants.py [--parent DIR] [--turns 2]
        [--only NAME ...] [--calls 20]

Builds, all ``nvcc`` in parallel with ``_build.NVCC_FLAGS`` (and
``-Xptxas -v``: each build's log under ``build/ssd_decode_variants/``):
``ssd_decode.cu`` as it stands (``checkout``); copies edited as
:data:`VARIANTS` says; ``DIR``'s ``src/repro_torch/csrc/ssd_decode.cu``
(``parent``, a checkout unpacked with ``git archive``) and its edits in
:data:`PARENT_VARIANTS`.  A build that does not compile is reported and
left out (the script then exits 1 after the rest).

On one card, on ``chip_smoke.py``'s ssd_decode inputs (mamba2-2.7b's
widths: 8 and 5 slots x 80 heads, state [128, 64] f32, bf16 x, B, C;
seed 1), in every mode of every build:

- each output is checked against the port's plain version of its mode
  with ``chip_smoke.py``'s phase-3 tolerances (not the timing-only
  variants, whose y is wrong by design), and its largest |difference|
  from the parent kernel's y and h' is recorded (0 expected: the sums
  keep their order);
- in ``checkout``, the update in place (``state_out == state``) must
  give the out-of-place launch's y and h' bit for bit;
- each (build, case, mode) is timed as the median of
  ``chip_smoke.LIBRARY_READINGS`` readings of ``chip_smoke.time_ms``
  (CUDA events, L2 flushed, a mean of 10 each), the builds in turns
  (``parent`` first and last in every turn, ``checkout`` second and
  second to last, then the variants); after them ``torch.profiler``
  reads each one's device duration in ``--turns`` turns of one trace
  each (a turn's median over ``--calls`` calls, each after an L2 flush;
  the median of the turns' medians beside each turn's, so that a gap
  between builds can be held against the spread between turns).

Prints a line a reading, then one JSON line (also
``build/ssd_decode_variants/result.json``): the card, the medians and
device durations by build, case and mode, each mode's % of native by
build, the differences from the parent, the in-place check, and the
checkout's resident blocks an SM by mode
(``uisa_ssd_decode_resident``).  Needs one CUDA card.

The variants:

- ``stream`` and ``parent_stream`` (timing-only): the checkout's and the
  parent's kernels with every mode's readout removed (native's partials,
  abstract's products and tree, abstract+shuffle's products and lane
  tree; the parent's abstract launch also without its 32 KB tree, y
  written as 0): each
  mode's time split into the state stream and its readout;
- ``no_pad``: staged rows P floats apart, not P + 4 (the N-in-lanes map
  then reads rows 256 bytes apart: 8-way bank conflicts at P = 64);
- ``halves``: the tile staged in two row groups, each on its own
  mbarrier, native updating the first group's rows while the second's
  copies land (the other modes wait for both);
- ``whole_p``: a (slot, head)'s 64 columns in one block of 256 threads
  (a 34 KB tile, 5 blocks an SM), not over two blocks of 128 threads (32
  columns, an 18 KB tile each, 10 an SM).
"""
import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import torch

from _variants import (ROOT, build, load_smoke, medians, pct_of_native,
                       traced_turns)

MODES = ("native", "abstract", "abstract+shuffle")
#: PERF.md's row of each chip_smoke.py case
ROWS = {"ssd_decode": "13", "ssd_decode_b5": "13b"}

_NATIVE_READOUT = ("        acc[0] += cs[n] * s.x;\n"
                   "        acc[1] += cs[n] * s.y;\n"
                   "        acc[2] += cs[n] * s.z;\n"
                   "        acc[3] += cs[n] * s.w;\n", "")
_LANE_READOUT = [("      acc[j][0] += __fmul_rn(cs[n], s[j].x);\n"
                  "      acc[j][1] += __fmul_rn(cs[n], s[j].y);\n"
                  "      acc[j][2] += __fmul_rn(cs[n], s[j].z);\n"
                  "      acc[j][3] += __fmul_rn(cs[n], s[j].w);\n", ""),
                 ("acc[j][c] = lane_tree_reduce<W>(acc[j][c]);",
                  "acc[j][c] = 0.f;")]
_NO_TREE = ("    for (int w = N / 2; w >= 1; w >>= 1) {",
            "    for (int w = 0; w >= 1; w >>= 1) {")
#: variant -> [(text in the checkout's ssd_decode.cu, its replacement)]
VARIANTS = {
    "stream": [_NATIVE_READOUT, *_LANE_READOUT,
               ("    for (int w = min(N, kDecRows) / 2; w >= 1; w >>= 1) {",
                "    for (int w = 0; w >= 1; w >>= 1) {"),
               ("  *reinterpret_cast<float4*>(&tile[r * ld + p0]) = a[0];\n",
                ""),
               ("        *t = make_float4(cs[r] * s.x, cs[r] * s.y, "
                "cs[r] * s.z, cs[r] * s.w);\n", "")],
    "no_pad": [("constexpr int kDecPad = 4;", "constexpr int kDecPad = 0;")],
    "halves": [
        ("  __shared__ uint64_t full;  ", "  __shared__ uint64_t full[2];"),
        ("      mbar_init(&full, 1);\n",
         "      mbar_init(&full[0], 1);\n      mbar_init(&full[1], 1);\n"),
        ("      mbar_expect_tx(&full, (uint32_t)(N * pw * sizeof(float)));\n",
         "      mbar_expect_tx(&full[0], (uint32_t)((N + 1) / 2 * pw * 4));\n"
         "      mbar_expect_tx(&full[1], (uint32_t)(N / 2 * pw * 4));\n"),
        ("(uint32_t)(pw * sizeof(float)), &full);",
         "(uint32_t)(pw * sizeof(float)), &full[n * 2 / N]);"),
        ("  mbar_wait(&full, 0);\n",
         "  if (MODE != kNative) {\n    mbar_wait(&full[0], 0);\n"
         "    mbar_wait(&full[1], 0);\n  }\n"),
        ("#pragma unroll 4\n      for (int n = r; n < N; n += kDecRows) {\n",
         "#pragma unroll 4\n      for (int n = r; n < N; n += kDecRows) {\n"
         "        mbar_wait(&full[n * 2 / N], 0);\n")],
    "whole_p": [("constexpr int kDecCols = 8; ", "constexpr int kDecCols = 16;")],
}
#: variant -> [(text in the parent's ssd_decode.cu, its replacement)]
PARENT_VARIANTS = {
    "parent_stream": [
        _NATIVE_READOUT, *_LANE_READOUT, _NO_TREE,
        ("        *reinterpret_cast<float4*>(&tree[n * P + p0]) =\n"
         "            make_float4(cs[n] * s.x, cs[n] * s.y, cs[n] * s.z, "
         "cs[n] * s.w);\n", ""),
        ("<<<grid, kDecThreads, (size_t)N * P * sizeof(float), st>>>(",
         "<<<grid, kDecThreads, 0, st>>>("),
        ("from_f<T>(tree[tid]);", "from_f<T>(0.f);")],
}
#: builds whose y is wrong by design (timed, not checked)
TIMING_ONLY = ("stream", "parent_stream")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--calls", type=int, default=20)
    names = list(VARIANTS) + list(PARENT_VARIANTS)
    ap.add_argument("--only", nargs="*", choices=names, default=names)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_decode_variants: no CUDA card is available",
              file=sys.stderr)
        return 2
    smoke = load_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, _launch, ssd
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "build" / "ssd_decode_variants"
    builds = {"checkout": (_build.CSRC, None)}
    builds.update({v: (_build.CSRC, VARIANTS[v]) for v in args.only
                   if v in VARIANTS})
    if args.parent is not None:
        parent_csrc = args.parent.resolve() / "src" / "repro_torch" / "csrc"
        builds["parent"] = (parent_csrc, None)
        builds.update({v: (parent_csrc, PARENT_VARIANTS[v])
                       for v in args.only if v in PARENT_VARIANTS})
    t0 = time.perf_counter()
    libs = build("ssd_decode", builds, out_dir)
    print(f"build: {time.perf_counter() - t0:.1f} s, built {sorted(libs)}",
          flush=True)
    symbol, argtypes = _launch.SIGNATURES["ssd_decode"][:2]
    fns = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream(dev).cuda_stream
    inputs = [(f"{ROWS[c['name']]} {c['name']}", *c["operands"])
              for c in smoke.ssd_kernel_cases(ssd, dev,
                                              get_config("mamba2-2.7b"))
              if c["counter"] == "ssd_decode"]

    def runner(build_name, mode, state, x, dt, A, B, C, out=None):
        """A launch of ``build_name``'s kernel and its outputs."""
        b, g, hg, n, p = state.shape
        h = g * hg
        out = torch.empty_like(state) if out is None else out
        y = torch.empty(b, h, p, dtype=x.dtype, device=dev)
        call = (_launch.MODE_CODES[mode], 1, state.data_ptr(),
                out.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                B.data_ptr(), C.data_ptr(), y.data_ptr(), b, h, g, n, p,
                x.stride(0), B.stride(0), C.stride(0), stream)

        def run():
            err = fns[build_name](*call)
            if err:
                raise RuntimeError(f"{build_name}: CUDA error {err}")
        return run, out, y

    # correctness: the plain version, the parent's bits, the update in place
    diffs, in_place = {}, {}
    for name, *ops in inputs:
        for mode in MODES:
            want = ssd.ssd_decode_plain(*ops, mode=mode)
            parent_out = None
            if "parent" in fns:
                run, hp, yp = runner("parent", mode, *ops)
                run()
                parent_out = (hp, yp)
            for build_name in fns:
                run, hn, yn = runner(build_name, mode, *ops)
                run()
                torch.cuda.synchronize()
                errs = [smoke.compare(o, r) for o, r in
                        ((hn, want[0]), (yn, want[1]))]
                if build_name not in TIMING_ONLY and not all(
                        e[1] <= smoke.TOL_ROW and e[2] <= smoke.TOL_RMS
                        for e in errs):
                    raise SystemExit(f"ssd_decode_variants: {build_name} "
                                     f"{name} [{mode}] disagrees with its "
                                     f"plain version ({errs})")
                if parent_out is not None:
                    diffs[f"{build_name} {name} [{mode}]"] = [
                        float((o.float() - r.float()).abs().max())
                        for o, r in ((hn, parent_out[0]),
                                     (yn, parent_out[1]))]
            if "checkout" in fns:
                st = ops[0].clone()
                run_in, _, y_in = runner("checkout", mode, st, *ops[1:],
                                         out=st)
                run_in()
                run_out, h_out, y_out = runner("checkout", mode, *ops)
                run_out()
                torch.cuda.synchronize()
                in_place[f"{name} [{mode}]"] = bool(
                    torch.equal(st, h_out) and torch.equal(y_in, y_out))
    print(f"|checkout - parent| (h', y): {json.dumps(diffs)}", flush=True)
    print(f"in place equals out of place: {json.dumps(in_place)}",
          flush=True)

    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ends = [b for b in ("parent", "checkout") if b in fns]
    order = ends + [b for b in fns if b not in ends] + ends[::-1]
    # half a second of the first case brings the card to its clocks
    warm = runner(order[0], "native", *inputs[0][1:])[0]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        warm()
        torch.cuda.synchronize()
    readings = {}
    for turn in range(args.turns):
        for build_name in order:
            for name, *ops in inputs:
                for mode in MODES:
                    run = runner(build_name, mode, *ops)[0]
                    ms = smoke.library_ms(run, flush=flush)
                    readings.setdefault((build_name, name, mode),
                                        []).append(ms)
                    print(f"turn {turn} {build_name} {name} [{mode}]: "
                          f"{ms:.4f} ms", flush=True)
    traced = traced_turns({f"{b} {name} [{mode}]": runner(b, mode, *ops)[0]
                           for b in fns for name, *ops in inputs
                           for mode in MODES}, flush, args.calls, args.turns)
    resident = {}
    if "checkout" in libs:
        lib = ctypes.CDLL(str(libs["checkout"]))
        lib.uisa_ssd_decode_resident.argtypes = [ctypes.c_int] * 4
        lib.uisa_ssd_decode_resident.restype = ctypes.c_int
        n, p = inputs[0][1].shape[3:]
        resident = {mode: lib.uisa_ssd_decode_resident(
            _launch.MODE_CODES[mode], 1, n, p) for mode in MODES}
    med = medians(readings)
    result = {"card": card, "ms": med, "pct_of_native": pct_of_native(med),
              "trace_us": traced, "diff_vs_parent_h_y": diffs,
              "in_place_bitwise": in_place, "resident_blocks_per_sm":
              resident, "readings": smoke.LIBRARY_READINGS,
              "turns": args.turns, "built": sorted(libs)}
    (out_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if set(builds) == set(libs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
