#!/usr/bin/env python3
"""Re-time the Table V histogram (rows 11-11d of PERF.md) in every mode
beside a parent checkout's kernels and variants of ``csrc/histogram.cu``.

    python scripts/histogram_variants.py [--parent DIR] [--turns 2]
        [--only NAME ...] [--calls 20]

Builds, all ``nvcc`` in parallel with ``_build.NVCC_FLAGS`` (and
``-Xptxas -v``: each build's log under ``build/histogram_variants/``):
``histogram.cu`` as it stands (``checkout``); copies edited as
:data:`VARIANTS` says; ``DIR``'s ``src/repro_torch/csrc/histogram.cu``
(``parent``, a checkout unpacked with ``git archive``; its entry may take
the tile, 65,536 values a block).  A build that does not compile is
reported and left out (the script then exits 1 after the rest).

On one card, on Table V's inputs (``tablev.make_inputs``, seed 0: 2^24
int32 values into 256 bins, every value in one bin, and the 256-bin
values from a base off 16 bytes), in every mode of every build: each
output is held to the exact clipped counts (``tablev.check_histogram``;
not the timing-only variant's),
then timed as the median of ``chip_smoke.LIBRARY_READINGS`` readings of
``chip_smoke.time_ms`` (CUDA events, L2 flushed, a mean of 10 each), the
builds in turns (``parent`` first and last in every turn, ``checkout``
second and second to last, then the variants), as is ``torch.bincount``
of the clipped values once a case.  After them ``torch.profiler`` reads
each one's device duration in ``--turns`` turns of one trace each (a
turn's median over ``--calls`` calls, each after an L2 flush; the median
of the turns' medians beside each turn's).

Prints a line a reading, then one JSON line (also
``build/histogram_variants/result.json``): the card, the medians and
device durations by build, case and mode, each mode's % of native by
build and case (Table V's measure, native timed in the same call), the
library's medians and the checkout's grid by mode
(``uisa_histogram_grid``).  Needs one CUDA card.

The variants:

- ``loads8``: 8 values a thread a tile, not 16 (a tile of 2,048);
- ``tile_grid``: one block a tile (4,096 blocks at 2^24), not the
  resident blocks walking the tiles: each block merges its private counts
  after 4,096 values;
- ``native_elements``: native by element loads at any base, not 16-byte
  vectors where the base allows them;
- ``no_ahead``: a thread loads a tile only once it has counted the one
  before (one tile in registers, not two);
- ``nc``: loads through the non-coherent path (``ld.global.nc``, as
  ``__ldg``), not evict-first;
- ``chunked``: block b walks a contiguous run of tiles, not b, b + grid,
  ...;
- ``no_cap``: every block that fits an SM in the grid, in every mode
  (abstract takes at most 3 an SM, native 2);
- ``cap2``, ``cap3``: at most 2 or 3 blocks an SM in every mode;
- ``loads32``: 32 values a thread a tile, not 16;
- ``flush_unroll4``: abstract+shuffle's flush unrolled by four words, so
  four words' trees interleave;
- ``no_flush`` (timing-only: its 8-bit counts overflow): abstract+shuffle
  flushing once, after its last tile: the flushes' share of its time;
- ``checked_tiles``: every value's index checked against n, not only in
  the ragged last tile.
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
#: Table V's inputs (tablev.make_inputs) and PERF.md's rows
CASES = {"v": "11 256 bins", "hot": "11c one bin", "v_off": "11 off 16 B"}
BINS = 256
#: variant -> [(text in histogram.cu, its replacement)]
VARIANTS = {
    "loads8": [("constexpr int kHistLoads = 16;",
                "constexpr int kHistLoads = 8;")],
    "tile_grid": [("  *grid = (int)(tiles < resident ? tiles : resident);",
                   "  *grid = (int)tiles;")],
    "native_elements": [("  if (MODE == kHistNative && vector_ok) {",
                         "  if (false) {")],
    "no_ahead": [(
        "  E q[kLoads], ahead[kLoads];\n"
        "  auto load = [&](long long t, E (&r)[kLoads]) {\n"
        "#pragma unroll\n"
        "    for (int u = 0; u < kLoads; ++u) {\n"
        "      const long long i = t * kTile + u * kHistThreads + threadIdx.x;\n"
        "      load_cs(r[u], v + (i < n ? i : 0), i < n);\n"
        "    }\n"
        "  };\n"
        "  load(blockIdx.x, ahead);\n"
        "  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
        "#pragma unroll\n"
        "    for (int u = 0; u < kLoads; ++u) q[u] = ahead[u];\n"
        "    load(t + gridDim.x, ahead);\n",
        "  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
        "    E q[kLoads];\n"
        "#pragma unroll\n"
        "    for (int u = 0; u < kLoads; ++u) {\n"
        "      const long long i = t * kTile + u * kHistThreads + threadIdx.x;\n"
        "      load_cs(q[u], v + (i < n ? i : 0), i < n);\n"
        "    }\n")],
    "nc": [("@q ld.global.cs.b32", "@q ld.global.nc.b32"),
           ("@q ld.global.cs.v4.b32", "@q ld.global.nc.v4.b32")],
    "chunked": [
        ("  const long long tiles = (n + kTile - 1) / kTile;",
         "  const long long all = (n + kTile - 1) / kTile;\n"
         "  const long long per = (all + gridDim.x - 1) / gridDim.x;\n"
         "  const long long first = blockIdx.x * per;\n"
         "  const long long tiles = all < first + per ? all : first + per;"),
        ("  load(blockIdx.x, ahead);", "  load(first, ahead);"),
        ("  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {",
         "  for (long long t = first; t < tiles; ++t) {"),
        ("    load(t + gridDim.x, ahead);",
         "    load(t + 1 < tiles ? t + 1 : all, ahead);")],
    "no_cap": [("constexpr int kHistBlocksPerSM[3] = {3, 0, 2};",
                "constexpr int kHistBlocksPerSM[3] = {0, 0, 0};")],
    "cap2": [("constexpr int kHistBlocksPerSM[3] = {3, 0, 2};",
              "constexpr int kHistBlocksPerSM[3] = {2, 2, 2};")],
    "cap3": [("constexpr int kHistBlocksPerSM[3] = {3, 0, 2};",
              "constexpr int kHistBlocksPerSM[3] = {3, 3, 3};")],
    "loads32": [("constexpr int kHistLoads = 16;",
                 "constexpr int kHistLoads = 32;")],
    "flush_unroll4": [("    for (int j = 0; j < kn; ++j) {",
                       "#pragma unroll 4\n    for (int j = 0; j < kn; ++j) {")],
    "no_flush": [("    if (++since == kFlushTiles) {", "    if (false) {")],
    "checked_tiles": [("    if ((t + 1) * kTile <= n) {",
                       "    if (false) {")],
}
#: variants whose counts are wrong by design (timed, not checked)
TIMING_ONLY = ("no_flush",)
#: the parent's entry, where it still takes the tile
PARENT_TILE = 512 * 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("histogram_variants: no CUDA card is available",
              file=sys.stderr)
        return 2
    smoke = load_smoke()
    from repro_torch.benchmarks import tablev
    from repro_torch.kernels import _build, _launch
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "build" / "histogram_variants"
    builds = {"checkout": (_build.CSRC, None)}
    builds.update({v: (_build.CSRC, VARIANTS[v]) for v in args.only})
    if args.parent is not None:
        parent_csrc = args.parent.resolve() / "src" / "repro_torch" / "csrc"
        builds["parent"] = (parent_csrc, None)
    t0 = time.perf_counter()
    libs = build("histogram", builds, out_dir)
    print(f"build: {time.perf_counter() - t0:.1f} s, built {sorted(libs)}",
          flush=True)
    fns, tiled = {}, {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        src = (builds[name][0] / "histogram.cu").read_text()
        tiled[name] = "long long tile, int bins" in src
        fn = ctypes.CDLL(str(lib)).uisa_histogram
        fn.argtypes = ([I, P, LL, LL, I, P, P] if tiled[name]
                       else [I, P, LL, I, P, P])
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream(dev).cuda_stream
    inp = tablev.make_inputs(dev, seed=0)
    inputs = {key: inp[key] for key in CASES}
    del inp

    def runner(build_name, mode, v):
        out = torch.empty(BINS, dtype=torch.int32, device=dev)
        call = ((_launch.MODE_CODES[mode], v.data_ptr(), v.numel())
                + ((PARENT_TILE,) if tiled[build_name] else ())
                + (BINS, out.data_ptr(), stream))

        def run():
            err = fns[build_name](*call)
            if err:
                raise RuntimeError(f"{build_name}: CUDA error {err}")
        return run, out

    for build_name in fns:
        for key, v in inputs.items():
            for mode in MODES:
                run, out = runner(build_name, mode, v)
                run()
                torch.cuda.synchronize()
                if build_name not in TIMING_ONLY:
                    tablev.check_histogram(out, v, BINS, f"{build_name} "
                                           f"{CASES[key]} [{mode}]")
    print("every checked build's counts exact in every case and mode",
          flush=True)

    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ends = [b for b in ("parent", "checkout") if b in fns]
    order = ends + [b for b in fns if b not in ends] + ends[::-1]
    warm = runner(order[0], "native", inputs["v"])[0]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        warm()
        torch.cuda.synchronize()
    readings, library = {}, {}
    for turn in range(args.turns):
        for build_name in order:
            for key, v in inputs.items():
                for mode in MODES:
                    ms = smoke.library_ms(runner(build_name, mode, v)[0],
                                          flush=flush)
                    readings.setdefault((build_name, CASES[key], mode),
                                        []).append(ms)
                    print(f"turn {turn} {build_name} {CASES[key]} [{mode}]: "
                          f"{ms:.4f} ms", flush=True)
    for key, v in inputs.items():
        library[CASES[key]] = smoke.library_ms(
            lambda v=v: torch.bincount(v.clamp(0, BINS - 1),
                                       minlength=BINS), flush=flush)
    traced = traced_turns({f"{b} {CASES[key]} [{mode}]": runner(b, mode, v)[0]
                           for b in fns for key, v in inputs.items()
                           for mode in MODES}, flush, args.calls, args.turns)
    grid = {}
    if "checkout" in libs:
        fn = ctypes.CDLL(str(libs["checkout"])).uisa_histogram_grid
        fn.argtypes, fn.restype = [I, LL, I], LL
        grid = {mode: fn(_launch.MODE_CODES[mode], inputs["v"].numel(), BINS)
                for mode in MODES}
    med = medians(readings)
    result = {"card": card, "ms": med, "pct_of_native": pct_of_native(med),
              "library_ms": library, "trace_us": traced, "grid": grid,
              "readings": smoke.LIBRARY_READINGS, "turns": args.turns,
              "built": sorted(libs)}
    (out_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if set(builds) == set(libs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
