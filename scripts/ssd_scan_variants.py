#!/usr/bin/env python3
"""Re-time ssd_scan (rows 12-12d of PERF.md) beside its floor, a parent
checkout's kernel and variants of ``csrc/ssd_scan_tc.cu``.

    python scripts/ssd_scan_variants.py [--parent DIR] [--turns 2]
        [--only NAME ...] [--calls 20]

Builds, all ``nvcc`` in parallel with ``_build.NVCC_FLAGS`` under
``build/ssd_scan_variants/``: ``libssd_scan`` (``ssd_scan.cu`` with
``ssd_scan_tc.cu``) as it stands (``checkout``); the same from a copy of
``csrc/`` whose ``ssd_scan_tc.cu`` is edited as :data:`VARIANTS` says
(each edit an exact text replacement, which must match once); and
``DIR``'s ``src/repro_torch/csrc/ssd_scan.cu`` (``parent``, a checkout
unpacked with ``git archive``; its entry may predate the route
argument).

On one card, on ``chip_smoke.py``'s ssd_scan inputs (mamba2-2.7b's
widths, bf16, seed 1): each case in each build (every mode in
``checkout`` and ``parent``, native in the variants) is checked against
the port's plain version of its mode with ``chip_smoke.py``'s phase-3
tolerances on y and on the state (not for the variants marked
timing-only, whose output is wrong by design), then timed as the median
of ``chip_smoke.LIBRARY_READINGS`` readings of ``chip_smoke.time_ms``
(CUDA events, L2 flushed, a mean of 10 each: ``chip_smoke.library_ms``).
The builds take turns (``parent`` first and last in every turn,
``checkout`` second and second to last, then the variants).  After the
turns, ``torch.profiler`` reads each build's native kernel's device
duration (the median over ``--calls`` calls, each after an L2 flush).
Prints a line a reading, then one JSON line of medians over the turns
(also written to ``build/ssd_scan_variants/result.json``): the card, the
medians by build, case and mode, the routes, each mode's % of native by
build, and the traced durations.  Needs one CUDA card.

The variants, one for each design choice:

- ``w_rounded``: w rounded to bf16 for w.x (one product), not split
  hi + lo (two): what the split costs;
- ``h_rounded`` (timing-only): C.h reads h rounded to bf16 (one
  product), not hi + lo; its y misses the row-relative tolerance (2.2e-2
  on row 12 on an H100), which is why h is split;
- ``p_split``: P cut over two blocks (160 blocks at B=1, each computing
  C.B^T): more SMs against C.B^T twice;
- ``phases`` (timing-only): the kernel writing the SM clock (cycles
  since its start) at each phase of its first four chunks into the state
  output (``kTcScanMarks``): the loads and the prefix sum, y (C.h and the
  chunk), the update, the barrier; the script prints each phase's cycles
  per chunk, the median over heads, for each warpgroup;
- ``no_intra`` (timing-only): no intra-chunk products (S, w.x);
- ``no_update`` (timing-only): no state update;
- ``floor`` (timing-only): the floor of the method, the kernel with no
  products at all: the chunk loads, the prefix sum, the barriers and the
  stores.

Several heads a block sharing one C.B^T (every head shares it at G = 1)
is not among them: a chunk's C and B (128 KB) and two heads' x and h tiles
(2 x 64 KB) pass the 227 KB a block can hold.
"""
import argparse
import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

MODES = ("native", "abstract", "abstract+shuffle")
#: PERF.md's row of each chip_smoke.py case
ROWS = {"ssd_scan": "12", "ssd_scan_prefill300": "12b",
        "ssd_scan_prefill128": "12c", "ssd_scan_h0": "12d"}

_NO_UPDATE = ("    if (owns_rows) {\n      const float decay",
              "    if (false) {\n      const float decay")
_NO_Y = ("    for (int pass = 0; pass < 2; ++pass) {",
         "    for (int pass = 0; pass < 0; ++pass) {")
#: variant -> [(text in ssd_scan_tc.cu, its replacement), ...]
VARIANTS = {
    "w_rounded": [("constexpr bool kTcScanWSplit = true;",
                   "constexpr bool kTcScanWSplit = false;")],
    "h_rounded": [("          wgmma_ss64<1>(yacc, desc_k(Cs, t0, kk), "
                   "desc_mn(Hlo, kk * 16));\n", "")],
    "p_split": [("constexpr int kTcScanPSplit = 1;",
                 "constexpr int kTcScanPSplit = 2;")],
    "phases": [("constexpr bool kTcScanMarks = false;",
                "constexpr bool kTcScanMarks = true;")],
    "no_intra": [("      for (int S = 0; S <= T; ++S) {",
                  "      for (int S = 0; S < 0; ++S) {")],
    "no_update": [_NO_UPDATE],
    "floor": [_NO_UPDATE, _NO_Y],
}
#: variants whose output is wrong by design (timed, not checked)
TIMING_ONLY = ("h_rounded", "phases", "no_intra", "no_update", "floor")


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"ssd_scan_variants: an edit matches "
                             f"{src.count(old)} times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, parent, out: Path) -> dict:
    """{build: library path}, every nvcc in parallel."""
    from repro_torch.kernels import _build
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dirs = {"checkout": _build.CSRC}
    if parent is not None:
        dirs["parent"] = parent / "src" / "repro_torch" / "csrc"
    header = (_build.CSRC / "ssd_scan_tc.cu").read_text()
    for name in names:
        csrc = out / name
        shutil.copytree(_build.CSRC, csrc)
        (csrc / "ssd_scan_tc.cu").write_text(
            variant_source(header, VARIANTS[name]))
        dirs[name] = csrc
    procs = {}
    for name, csrc in dirs.items():
        lib = out / f"libssd_scan_{name}.so"
        srcs = [csrc / "ssd_scan.cu", csrc / "ssd_scan_tc.cu"]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(lib), *(str(f) for f in srcs if f.exists())]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ssd_scan_variants: nvcc failed for {name}:\n"
                             f"{log}")
        (out / f"{name}.log").write_text(log)
        libs[name] = lib
    return libs


def bind(libs, parent) -> dict:
    """{build: (ctypes function, reports a route)}."""
    from repro_torch.kernels import _launch
    symbol, argtypes = _launch.SIGNATURES["ssd_scan"][:2]
    fns = {}
    for name, lib in libs.items():
        types, routed = argtypes, True
        if name == "parent":
            src = (parent / "src" / "repro_torch" / "csrc"
                   / "ssd_scan.cu").read_text()
            routed = "int* route" in src
            if not routed:
                types = argtypes[:-1]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = types, ctypes.c_int
        fns[name] = (fn, routed)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_variants: no CUDA card is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _launch, ssd
    parent = args.parent.resolve() if args.parent else None
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "build" / "ssd_scan_variants"
    t0 = time.perf_counter()
    libs = build(args.only, parent, out_dir)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    fns = bind(libs, parent)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cfg = get_config("mamba2-2.7b")
    q = cfg.ssm.chunk_size
    inputs = [(f"{ROWS[case['name']]} {case['name']}", *case["operands"])
              for case in smoke.ssd_kernel_cases(ssd, dev, cfg)
              if case["counter"] == "ssd_scan"]

    def runner(build_name, mode, x, dt, A, B, C, h0):
        """A call of ``build_name``'s kernel, its outputs and route."""
        fn, routed = fns[build_name]
        b, l, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        y = torch.empty_like(x)
        hf = torch.empty(b, g, h // g, n, p, dtype=torch.float32, device=dev)
        route = ctypes.c_int(-1)
        call = (_launch.MODE_CODES[mode], 1, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                hf.data_ptr(), b, l, h, g, n, p, min(q, l), x.stride(0),
                x.stride(1), B.stride(0), B.stride(1), C.stride(0),
                C.stride(1), stream) + ((ctypes.byref(route),) if routed
                                        else ())

        def run():
            err = fn(*call)
            if err:
                raise RuntimeError(f"{build_name}: CUDA error {err}")
        return run, y, hf, route

    def check(build_name, name, mode, x, dt, A, B, C, h0):
        run, y, hf, route = runner(build_name, mode, x, dt, A, B, C, h0)
        run()
        torch.cuda.synchronize()
        y_ref, hf_ref = ssd.ssd_scan_plain(x, dt, A, B, C, h0, chunk=q,
                                           mode=mode)
        errs = [smoke.compare(o, r) for o, r in ((y, y_ref), (hf, hf_ref))]
        ok = all(e[1] <= smoke.TOL_ROW and e[2] <= smoke.TOL_RMS
                 for e in errs)
        if not ok and build_name not in TIMING_ONLY:
            raise SystemExit(f"ssd_scan_variants: {build_name} {name} "
                             f"[{mode}] disagrees with its plain version "
                             f"({errs})")
        return run, (_launch.ROUTES.get(route.value)
                     if route.value >= 0 else None), errs

    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    builds = (["parent"] if parent else []) + ["checkout", *args.only] \
        + ["checkout"] + (["parent"] if parent else [])
    readings, routes, errors = {}, {}, {}

    def record(key, ms, what):
        readings.setdefault(key, []).append(ms)
        print(f"{what}: {ms:.4f} ms", flush=True)

    # half a second of the first case brings the card to its clocks
    warm = runner("checkout", "native", *inputs[0][1:])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        warm()
        torch.cuda.synchronize()
    for turn in range(args.turns):
        for build_name in builds:
            modes = MODES if build_name in ("checkout", "parent") \
                else ("native",)
            for name, *ops in inputs:
                for mode in modes:
                    run, route, errs = check(build_name, name, mode, *ops)
                    routes[(build_name, name, mode)] = route
                    errors[(build_name, name, mode)] = errs
                    record((build_name, name, mode),
                           smoke.library_ms(run, flush=flush),
                           f"turn {turn} {build_name} {name} [{mode}] "
                           f"route {route}")

    # device durations from the profiler: each call after an L2 flush
    traced = {}
    for build_name in dict.fromkeys(builds):
        for name, *ops in inputs:
            run = runner(build_name, "native", *ops)[0]
            traced[f"{build_name} {name}"] = trace_us(
                run, flush, args.calls, profile, ProfilerActivity)

    # the phases build: cycles per phase and chunk, median over heads
    phases = {}
    if "phases" in fns:
        names = ("loads+prefix", "y", "update", "to barrier")
        for name, *ops in inputs:
            run, _, hf, _ = runner("phases", "native", *ops)
            run()
            torch.cuda.synchronize()
            x = ops[0]
            n_chunks = -(-x.shape[1] // min(q, x.shape[1]))
            marks = hf.reshape(x.shape[2], -1)[:, :64].reshape(
                -1, 2, 4, 8)[..., :5].float().cpu()
            per = {}
            for wg in range(2):
                for c in range(min(n_chunks, 4)):
                    d = (marks[:, wg, c, 1:] - marks[:, wg, c, :-1]
                         ).median(dim=0).values.tolist()
                    per[f"wg{wg} chunk{c}"] = dict(zip(names, d))
            phases[name] = per
            print(f"phases {name}: {json.dumps(per)}", flush=True)

    med = {}
    for (build_name, name, mode), v in readings.items():
        med.setdefault(build_name, {}).setdefault(name, {})[mode] = \
            statistics.median(v)
    pct = {b: {n: {m: 100.0 * v["native"] / v[m] for m in v if m != "native"}
               for n, v in cases.items() if len(v) > 1}
           for b, cases in med.items() if b in ("checkout", "parent")}
    result = {"card": card, "ms": med, "pct_of_native": pct,
              "routes": {f"{b} {n} [{m}]": r
                         for (b, n, m), r in routes.items()},
              "errors_y_state": {f"{b} {n} [{m}]": e
                                 for (b, n, m), e in errors.items()},
              "trace_us": traced, "phase_cycles": phases,
              "readings": smoke.LIBRARY_READINGS,
              "turns": args.turns}
    (out_dir / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def trace_us(fn, flush, calls, profile, activity) -> dict:
    """Median device duration (us) of the kernel of one call of ``fn``,
    over ``calls`` calls each after an L2 flush, from ``torch.profiler``;
    None where the trace shows no kernel of the call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[activity.CUDA]) as prof:
        for _ in range(calls):
            flush.amax()
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "kernel" and "uisa::" in e["name"]]
    durs = [e["dur"] for e in events]
    if not durs:
        return None
    return {"us": statistics.median(durs), "us_min": min(durs),
            "kernels": len(durs), "name": events[0]["name"][:80]}


if __name__ == "__main__":
    raise SystemExit(main())
