#!/usr/bin/env python3
"""Re-time the row norms (rows 5, 5b, 7-7h of PERF.md) beside their floor,
a parent checkout's kernels and variants of ``csrc/row_norm.cuh``.

    python scripts/row_norm_variants.py [--parent DIR] [--turns 2]
        [--only NAME ...] [--calls 20]

Builds, all ``nvcc`` in parallel with ``_build.NVCC_FLAGS`` under
``build/row_norm_variants/``: ``rmsnorm.cu`` and ``add_rmsnorm.cu`` as
they stand (``checkout``); the same from a copy of ``csrc/`` whose
``row_norm.cuh`` is edited as :data:`VARIANTS` says (each edit an exact
text replacement, which must match once); the two sources of ``DIR``'s
``src/repro_torch/csrc`` (``parent``, a checkout unpacked with ``git
archive``; its entries may predate the route argument); and
:data:`FLOOR_SOURCE`, the floor of the method: an empty kernel, and a
kernel that only loads w (D elements by 16-byte loads, one block).

On one card, on bf16 inputs from seed 0: each case of :data:`CASES` in
each build (every mode in ``checkout`` and ``parent``, native in the
variants) is checked against the port's plain version of its mode with
``chip_smoke.py``'s phase-3 tolerances (add_rmsnorm's sum bit for bit;
not for the variants marked timing-only, whose output is wrong by
design), then timed as the median of ``chip_smoke.LIBRARY_READINGS``
readings of ``chip_smoke.time_ms`` (CUDA events, L2 flushed, a mean of
10 each: ``chip_smoke.library_ms``), as are its library call
(``F.rms_norm``; add_rmsnorm: the add, then ``F.rms_norm``) and the
floor kernels.  The builds take turns (``parent`` first and last in
every turn, ``checkout`` second and second to last, then the variants).
After the turns, ``torch.profiler`` reads each native kernel's device
duration (the median over ``--calls`` calls, each after an L2 flush)
in ``parent``, ``checkout``, ``loop``, ``loop_pass1``, ``w_with_x`` and
the floor.
Prints a line a reading, then one JSON line of medians over the turns
(also written to ``build/row_norm_variants/result.json``): the card, the
medians by build, case and mode, the library's, the floor's, each
mode's % of native by build, and the traced durations.  Needs one CUDA
card.

The variants, one for each design choice:

- ``loop``: the loop route for every row (one warp a row, two passes:
  the schedule before the one-pass routes), one pass against two;
- ``loop_pass1`` (timing-only): the loop route stopped after pass 1 and
  its moment (pass 2 walks nothing): the parent's time split into its
  first load chain and the second;
- ``w_with_x``, ``w_after_moment``: w loaded with x for every row, or
  after the moment for every row (the checkout loads it late only at a
  prefill of rows of two slots a thread or more): loads ahead against
  loads after;
- ``chained_slots``: each slot's loads wait for the slot before it (an
  address that depends on the previous slot's data), as a loop's loads
  do (only rows of more than one slot a thread: 5120);
- ``threads_128``, ``threads_256``, ``threads_1024``: at most 128, 256
  or 1024 threads a row, not 512 (warps a row: fewer threads holding
  more slots each, or more threads);
- ``two_rows_a_block``: rows of 128 to 256 threads packed two to a block
  (rows packed a block at prefill).
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

#: (PERF.md row, kernel, rows, D): bf16, the shapes of chip_smoke.py's
#: granite-moe and mamba2 row-norm cases
CASES = [("7", "rmsnorm", 8, 1536), ("7b", "rmsnorm", 300, 1536),
         ("7b", "rmsnorm", 512, 1536), ("7c", "rmsnorm", 300, 1539),
         ("7d", "rmsnorm", 7, 1536), ("7e", "rmsnorm", 8, 2560),
         ("7f", "rmsnorm", 512, 2560), ("7g", "rmsnorm", 8, 5120),
         ("7h", "rmsnorm", 512, 5120), ("5", "add_rmsnorm", 8, 1536),
         ("5b", "add_rmsnorm", 300, 1536), ("5b", "add_rmsnorm", 512, 1536)]
MODES = ("native", "abstract", "abstract+shuffle")
EPS = 1e-6

FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace uisa {
__global__ void floor_empty_kernel() {}
// each thread loads one 16-byte slot of w; the sink keeps the loads alive
__global__ void floor_load_w_kernel(const uint4* __restrict__ w, int slots,
                                    unsigned* sink) {
  const int t = threadIdx.x;
  const uint4 v = t < slots ? w[t] : make_uint4(0u, 0u, 0u, 0u);
  if ((v.x ^ v.y ^ v.z ^ v.w) == 0x9e3779b9u) *sink = t;
}
}  // namespace uisa
extern "C" int floor_empty(void* st) {
  uisa::floor_empty_kernel<<<1, 32, 0, (cudaStream_t)st>>>();
  return (int)cudaGetLastError();
}
extern "C" int floor_load_w(const void* w, int slots, void* sink, void* st) {
  uisa::floor_load_w_kernel<<<1, (slots + 31) / 32 * 32, 0,
                              (cudaStream_t)st>>>((const uint4*)w, slots,
                                                  (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""

_FORCE_LOOP = ("  for (int nv = 1; nv <= kRowMaxSlots; nv *= 2) {",
               "  for (int nv = 1; nv <= 0; nv *= 2) {")
#: variant -> [(text in row_norm.cuh, its replacement), ...]
VARIANTS = {
    "loop": [_FORCE_LOOP],
    "loop_pass1": [
        _FORCE_LOOP,
        ("  const float inv = rsqrtf(ss / (float)D + eps);\n"
         "  for (int i = lane * V; i < D; i += 32 * V) {",
         "  const float inv = rsqrtf(ss / (float)D + eps);\n"
         "  if (inv == -1.f) out[base] = from_f<T>(inv);\n"
         "  for (int i = D; i < D; i += 32 * V) {")],
    "w_with_x": [("            M > kRowLateW && nv > 1};",
                  "            false};")],
    "w_after_moment": [("            M > kRowLateW && nv > 1};",
                        "            true};")],
    "chained_slots": [
        ("    const int e0 = (t + k * nt) * G;\n"
         "    xv[k] = rv[k] = wv[k] = make_uint4(0u, 0u, 0u, 0u);\n",
         "    int dep = 0;\n"
         "    if (k > 0) asm volatile(\"and.b32 %0, %1, 0;\" : \"=r\"(dep)"
         " : \"r\"(xv[k > 0 ? k - 1 : 0].x));\n"
         "    const int e0 = (t + k * nt) * G + dep;\n"
         "    xv[k] = rv[k] = wv[k] = make_uint4(0u, 0u, 0u, 0u);\n")],
    "threads_128": [("constexpr int kRowMaxThreads = 512;",
                     "constexpr int kRowMaxThreads = 128;")],
    "threads_256": [("constexpr int kRowMaxThreads = 512;",
                     "constexpr int kRowMaxThreads = 256;")],
    "threads_1024": [("constexpr int kRowMaxThreads = 512;",
                      "constexpr int kRowMaxThreads = 1024;")],
    "two_rows_a_block": [
        ("    const int rows = threads >= kRowPackThreads\n"
         "                         ? 1\n",
         "    const int rows = threads >= kRowPackThreads\n"
         "                         ? (threads <= 256 ? 2 : 1)\n")],
}
#: variants whose output is wrong by design (timed, not checked)
TIMING_ONLY = ("loop_pass1",)


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"row_norm_variants: an edit matches "
                             f"{src.count(old)} times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, parent, out: Path) -> dict:
    """{(build, kernel): library path}, every nvcc in parallel."""
    from repro_torch.kernels import _build
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dirs = {"checkout": _build.CSRC}
    if parent is not None:
        dirs["parent"] = parent / "src" / "repro_torch" / "csrc"
    header = (_build.CSRC / "row_norm.cuh").read_text()
    for name in names:
        csrc = out / name
        shutil.copytree(_build.CSRC, csrc)
        (csrc / "row_norm.cuh").write_text(
            variant_source(header, VARIANTS[name]))
        dirs[name] = csrc
    (out / "floor.cu").write_text(FLOOR_SOURCE)
    jobs = {("floor", "floor"): out / "floor.cu"}
    for name, csrc in dirs.items():
        for kernel in ("rmsnorm", "add_rmsnorm"):
            jobs[(name, kernel)] = csrc / f"{kernel}.cu"
    procs = {}
    for (name, kernel), cu in jobs.items():
        lib = out / f"lib{kernel}_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(cu.parent),
               "-o", str(lib), str(cu)]
        procs[(name, kernel)] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"row_norm_variants: nvcc failed for {key}:\n"
                             f"{log}")
        libs[key] = lib
    return libs


def bind(libs, parent) -> dict:
    """{(build, kernel): (ctypes function, reports a route)}."""
    from repro_torch.kernels import _launch
    fns = {}
    for (name, kernel), lib in libs.items():
        if name == "floor":
            continue
        symbol, argtypes = _launch.SIGNATURES[kernel][:2]
        routed = True
        if name == "parent":
            src = (parent / "src" / "repro_torch" / "csrc"
                   / f"{kernel}.cu").read_text()
            routed = "int* route" in src
            if not routed:
                argtypes = argtypes[:-1]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(name, kernel)] = (fn, routed)
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
        print("row_norm_variants: no CUDA card is available",
              file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _launch, fused, rmsnorm
    parent = args.parent.resolve() if args.parent else None
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    libs = build(args.only, parent, ROOT / "build" / "row_norm_variants")
    fns = bind(libs, parent)
    floor_lib = ctypes.CDLL(str(libs[("floor", "floor")]))
    floor_lib.floor_empty.argtypes = [ctypes.c_void_p]
    floor_lib.floor_load_w.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    inputs = []
    for row, kernel, m, d in CASES:
        x = torch.randn(m, d, generator=g, device=dev).to(bf)
        r = (torch.randn(m, d, generator=g, device=dev) * 0.5).to(bf)
        w = (1.0 + torch.randn(d, generator=g, device=dev) * 0.1).to(bf)
        inputs.append((f"{row} {kernel} [{m},{d}]", kernel, x, r, w))
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def runner(build_name, kernel, mode, x, r, w):
        """A call of ``build_name``'s kernel and its outputs."""
        fn, routed = fns[(build_name, kernel)]
        out, summed = torch.empty_like(x), torch.empty_like(x)
        route = ctypes.c_int(-1)
        tail = (ctypes.byref(route),) if routed else ()
        head = (_launch.MODE_CODES[mode], 1)
        if kernel == "rmsnorm":
            call = (*head, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    x.shape[0], x.shape[1], EPS, stream, *tail)
        else:
            call = (*head, x.data_ptr(), r.data_ptr(), w.data_ptr(),
                    out.data_ptr(), summed.data_ptr(), x.shape[0],
                    x.shape[1], EPS, stream, *tail)

        def run():
            err = fn(*call)
            if err:
                raise RuntimeError(f"{build_name} {kernel}: CUDA error {err}")
        return run, out, summed, route

    def check(build_name, name, kernel, mode, x, r, w):
        run, out, summed, route = runner(build_name, kernel, mode, x, r, w)
        run()
        torch.cuda.synchronize()
        if kernel == "rmsnorm":
            want, parts = rmsnorm.rmsnorm_plain(x, w, eps=EPS, mode=mode), None
        else:
            want, want_s = fused.add_rmsnorm_plain(x, r, w, eps=EPS,
                                                   mode=mode)
            parts = torch.equal(summed, want_s)
        _, row_err, rms_err = smoke.compare(out, want)
        ok = (row_err <= smoke.TOL_ROW and rms_err <= smoke.TOL_RMS
              and parts is not False)
        if not ok and build_name not in TIMING_ONLY:
            raise SystemExit(f"row_norm_variants: {build_name} {name} "
                             f"[{mode}] disagrees with its plain version "
                             f"({row_err}, {rms_err}, sum equal: {parts})")
        return run, (_launch.ROUTES.get(route.value)
                     if route.value >= 0 else None)

    flush = torch.zeros(smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    builds = (["parent"] if parent else []) + ["checkout", *args.only] \
        + ["checkout"] + (["parent"] if parent else [])
    readings, routes = {}, {}

    def record(key, ms, what):
        readings.setdefault(key, []).append(ms)
        print(f"{what}: {ms:.4f} ms", flush=True)

    # half a second of the first case brings the card to its clocks
    warm = runner("checkout", "rmsnorm", "native", *inputs[0][2:])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        warm()
        torch.cuda.synchronize()
    for turn in range(args.turns):
        for d in sorted({c[3] for c in CASES}):
            w = inputs[[c[3] for c in CASES].index(d)][4]
            slots = -(-d // 8)
            record(("floor", f"load_w [{d}]", "native"), smoke.library_ms(
                lambda w=w, s=slots: floor_lib.floor_load_w(
                    w.data_ptr(), s, sink.data_ptr(), stream), flush=flush),
                f"turn {turn} floor load_w [{d}]")
        record(("floor", "empty", "native"), smoke.library_ms(
            lambda: floor_lib.floor_empty(stream), flush=flush),
            f"turn {turn} floor empty")
        for build_name in builds:
            modes = MODES if build_name in ("checkout", "parent") \
                else ("native",)
            for name, kernel, x, r, w in inputs:
                for mode in modes:
                    run, route = check(build_name, name, kernel, mode, x, r,
                                       w)
                    routes[(build_name, name, mode)] = route
                    record((build_name, name, mode),
                           smoke.library_ms(run, flush=flush),
                           f"turn {turn} {build_name} {name} [{mode}] "
                           f"route {route}")
        for name, kernel, x, r, w in inputs:
            d = x.shape[1]
            if kernel == "rmsnorm":
                def lib(x=x, w=w, d=d):
                    return F.rms_norm(x, (d,), w, EPS)
            else:
                def lib(x=x, r=r, w=w, d=d):
                    return F.rms_norm(x + r, (d,), w, EPS)
            record(("library", name, "native"),
                   smoke.library_ms(lib, flush=flush),
                   f"turn {turn} library {name}")

    # device durations from the profiler: each call after an L2 flush
    traced = {}
    trace_builds = [b for b in ("parent", "checkout", "loop", "loop_pass1",
                                "w_with_x") if b in builds]
    for build_name in trace_builds:
        for name, kernel, x, r, w in inputs:
            run = runner(build_name, kernel, "native", x, r, w)[0]
            traced[f"{build_name} {name}"] = trace_us(
                run, flush, args.calls, profile, ProfilerActivity)
    for d in sorted({c[3] for c in CASES}):
        w = inputs[[c[3] for c in CASES].index(d)][4]
        traced[f"floor load_w [{d}]"] = trace_us(
            lambda w=w, s=-(-d // 8): floor_lib.floor_load_w(
                w.data_ptr(), s, sink.data_ptr(), stream),
            flush, args.calls, profile, ProfilerActivity)
    traced["floor empty"] = trace_us(lambda: floor_lib.floor_empty(stream),
                                     flush, args.calls, profile,
                                     ProfilerActivity)

    med = {}
    for (build_name, name, mode), v in readings.items():
        med.setdefault(build_name, {}).setdefault(name, {})[mode] = \
            statistics.median(v)
    pct = {b: {n: {m: 100.0 * v["native"] / v[m] for m in v if m != "native"}
               for n, v in cases.items() if "native" in v and len(v) > 1}
           for b, cases in med.items() if b in ("checkout", "parent")}
    result = {"card": card, "ms": med, "pct_of_native": pct,
              "routes": {f"{b} {n} [{m}]": r
                         for (b, n, m), r in routes.items()},
              "trace_us": traced, "readings": smoke.LIBRARY_READINGS,
              "turns": args.turns}
    (ROOT / "build" / "row_norm_variants" / "result.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def trace_us(fn, flush, calls, profile, activity) -> dict:
    """Median device duration (us) of the kernels of one call of ``fn``,
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
