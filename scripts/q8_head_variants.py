#!/usr/bin/env python3
"""Time and check the int8 twin's two float heads, quantized per call
inside the decode GEMV (rows 6q and 6p), beside variants of their source
and a parent checkout.

    python scripts/q8_head_variants.py [--parent DIR] [--turns 2]
                                       [--only NAME ...]

Copies ``src/repro_torch/csrc/`` once as it stands and once per variant
into ``build/q8_head_variants/<name>/``, edits the copy as
:data:`VARIANTS` says (each edit an exact text replacement of one header,
which must match once), and builds each copy's ``rmsnorm_matmul.cu`` with
``_build.NVCC_FLAGS``, all ``nvcc`` in parallel; ``--parent DIR`` builds
``DIR/src/repro_torch/csrc/rmsnorm_matmul.cu`` too (a parent commit
unpacked with ``git archive``).  Each build's C entries are bound in turn
under this checkout's wrappers: a parent library refuses the float-weight
code in its workspace query, so the wrapper quantizes in PyTorch first
and runs the parent's int8 route, the parent's path.

The heads, from seed 0, on one card: granite-8b's bf16 ``lm_head``
(x [8, 4096] bf16 @ W [4096, 49152] bf16, 6q) and granite-moe's tied f32
table (x [8, 1536] bf16 @ the transposed view of [49155, 1536] f32, 6p).
For each build, head and mode: the route taken, the largest |kernel -
plain| over the largest |plain| (plain: ``quantize_weight``, then
``rmsnorm_matmul_q8_plain``), and the median time of 20 calls after 3, L2
flushed (``tablev.time_ms``); the builds take turns (the checkout first
and again last in every turn).  Once per build and head, native: the
mean device time of each kernel of one call over 10 calls
(``torch.profiler``).  The library call (``quantize_weight``,
dequantize, ``F.rms_norm``, the bf16 product) is timed in every turn.
Prints one line per reading and a JSON line of medians over the turns,
with the card's name and power limit.  Needs one CUDA card.

The variants:

- ``two_read``: the bf16 [K, N] head on the two passes (``q8_scales_kernel``
  into the workspace, then ``norm_gemv_mma_kernel`` quantizing in its
  stream: W read twice from DRAM), not the strip kernel;
- ``strip_forward``: the strip kernel's pass 1 walks each K chunk
  forwards, as pass 0 does (the boxes read first, the likeliest to have
  left L2, come first);
- ``strip_96``: the strip kernel on 96 blocks, not one an SM (48 MB of
  strips live in L2 at a time, not 67);
- ``t_two_read``: the table on the two passes (``q8_scales_t_kernel``,
  then ``norm_gemv_t_kernel`` quantizing in its stream), not its strip
  kernel;
- ``stream``: both strip kernels with pass 1's arithmetic taken out (the
  loads, the waits and pass 0 kept; the output wrong): what their streams
  alone take;
- ``fdiv``: the quotient of ``gemv_quant`` by ``__fdiv_rn(w, s)`` (the
  IEEE division routine, a reciprocal and its checks per weight), not the
  reciprocal computed once a channel and two FMA corrections.
"""
import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: variant -> [(header, text in it, its replacement), ...]
VARIANTS = {
    "two_read": [("norm_gemv_q.cuh",
                  "  return (N + QSTRIP_COLS - 1) / QSTRIP_COLS >= sms;",
                  "  return false;")],
    "strip_forward": [("norm_gemv_q.cuh",
                       "    return kb + ((j / nst) % 2 ? nst - 1 - i : i) "
                       "* SR;",
                       "    return kb + i * SR;")],
    "strip_96": [("norm_gemv_q.cuh",
                  "  cfg.gridDim = dim3(sms);",
                  "  cfg.gridDim = dim3(sms < 96 ? sms : 96);")],
    "t_two_read": [("norm_gemv_t.cuh",
                    "  return bytes <= GEMV_TQ_ROOM ? bytes : 0;",
                    "  return 0;")],
    "stream": [("norm_gemv_q.cuh",
                "      for (int t = 0; t < SR / 16; ++t) {\n"
                "        const int r = t * 16 + (lane & 7) + (mat >> 1) * 8;",
                "      for (int t = 0; t < 0; ++t) {\n"
                "        const int r = t * 16 + (lane & 7) + (mat >> 1) * 8;"),
               ("norm_gemv_t.cuh",
                "#pragma unroll 2\n"
                "      for (int v = v0 + lane; v < v1; v += 32) {",
                "      for (int v = v1; v < v1; v += 32) {")],
    "fdiv": [("norm_gemv.cuh",
              "  float q = __fmul_rn(w, y);\n"
              "  q = fmaf(fmaf(-s, q, w), y, q);\n"
              "  q = fmaf(fmaf(-s, q, w), y, q);\n",
              "  float q = __fdiv_rn(w, s);\n")],
}
ENTRIES = ("rmsnorm_matmul", "rmsnorm_matmul_workspace", "q8_scales")
SLOTS = 8


def edited(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"q8_head_variants: an edit of {what} matches "
                         f"{text.count(old)} times, not once: {old[:60]!r}")
    return text.replace(old, new)


def build(names, parent, out: Path) -> dict:
    """{build name: library path}, every nvcc in parallel; a build that
    fails is reported and left out."""
    from repro_torch.kernels import _build
    procs = {}
    sources = {"checkout": _build.CSRC, **{n: _build.CSRC for n in names}}
    if parent is not None:
        sources["parent"] = parent / "src" / "repro_torch" / "csrc"
    for name, src in sources.items():
        csrc = out / name
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(src, csrc)
        for header, old, new in VARIANTS.get(name, ()):
            path = csrc / header
            path.write_text(edited(path.read_text(), old, new, name))
        lib = out / f"librmsnorm_matmul_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / "rmsnorm_matmul.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            print(f"q8_head_variants: nvcc failed for {name}:\n{log}",
                  flush=True)
            continue
        regs = sum("Used" in line for line in log.splitlines())
        print(f"{name}: built ({regs} kernels)", flush=True)
        libs[name] = lib
    return libs


def bind(lib: Path) -> dict:
    """The entries of ``lib`` that it has, as ctypes functions."""
    from repro_torch.kernels import _launch
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ENTRIES:
        symbol, argtypes, *rest = _launch.SIGNATURES[entry]
        fn = getattr(cdll, symbol, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = rest[1] if rest else ctypes.c_int
        fns[entry] = fn
    return fns


def kernel_ms(fn, calls: int = 10) -> dict:
    """{kernel name: mean device ms a call} over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        out[e.key[:90]] = us / 1e3 / calls
    return out


def heads(dev):
    """{row: (x, w, head)} from seed 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)
    out = {}
    x, w = rand(SLOTS, 4096), rand(4096)
    out["6q granite-8b lm_head"] = (x, w, rand(4096, 49152,
                                               scale=4096 ** -0.5))
    x, w = rand(SLOTS, 1536), 1.0 + rand(1536, scale=0.1)
    table = rand(49155, 1536, scale=0.02, dtype=torch.float32)
    out["6p granite-moe tied table"] = (x, w, table.t())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q8_head_variants: no CUDA card is available", file=sys.stderr)
        return 2
    from repro_torch.benchmarks import tablev
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import _launch, fused
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build(args.only, args.parent, ROOT / "build" / "q8_head_variants")
    fns = {name: bind(lib) for name, lib in libs.items()}
    cases = heads(dev)
    flush = l2_flush_buffer(dev)
    plain = {(row, m): fused.rmsnorm_matmul_q8_plain(
        x, w, *fused.quantize_weight(head), mode=m).float()
        for row, (x, w, head) in cases.items() for m in _launch.MODE_CODES}
    builds = [n for n in ["checkout", *args.only, "parent"] if n in fns]
    order = builds + (["checkout"] if "checkout" in fns else [])
    readings, kernels = {}, {}

    def library(x, w, head):
        wq, ws = fused.quantize_weight(head)
        d = x.shape[-1]
        return F.rms_norm(x, (d,), w, 1e-6) @ fused.dequantize_weight(
            wq, ws, torch.bfloat16)
    try:
        for turn in range(args.turns):
            for name in order:
                _launch._bound.clear()
                _launch._bound.update(fns[name])
                for row, (x, w, head) in cases.items():
                    for mode in _launch.MODE_CODES:
                        def call(x=x, w=w, head=head, mode=mode):
                            return fused.rmsnorm_matmul_q8(x, w, head,
                                                           mode=mode)
                        got = call()
                        route = _launch.LAST_ROUTE[_launch.count_name(
                            "rmsnorm_matmul_q8", mode)]
                        ref = plain[(row, mode)]
                        err = float((got.float() - ref).abs().max()
                                    / ref.abs().max())
                        ms = tablev.time_ms(call, flush=flush)
                        readings.setdefault((name, row, mode), []).append(ms)
                        print(f"turn {turn} {name} {row} [{mode}]: "
                              f"{ms:.4f} ms, route {route}, max err / "
                              f"max|plain| {err:.3g}", flush=True)
                        if turn == 0 and mode == "native" \
                                and (name, row) not in kernels:
                            kernels[(name, row)] = kernel_ms(call)
                            print(f"  kernels: "
                                  f"{json.dumps(kernels[(name, row)])}",
                                  flush=True)
            for row, args_ in cases.items():
                ms = tablev.time_ms(lambda a=args_: library(*a), flush=flush)
                readings.setdefault(("library", row, "native"),
                                    []).append(ms)
                print(f"turn {turn} library {row}: {ms:.4f} ms", flush=True)
    finally:
        _launch._bound.clear()
    print(json.dumps({
        "card": card,
        "ms": {f"{b} {r} [{m}]": statistics.median(v)
               for (b, r, m), v in readings.items()},
        "kernels_native_ms": {f"{b} {r}": k for (b, r), k in kernels.items()},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
