"""Paper Table V on the card: GEMM, reduction and histogram in their
abstract, abstract+shuffle and native modes, beside the library call.

    python -m repro_torch.benchmarks.tablev [--seed 0]

The counterpart of the JAX package's ``benchmarks/tablev.py::
wallclock_tables``, at the paper's sizes (its ``*_PAPER`` constants):
GEMM N = 4096 in f32 (its kernels at f32 accuracy on the tensor cores,
3xTF32, bound by their three TF32 products at the TF32 peak), a reduction
of 2^24 f32 values, a histogram of 2^24 int32 values into 256 bins.
Every (kernel, mode) runs through
:mod:`repro_torch.kernels.ops` as a user calls it and is timed on the card
with CUDA events: the median of 20 calls after 3 warm-up calls, the L2
cache flushed before each.  Each mode's time is printed as the paper
reports it, the abstract kernel's performance as a percentage of the
native kernel's (native time / mode time), beside the card's least time
for the work and the library call's time:

- GEMM: ``torch.matmul`` in full f32 (TF32 off; cuBLAS SGEMM);
- reduction: ``torch.sum(x, dtype=torch.float32)``;
- histogram: ``torch.bincount`` of the clipped values.

More cases: the reduction at a tile of 2 elements per thread (one block
tree per 512 elements, the classic kernel the paper's CUDA pair
resembles, where the tree is not amortised); the histogram with every
value in one bin (the most contention); and the native reduction and
every mode's histogram on operands whose base is off 16 bytes, where
native takes the element loads of the abstract kernels (their
percentages are of the aligned native time), which splits the native
gain into its loads and its block stage or privatisation.

Each case's output is checked before it is timed, at the tolerances of
:func:`check_reduction`, :func:`check_histogram` and :func:`check_gemm`.

The JAX module's structural tables (scratch round trips, HBM traffic, MXU
alignment) need ``tuned_plan`` and the structural cost model, which are
not ported yet (ROADMAP, "The UISA core remainder, tuning and auto");
this module prints the measured table only.
A machine without a CUDA card gets an error, not a CPU time.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from repro_torch.benchmarks.common import (fmt_table, l2_flush_buffer,
                                           require_cuda, time_ms)
from repro_torch.kernels import gemm, histogram, ops, reduction

GEMM_N = 4096
RED_N = 1 << 24
HIST_N = 1 << 24
BINS = 256
#: the reduction's small tile: 2 elements per thread of a 256-thread block
SMALL_TILE = reduction.SMALL_TILE

#: H100 SXM data sheet: HBM3 bandwidth; the f32 FMA peak outside the
#: tensor cores (the reduction's and the histogram's operations); the dense
#: TF32 tensor-core peak (the GEMM's three TF32 products a multiply-add)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_TF32 = 495e12
#: TF32 products a multiply-add of the 3xTF32 GEMM: lo.hi, hi.lo, hi.hi
GEMM_TF32_TERMS = 3

#: abstract as a percentage of native, on the paper's T4 and M1 (the JAX
#: kernels' docstrings)
PAPER_PCT = {"gemm": (126.1, 101.2), "reduction": (62.5, 97.8),
             "histogram": (100.4, 102.1)}

#: |kernel - float64 sum| <= REDUCTION_TOL * sum|x|: the f32 summation
#: bound at 2^24 terms with a per-thread sequential fold of 256 terms
#: (256 * 2^-24 = 1.5e-5 in the worst case, far less for random signs)
REDUCTION_TOL = 1e-5
#: GEMM against the float64 product: ||err|| / ||ref|| and, in every row,
#: max|err| / max|row|; K = 4096 sequential f32 FMAs give about
#: sqrt(K) * 2^-24 = 4e-6 relative RMS
GEMM_TOL_RMS = 1e-5
GEMM_TOL_ROW = 1e-4


class TableVMismatch(RuntimeError):
    """A kernel's output is outside its stated tolerance."""


def _fail(cond: bool, msg: str) -> None:
    if not cond:
        raise TableVMismatch(msg)


def check_reduction(got: torch.Tensor, x: torch.Tensor, what: str) -> float:
    """|got - float64 sum| within REDUCTION_TOL * sum|x|; returns the
    absolute error."""
    xd = x.double()
    err = abs(float(got) - float(xd.sum()))
    lim = REDUCTION_TOL * float(xd.abs().sum())
    _fail(err <= lim, f"{what}: |sum - float64 sum| = {err:.4g} > {lim:.4g}")
    return err


def check_histogram(got: torch.Tensor, values: torch.Tensor, bins: int,
                    what: str) -> None:
    """Exactly the clipped counts, summing to n."""
    want = torch.bincount(values.reshape(-1).long().clamp(0, bins - 1),
                          minlength=bins)
    _fail(got.dtype == torch.int32 and got.shape == (bins,),
          f"{what}: {got.dtype} {tuple(got.shape)}, not int32 ({bins},)")
    _fail(torch.equal(got.long(), want), f"{what}: counts differ from the "
          f"clipped bincount")
    _fail(int(got.long().sum()) == values.numel(),
          f"{what}: counts sum to {int(got.long().sum())}, not "
          f"{values.numel()}")


def gemm_rms(got: torch.Tensor, ref64: torch.Tensor) -> float:
    """||got - ref64|| / ||ref64||: a product's relative RMS error against
    the float64 product."""
    return float(torch.linalg.vector_norm(got.double() - ref64)
                 / torch.linalg.vector_norm(ref64).clamp_min(1e-300))


def check_gemm(got: torch.Tensor, ref64: torch.Tensor, what: str) -> float:
    """Relative RMS <= GEMM_TOL_RMS and per-row max|err| <= GEMM_TOL_ROW *
    max|row| against the float64 product; returns the max abs error."""
    _fail(got.shape == ref64.shape, f"{what}: shape {tuple(got.shape)}")
    _fail(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    diff = got.double() - ref64
    rms = gemm_rms(got, ref64)
    row = float((diff.abs().amax(dim=1)
                 / ref64.abs().amax(dim=1).clamp_min(1e-300)).max())
    _fail(rms <= GEMM_TOL_RMS, f"{what}: relative RMS {rms:.4g} > "
          f"{GEMM_TOL_RMS}")
    _fail(row <= GEMM_TOL_ROW, f"{what}: row-relative {row:.4g} > "
          f"{GEMM_TOL_ROW}")
    return float(diff.abs().max())


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FLOPS_F32):
    """The card's least time for the work: the larger of bytes over HBM
    bandwidth and operations over ``peak`` (the f32 FMA peak unless the
    work runs on the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(dev: torch.device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The paper-size operands, made on the card from ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return dict(
        a=torch.randn(GEMM_N, GEMM_N, generator=g, device=dev),
        b=torch.randn(GEMM_N, GEMM_N, generator=g, device=dev),
        x=torch.randn(RED_N, generator=g, device=dev),
        v=torch.randint(0, BINS, (HIST_N,), generator=g, device=dev,
                        dtype=torch.int32),
        hot=torch.full((HIST_N,), BINS // 2, dtype=torch.int32, device=dev),
        # views one element (4 bytes) past a 16-byte boundary
        x_off=torch.randn(RED_N + 1, generator=g, device=dev)[1:],
        v_off=torch.randint(0, BINS, (HIST_N + 1,), generator=g, device=dev,
                            dtype=torch.int32)[1:])


def cases(inp: Dict[str, torch.Tensor]) -> List[dict]:
    """One dict per timed (kernel, mode, case): its entry call, its plain
    version, its input, the library call, its group (the case whose native
    time its percentage is of), bytes, operations (with the peak they run
    at, where it is not the f32 FMA peak), counter and launch."""
    a, b = inp["a"], inp["b"]
    n = GEMM_N
    out = []
    for mode in gemm.MODES:
        out.append(dict(
            kernel="gemm", mode=mode, case=f"{n}^3 f32",
            fn=lambda mode=mode: ops.matmul(a, b, mode=mode),
            plain=lambda mode=mode: gemm.gemm_plain(a, b, mode=mode),
            library=lambda: torch.matmul(a, b),
            bytes=3 * n * n * 4, flops=GEMM_TF32_TERMS * 2 * n ** 3,
            peak=PEAK_FLOPS_TF32,
            launch=gemm.launch_params(mode, n, n, n)))
    red_cases = [("x", reduction.TILE, "2^24 f32", mode)
                 for mode in reduction.MODES]
    red_cases += [("x", SMALL_TILE, "2^24 f32, 2 per thread", mode)
                  for mode in reduction.MODES]
    red_cases += [("x_off", reduction.TILE, "2^24 f32, base off 16 B",
                   "native")]
    for key, tile, label, mode in red_cases:
        x = inp[key]
        fn = (lambda x=x, mode=mode: ops.reduce_sum(x, mode=mode)) \
            if tile == reduction.TILE else \
            (lambda x=x, mode=mode, tile=tile:
             reduction.reduce_sum_kernel(x, mode, tile))
        out.append(dict(
            kernel="reduction", mode=mode, case=label, input=key, fn=fn,
            plain=lambda x=x, mode=mode, tile=tile:
                reduction.reduce_sum_plain(x, mode=mode, tile=tile),
            group="2^24 f32" if key == "x_off" else label,
            library=lambda x=x: torch.sum(x, dtype=torch.float32),
            bytes=RED_N * 4 + 4, flops=RED_N,
            launch=reduction.launch_params(mode, RED_N, tile, x)))
    hist_cases = [(key, label, mode)
                  for key, label in (("v", "2^24 int32, 256 bins"),
                                     ("hot", "2^24 int32, one bin"))
                  for mode in histogram.MODES]
    hist_cases += [("v_off", "2^24 int32, 256 bins, base off 16 B", mode)
                   for mode in histogram.MODES]
    for key, label, mode in hist_cases:
        v = inp[key]
        out.append(dict(
            kernel="histogram", mode=mode, case=label, input=key,
            group="2^24 int32, 256 bins" if key == "v_off" else label,
            fn=lambda v=v, mode=mode: ops.histogram(v, BINS, mode=mode),
            plain=lambda v=v, mode=mode: histogram.histogram_plain(
                v, BINS, mode=mode),
            library=lambda v=v: torch.bincount(
                v.clamp(0, BINS - 1), minlength=BINS),
            # each value read once, each count written once; one clip
            # and one increment per value
            bytes=HIST_N * 4 + BINS * 4, flops=2 * HIST_N,
            launch=histogram.launch_params(mode, HIST_N, BINS, v)))
    for c in out:
        c["counter"] = f"{c['kernel']}_{c['mode']}"
        c.setdefault("group", c["case"])
        if c.get("input", "").endswith("_off"):
            c["launch"]["loads"] = "one element (base off 16 B)"
    return out


def check_output(case: dict, got: torch.Tensor, inp: Dict[str, torch.Tensor],
                 ref64: torch.Tensor, what: str = "") -> float:
    """Hold ``got``, an output of ``case`` (its kernel's or its plain
    version's), to the case's tolerance; returns its max abs error against
    the float64 (or exact) reference.  ``ref64`` is the float64 product of
    the GEMM operands."""
    what = f"{case['kernel']} [{case['mode']}] {case['case']}{what}"
    if case["kernel"] == "gemm":
        return check_gemm(got, ref64, what)
    if case["kernel"] == "reduction":
        return check_reduction(got, inp[case["input"]], what)
    check_histogram(got, inp[case["input"]], BINS, what)
    return 0.0


def run(dev=None, *, seed: int = 0, iters: int = 20, warmup: int = 3,
        log=print) -> List[dict]:
    """Check and time every case; print the table; return one row per
    case (times in ms, bound, library time, percentage of native, launch
    parameters)."""
    dev = dev or require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the library GEMM must run in full f32: "
                           "set torch.set_float32_matmul_precision('highest')")
    inp = make_inputs(dev, seed)
    ref64 = inp["a"].double() @ inp["b"].double()
    flush = l2_flush_buffer(dev)
    all_cases = cases(inp)
    lib_ms = {}
    rows = []
    for case in all_cases:
        err = check_output(case, case["fn"](), inp, ref64)
        group = (case["kernel"], case["case"])
        if group not in lib_ms:
            lib_ms[group] = time_ms(case["library"], iters=iters,
                                    warmup=warmup, flush=flush)
        ms = time_ms(case["fn"], iters=iters, warmup=warmup, flush=flush)
        bms, by = bound_ms(case["bytes"], case["flops"],
                           case.get("peak", PEAK_FLOPS_F32))
        rows.append(dict(kernel=case["kernel"], mode=case["mode"],
                         case=case["case"], group=case["group"],
                         counter=case["counter"], ms=ms,
                         bound_ms=bms, bound_by=by,
                         library_ms=lib_ms[group], max_abs_err=err,
                         launch=case["launch"]))
    del flush, ref64, inp
    torch.cuda.empty_cache()
    native = {(r["kernel"], r["case"]): r["ms"] for r in rows
              if r["mode"] == "native"}
    for r in rows:
        r["pct_of_native"] = 100.0 * native[(r["kernel"], r["group"])] \
            / r["ms"]
    table = []
    for r in rows:
        paper = PAPER_PCT[r["kernel"]] if r["mode"] == "abstract" else None
        table.append([r["kernel"], r["case"], r["mode"], f"{r['ms']:.4f}",
                      f"{r['pct_of_native']:.1f}%",
                      f"{r['bound_ms']:.4f} ({r['bound_by']})",
                      f"{r['library_ms']:.4f}",
                      f"{paper[0]}% / {paper[1]}%" if paper else ""])
    log(f"Table V on {torch.cuda.get_device_name(dev)} (median of {iters} "
        f"after {warmup}, L2 flushed; % = native time / mode time)")
    log(fmt_table(["kernel", "case", "mode", "ms", "% of native",
                   "bound ms", "library ms", "paper T4 / M1 (abstract)"],
                  table))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random operands")
    run(seed=p.parse_args(argv).seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
