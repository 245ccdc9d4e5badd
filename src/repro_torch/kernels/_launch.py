"""Binding of the kernel libraries (ctypes, plain C entry points) and the
launch counters every kernel wrapper shares.

Each C entry point returns ``cudaGetLastError()`` after its launches; a
non-zero code raises here.  :data:`LAUNCHES` counts launches per kernel
(and per kernel shape where one kernel serves several), one per call that
reached the card, and :data:`ROUTE_LAUNCHES` the same calls by the route
each took, for the kernels that have several; :func:`reset_launch_counts`
zeroes both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches since the last :func:`reset_launch_counts`, by kernel
#: shape: flash_attention_matmul counts its causal shape and its per-slot
#: ``pos`` shape ("flash_attention_matmul_pos") apart, the int8 twins count
#: apart from their f32 kernels ("<kernel>_q8"; a float weight the int8
#: twin quantizes inside its call counts there too), pass 1 of that
#: quantization called alone counts as "q8_scales", and each Table V kernel
#: and each abstract / abstract+shuffle lowering of a model-path kernel
#: counts each of its modes apart ("<kernel shape>_<mode>"; native keeps the
#: bare name)
LAUNCHES: Dict[str, int] = {"rmsnorm_matmul": 0, "rmsnorm_swiglu": 0,
                            "add_rmsnorm": 0, "rmsnorm": 0,
                            "flash_attention": 0,
                            "flash_attention_matmul": 0,
                            "flash_attention_matmul_pos": 0,
                            "paged_attention_matmul": 0,
                            "rmsnorm_matmul_q8": 0, "rmsnorm_swiglu_q8": 0,
                            "flash_attention_matmul_q8": 0,
                            "flash_attention_matmul_q8_pos": 0,
                            "paged_attention_matmul_q8": 0,
                            "ssd_scan": 0, "ssd_decode": 0,
                            "gemm_abstract": 0, "gemm_native": 0,
                            "reduction_abstract": 0,
                            "reduction_abstract+shuffle": 0,
                            "reduction_native": 0,
                            "histogram_abstract": 0,
                            "histogram_abstract+shuffle": 0,
                            "histogram_native": 0, "q8_scales": 0}
#: the model-path kernel shapes that have abstract and abstract+shuffle
#: lowerings (every one)
MODE_KERNELS = ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                "flash_attention_matmul_pos", "paged_attention_matmul",
                "rmsnorm_matmul_q8", "rmsnorm_swiglu_q8",
                "flash_attention_matmul_q8", "flash_attention_matmul_q8_pos",
                "paged_attention_matmul_q8", "rmsnorm", "add_rmsnorm",
                "flash_attention", "ssd_scan", "ssd_decode")
LAUNCHES.update({f"{k}_{m}": 0 for k in MODE_KERNELS
                 for m in ("abstract", "abstract+shuffle")})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
PI = ctypes.POINTER(ctypes.c_int)
#: entry -> (C symbol, argtypes) of library csrc/<entry>.cu returning a CUDA
#: error code, or (C symbol, argtypes, library, restype); every pointer and
#: the stream are c_void_p, so ctypes never truncates them to 32 bits.  The
#: ``*_workspace`` entries size a kernel's workspace (f32 elements);
#: ``gemm_copy_bytes`` gives the bytes a gemm launch copies at a time,
#: ``ssd_decode_resident`` the decode's blocks an SM,
#: ``paged_attention_decode_resident`` the paged decode route's split
#: kernel's blocks an SM, ``reduction_grid``
#: and ``histogram_grid`` a persistent launch's blocks.  An
#: entry whose last argument is an ``int*`` (:data:`PI`) reports there the
#: route it takes, or, for a ``*_workspace`` entry, the route the launch
#: with those arguments takes (:data:`ROUTES`)
SIGNATURES = {
    "rmsnorm_matmul": ("uisa_rmsnorm_matmul",
                       [I] * 4 + [P] * 7 + [I] * 3 + [F, I, P, PI]),
    "rmsnorm_swiglu": ("uisa_rmsnorm_swiglu",
                       [I] * 4 + [P] * 7 + [I] * 3 + [F, I, P, PI]),
    "add_rmsnorm": ("uisa_add_rmsnorm", [I, I] + [P] * 5 + [I, I, F, P, PI]),
    "rmsnorm": ("uisa_rmsnorm", [I, I] + [P] * 3 + [I, I, F, P, PI]),
    "flash_attention": ("uisa_flash_attention",
                        [I, I] + [P] * 4 + [I] * 8 + [F, P, PI]),
    "flash_attention_matmul": ("uisa_flash_attention_matmul",
                               [I] * 2 + [P] * 8 + [I] * 10 + [F, I, P, PI]),
    "paged_attention_matmul": ("uisa_paged_attention_matmul",
                               [I] * 2 + [P] * 11 + [I] * 11 + [F, I, P, PI]),
    "ssd_scan": ("uisa_ssd_scan", [I, I] + [P] * 8 + [I] * 7 + [LL] * 6
                 + [P, PI]),
    "ssd_decode": ("uisa_ssd_decode", [I, I] + [P] * 8 + [I] * 5 + [LL] * 3
                   + [P]),
    "ssd_decode_resident": ("uisa_ssd_decode_resident", [I] * 4,
                            "ssd_decode", ctypes.c_int),
    "paged_attention_decode_resident": (
        "uisa_paged_attention_decode_resident", [I] * 6,
        "paged_attention_matmul", ctypes.c_int),
    "gemm": ("uisa_gemm", [I, I] + [P] * 3 + [I] * 6 + [P]),
    "gemm_copy_bytes": ("uisa_gemm_copy_bytes", [P, P, I, I], "gemm",
                        ctypes.c_int),
    "reduction": ("uisa_reduce_sum", [I, I, P, LL, LL, P, P, P, PI]),
    "reduction_grid": ("uisa_reduce_sum_grid", [I, I, P, LL, LL, PI],
                       "reduction", LL),
    "histogram": ("uisa_histogram", [I, P, LL, I, P, P]),
    "histogram_grid": ("uisa_histogram_grid", [I, LL, I], "histogram", LL),
    "q8_scales": ("uisa_q8_scales", [I, I, P, I, I, P, P], "rmsnorm_matmul",
                  ctypes.c_int),
    "rmsnorm_matmul_workspace": ("uisa_rmsnorm_matmul_workspace",
                                 [I, I, I, P] + [I] * 4 + [PI],
                                 "rmsnorm_matmul", LL),
    "rmsnorm_swiglu_workspace": ("uisa_rmsnorm_swiglu_workspace",
                                 [I, I, I, P] + [I] * 4 + [PI],
                                 "rmsnorm_swiglu", LL),
    "flash_attention_matmul_workspace": (
        "uisa_flash_attention_matmul_workspace",
        [I] * 3 + [P] * 4 + [I] * 8 + [PI], "flash_attention_matmul", LL),
    "paged_attention_matmul_workspace": (
        "uisa_paged_attention_matmul_workspace",
        [I] * 3 + [P] * 4 + [I] * 9 + [PI], "paged_attention_matmul", LL),
}
#: the routes of the kernels that have several (csrc/tc_gemm.cuh::tc_route,
#: csrc/norm_gemv.cuh::gemv_route, csrc/attention_decode.cuh::decode_route,
#: csrc/reduction.cu::reduce_route, csrc/row_norm.cuh::row_plan,
#: csrc/ssd_scan_tc.cu::scan_tc_route and their callers decide): 1 the
#: tensor cores, 2 the norm-GEMMs' decode GEMV, 3 the attention + wo kernels'
#: decode route (the keys split across blocks, then wo on the decode
#: GEMV), 0 the f32 FMA kernel; the reduction's 4 persistent (resident
#: blocks walk the 512-element tiles) and 5 tile (a block a tile); the row
#: norms' (csrc/row_norm.cuh::row_plan) 6 vector and 7 element (the row
#: held in registers, one memory round trip, by 16-byte or element loads)
#: and 8 loop (one warp a row, two passes)
ROUTES = {1: "tc", 2: "gemv", 3: "decode", 0: "fma", 4: "persistent",
          5: "tile", 6: "vector", 7: "element", 8: "loop"}
#: the route the last launch of each counter took, for the kernels that
#: have several (as their launch entry reports it)
LAST_ROUTE: Dict[str, str] = {}
#: (counter, route) -> launches since the last :func:`reset_launch_counts`,
#: for the kernels that report a route
ROUTE_LAUNCHES: Dict[Tuple[str, str], int] = {}
#: the mode codes of the Table V kernels (csrc/gemm.cu, reduction.cu,
#: histogram.cu) and of the model-path kernels (csrc/common.cuh::IsaMode),
#: whose signatures above take it as their first argument
MODE_CODES = {"abstract": 0, "abstract+shuffle": 1, "native": 2}
_bound: Dict[str, ctypes._CFuncPtr] = {}


def check_mode(mode: str) -> str:
    """``mode`` if it names a kernel lowering (a key of
    :data:`MODE_CODES`), else ValueError."""
    if mode not in MODE_CODES:
        raise ValueError(f"mode must be one of {tuple(MODE_CODES)}, got "
                         f"{mode!r}")
    return mode


def entry(name: str) -> ctypes._CFuncPtr:
    fn = _bound.get(name)
    if fn is None:
        symbol, argtypes, *rest = SIGNATURES[name]
        library, restype = rest or (name, ctypes.c_int)
        fn = getattr(_build.library(library), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _bound[name] = fn
    return fn


def count_name(kernel: str, mode: str) -> str:
    """The counter of one lowering of a model-path kernel shape: the bare
    name for native, ``<kernel>_<mode>`` for the other modes."""
    return kernel if mode == "native" else f"{kernel}_{mode}"


def _routed(name: str) -> bool:
    """Whether entry ``name`` reports a route (its last argument an int*)."""
    return SIGNATURES[name][1][-1] is PI


def launch(name: str, *args, count_as: Optional[str] = None) -> None:
    counter = count_as or name
    route = ctypes.c_int(-1) if _routed(name) else None
    err = entry(name)(*args, *(() if route is None
                               else (ctypes.byref(route),)))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1
    if route is not None:
        taken = LAST_ROUTE[counter] = ROUTES[route.value]
        key = (counter, taken)
        ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1


def workspace(name: str, *args) -> Tuple[int, str]:
    """(f32 elements of kernel ``name``'s workspace, the route its launch
    takes: a value of :data:`ROUTES`) for the launch arguments
    ``args``, as the library's ``<name>_workspace`` entry computes them; a
    kernel whose entry reports no route has the fma route alone."""
    fn = entry(f"{name}_workspace")
    if not _routed(f"{name}_workspace"):
        return int(fn(*args)), "fma"
    route = ctypes.c_int(-1)
    size = fn(*args, ctypes.byref(route))
    return int(size), ROUTES[route.value]


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernels' dtype code (0 f32, 1 bf16); every tensor must share it."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    for t in tensors[1:]:
        if t.dtype != dtype:
            raise TypeError(f"mixed dtypes {dtype} and {t.dtype}")
    return _DTYPE_CODES[dtype]


def check_device(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device of ``kernel``'s operands.  Under grad mode an
    operand that requires grad is refused: the kernels write into fresh
    outputs and have no backward (neither have the JAX package's), so the
    result would carry no ``grad_fn`` and cut every gradient upstream of it
    without a word."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an operand requires grad, and the port's kernels "
            f"have no backward, as the JAX package's kernels have none; "
            f"train under a policy that routes no op into a kernel, or call "
            f"it under torch.no_grad()")
    return dev


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
