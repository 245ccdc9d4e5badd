"""Binding of the kernel libraries (ctypes, plain C entry points) and the
launch counters every kernel wrapper shares.

Each C entry point returns ``cudaGetLastError()`` after its launches; a
non-zero code raises here.  :data:`LAUNCHES` counts launches per kernel
(and per kernel shape where one kernel serves several), one per call that
reached the card; :func:`reset_launch_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

#: kernel launches since the last :func:`reset_launch_counts`, by kernel
#: shape: flash_attention_matmul counts its causal shape and its per-slot
#: ``pos`` shape ("flash_attention_matmul_pos") apart, and each Table V
#: kernel counts each of its modes apart ("<kernel>_<mode>")
LAUNCHES: Dict[str, int] = {"rmsnorm_matmul": 0, "rmsnorm_swiglu": 0,
                            "flash_attention_matmul": 0,
                            "flash_attention_matmul_pos": 0,
                            "paged_attention_matmul": 0,
                            "ssd_scan": 0, "ssd_decode": 0,
                            "gemm_abstract": 0, "gemm_native": 0,
                            "reduction_abstract": 0,
                            "reduction_abstract+shuffle": 0,
                            "reduction_native": 0,
                            "histogram_abstract": 0, "histogram_native": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: library (csrc/<name>.cu) -> (C symbol, argtypes); every pointer and the
#: stream are c_void_p, so ctypes never truncates them to 32 bits
SIGNATURES = {
    "rmsnorm_matmul": ("uisa_rmsnorm_matmul",
                       [I] + [P] * 6 + [I] * 3 + [F, I, P]),
    "rmsnorm_swiglu": ("uisa_rmsnorm_swiglu",
                       [I] + [P] * 6 + [I] * 3 + [F, I, P]),
    "flash_attention_matmul": ("uisa_flash_attention_matmul",
                               [I] + [P] * 7 + [I] * 10 + [F, P]),
    "paged_attention_matmul": ("uisa_paged_attention_matmul",
                               [I] + [P] * 8 + [I] * 11 + [F, P]),
    "ssd_scan": ("uisa_ssd_scan", [I] + [P] * 8 + [I] * 7 + [LL] * 6 + [P]),
    "ssd_decode": ("uisa_ssd_decode", [I] + [P] * 8 + [I] * 5 + [LL] * 3
                   + [P]),
    "gemm": ("uisa_gemm", [I, I] + [P] * 3 + [I] * 6 + [P]),
    "reduction": ("uisa_reduce_sum", [I, I, P, LL, LL, P, P, P]),
    "histogram": ("uisa_histogram", [I, P, LL, LL, I, P, P]),
}
#: the Table V kernels' mode codes (csrc/gemm.cu, reduction.cu, histogram.cu)
MODE_CODES = {"abstract": 0, "abstract+shuffle": 1, "native": 2}
_bound: Dict[str, ctypes._CFuncPtr] = {}


def entry(name: str) -> ctypes._CFuncPtr:
    fn = _bound.get(name)
    if fn is None:
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(_build.library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def launch(name: str, *args, count_as: Optional[str] = None) -> None:
    err = entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[count_as or name] += 1


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


def check_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    return dev


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
