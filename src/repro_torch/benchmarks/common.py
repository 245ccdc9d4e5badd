"""Timing and table helpers of the port's benchmarks (paper §VII.A: the
median of N calls after a warm-up), on the card only."""
from __future__ import annotations

import statistics
from typing import Callable, Optional

import torch

#: read between timed calls so each finds the 50 MB L2 cold
L2_FLUSH_BYTES = 128 << 20


def require_cuda() -> torch.device:
    """The first CUDA card; raises without one (no CPU fallback: a CPU
    time is not a device time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark times the CUDA card and there is "
                           "none")
    return torch.device("cuda", 0)


def l2_flush_buffer(dev: torch.device) -> torch.Tensor:
    return torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)


def time_ms(fn: Callable, *, iters: int = 20, warmup: int = 3,
            flush: Optional[torch.Tensor] = None) -> float:
    """Median device time of ``fn`` in ms over ``iters`` calls, after
    ``warmup`` calls.  CUDA events around each call; before each, the L2
    cache is flushed by reading ``flush`` (a read leaves no dirty lines
    for the timed call to write back), and a short device sleep lets the
    host enqueue the call before the device reaches it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.amax()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fmt_table(headers, rows) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    fmt = lambda row: " | ".join(str(c).ljust(w)
                                 for c, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])
