"""Serving: the batched engine over a dense or paged KV cache, and the
router over N such cells."""
from repro_torch.serve.engine import (BatchedEngine, PagePool, Request,
                                      ServeConfig)
from repro_torch.serve.router import CellRouter, make_cells

__all__ = ["BatchedEngine", "CellRouter", "PagePool", "Request",
           "ServeConfig", "make_cells"]
