"""Serving: the batched engine over a dense or paged KV cache."""
from repro_torch.serve.engine import (BatchedEngine, PagePool, Request,
                                      ServeConfig)

__all__ = ["BatchedEngine", "PagePool", "Request", "ServeConfig"]
