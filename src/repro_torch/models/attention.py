"""Decode-time attention and KV-cache writes (plain PyTorch).

Layouts follow the JAX package: dense caches ``[B, Hkv, S, D]``; paged
pools ``[P, Hkv, page_size, D]`` with per-slot block tables ``[B,
max_pages]`` whose unused entries hold the sentinel ``P``.

Unlike the JAX functions, which return new arrays, the cache writes here
update the cache in place and return it: a decode tick then touches only
the written rows.  A write that the JAX version drops (``mode="drop"``, or
a one-hot that matches no column) must still be dropped without a host
sync, so:

- :func:`update_cache` keeps the old row where ``pos`` is outside
  ``[0, S)`` (a masked blend of one row per slot);
- :func:`update_paged_cache` writes into a pool with one extra *trash
  page* at index ``P``: a write whose table entry is the sentinel, or whose
  page index runs past the table's end, lands on the trash page, which no
  reader ever sees (every gather clamps to ``P - 1``).  The pools of
  :meth:`TransformerLM.init_paged_cache` carry that extra page; readers
  take the first ``P`` pages.

The int8 KV cache keeps int8 values with one f32 scale per (token, head)
(:func:`quantize_kv`), in scale tensors of the same geometry with a last
axis of 1: ``[B, Hkv, S, 1]`` dense, ``[P+1, Hkv, page_size, 1]`` paged.
A quantized write goes through the same index (dense) or the same table
entry and trash page (paged) for the values and the scale, so a value row
and its scale never land apart.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import NEG_INF
from repro_torch.kernels.fused import gather_pages as gather_paged_kv


def decode_attention(q, k_cache, v_cache, pos, *,
                     scale: Optional[float] = None):
    """Single-token attention against a cache.

    q: [B,H,1,D]; caches: [B,Hkv,S,D]; pos: [B] - keys at columns
    ``<= pos`` are visible (the new token sits at index pos)."""
    b, h, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    valid = torch.arange(s, device=q.device)[None] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v_cache.float())
    return out.reshape(b, h, 1, d).to(q.dtype)


def update_cache(cache, new, pos):
    """Write new [B,Hkv,1,D] at index ``pos[b]`` of cache [B,Hkv,S,D], in
    place.  A ``pos`` outside ``[0, S)`` writes nothing (the JAX one-hot
    matches no column)."""
    b, _, s, _ = cache.shape
    ok = (pos >= 0) & (pos < s)
    idx = pos.clamp(0, s - 1).long()
    rows = torch.arange(b, device=cache.device)
    old = cache[rows, :, idx]                             # [B,Hkv,D]
    cache[rows, :, idx] = torch.where(ok[:, None, None],
                                      new[:, :, 0].to(cache.dtype), old)
    return cache


def update_paged_cache(pages, new, block_tables, pos):
    """Write new [B,Hkv,1,D] at logical index ``pos[b]``, through the
    table, into ``pages`` [P+1,Hkv,page_size,D] (page ``P`` is the trash
    page), in place.

    The row lands on page ``block_tables[b, pos[b] // page_size]`` at
    ``pos[b] % page_size``.  A sentinel entry (``>= P``) or an index past
    the table's end drops the write, as the JAX version's
    ``mode="drop"`` scatter does: it goes to the trash page."""
    num_pages = pages.shape[0] - 1
    page_size = pages.shape[2]
    maxp = block_tables.shape[1]
    idx = torch.div(pos, page_size, rounding_mode="floor")
    in_table = (pos >= 0) & (idx < maxp)
    page = block_tables.gather(1, idx.clamp(0, maxp - 1).long()[:, None])[:, 0]
    ok = in_table & (page >= 0) & (page < num_pages)
    page = torch.where(ok, page, torch.full_like(page, num_pages)).long()
    offset = torch.remainder(pos, page_size).long()
    pages[page, :, offset] = new[:, :, 0].to(pages.dtype)
    return pages


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           scale: Optional[float] = None):
    """Single-token attention against a paged cache: :func:`decode_attention`
    over the gathered strip."""
    return decode_attention(q, gather_paged_kv(k_pages, block_tables),
                            gather_paged_kv(v_pages, block_tables), pos,
                            scale=scale)


# --------------------------------------------------------------------------
# int8 KV cache
# --------------------------------------------------------------------------


def quantize_kv(x):
    """[..., D] -> (int8 values, f32 scales [..., 1]): symmetric per (token,
    head), ``max|x| / 127`` (at least 1e-8), round half to even.  The
    divisor is a tensor: on the card PyTorch divides by a host scalar as a
    product with its reciprocal, which rounds some quotients the other way
    (``kernels/fused.py::weight_scales``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def update_cache_int8(cache_q, cache_scale, new, pos):
    """Quantize new [B,Hkv,1,D] and write it, with its scale, at ``pos[b]``
    of the int8 cache and its scales, in place (dropped as
    :func:`update_cache` drops)."""
    q_new, s_new = quantize_kv(new)
    update_cache(cache_q, q_new, pos)
    update_cache(cache_scale, s_new, pos)
    return cache_q, cache_scale


def update_paged_cache_int8(pages, scale_pages, new, block_tables, pos):
    """The int8 form of :func:`update_paged_cache`: int8 ``pages``
    [P+1,Hkv,ps,D] and f32 ``scale_pages`` [P+1,Hkv,ps,1], both written
    through the same table entry (a dropped write drops both onto the
    trash page), in place."""
    q_new, s_new = quantize_kv(new)
    update_paged_cache(pages, q_new, block_tables, pos)
    update_paged_cache(scale_pages, s_new, block_tables, pos)
    return pages, scale_pages
