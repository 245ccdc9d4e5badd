"""Plain PyTorch attention (the chunked online-softmax prefill, decode
against a cache) and the KV-cache writes.

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
from repro_torch.parallel.sharding import unflatten


def _pad_axis(x, axis: int, multiple: int):
    """``x`` zero-padded at the end of ``axis`` to a multiple of
    ``multiple``, and the count of chunks."""
    pad = (-x.shape[axis]) % multiple
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x, x.shape[axis] // multiple


def _chunk_step(qc, kc, vc, carry, row_ids, col_ids):
    """One online-softmax update: qc [B,Hkv,G,cq,D], kc/vc [B,Hkv,ck,D];
    key ``c`` visible to query ``r`` when ``col_ids[c] <= row_ids[r]``."""
    m_prev, l_prev, acc = carry
    s = torch.einsum("bkgqd,bkcd->bkgqc", qc.float(), kc.float())
    mask = col_ids[None, :] <= row_ids[:, None]            # (cq, ck)
    s = torch.where(mask, s, s.new_full((), NEG_INF))
    m_cur = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m_prev - m_cur)
    p = torch.exp(s - m_cur)
    l_cur = l_prev * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum("bkgqc,bkcd->bkgqd", p, vc.float())
    return m_cur, l_cur, acc


def chunked_attention(q, k, v, *, causal: bool = True, kv_offset: int = 0,
                      chunk_q: int = 512, chunk_kv: int = 1024,
                      exact_causal: bool = False,
                      scale: Optional[float] = None):
    """Online-softmax attention over (query chunk, key chunk) pairs: the
    JAX package's plain prefill attention, step for step.

    q: [B,H,Sq,D]; k/v: [B,Hkv,Skv,D] -> [B,H,Sq,D] in q's dtype.  q is
    scaled in its dtype first; scores and sums run in f32.  Causal: key
    ``c`` is visible to query ``i`` when ``c <= i + kv_offset``; either way
    the zero padding of a chunk that does not divide the sequence is
    masked.  Masked scores are -1e30, a row with no visible key is divided
    by 1.  ``exact_causal`` (with ``kv_offset == Skv - Sq``) visits each
    query chunk's key chunks only up to its diagonal."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    # the scale rounded to q's dtype on the host: a device tensor made from
    # a host scalar would synchronize
    q = q * float(torch.tensor(scale, dtype=q.dtype))
    chunk_q = min(chunk_q, sq)
    chunk_kv = min(chunk_kv, skv)
    qg, nq = _pad_axis(unflatten(q, 1, (hkv, g)), 3, chunk_q)
    kp, nk = _pad_axis(k, 2, chunk_kv)
    vp, _ = _pad_axis(v, 2, chunk_kv)
    sqp, skvp = qg.shape[3], kp.shape[2]
    dev = q.device
    col_base = torch.arange(chunk_kv, device=dev)
    row_base = torch.arange(chunk_q, device=dev)

    def kv_scan(qc, qi: int, n_kv: int, rows):
        carry = (qc.new_full((b, hkv, g, chunk_q, 1), NEG_INF,
                             dtype=torch.float32),
                 qc.new_zeros((b, hkv, g, chunk_q, 1), dtype=torch.float32),
                 qc.new_zeros((b, hkv, g, chunk_q, d), dtype=torch.float32))
        for ki in range(n_kv):
            kc = kp[:, :, ki * chunk_kv:(ki + 1) * chunk_kv]
            vc = vp[:, :, ki * chunk_kv:(ki + 1) * chunk_kv]
            cols = ki * chunk_kv + col_base
            cols_ok = cols < skv
            if causal:
                kc = torch.where(cols_ok[:, None], kc, kc.new_zeros(()))
                cols = torch.where(cols_ok, cols, skv + sqp + kv_offset)
            else:
                cols = torch.where(cols_ok, cols, skvp + sqp + 1)
            carry = _chunk_step(qc, kc, vc, carry, rows, cols)
        _, l, acc = carry
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        return (acc / l).to(q.dtype)

    fold = exact_causal and causal and kv_offset == skv - sq
    outs = []
    for qi in range(nq):
        qc = qg[:, :, :, qi * chunk_q:(qi + 1) * chunk_q]
        if causal:
            rows = qi * chunk_q + row_base + kv_offset
        else:
            rows = torch.full((chunk_q,), skvp + sqp, device=dev)
        n_kv = nk
        if fold:
            last_col = qi * chunk_q + chunk_q - 1 + kv_offset
            n_kv = max(min(nk, last_col // chunk_kv + 1), 1)
        outs.append(kv_scan(qc, qi, n_kv, rows))
    out = torch.cat(outs, dim=3)[:, :, :, :sq]
    return out.reshape(b, h, sq, d)


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
