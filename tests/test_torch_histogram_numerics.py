"""The abstract+shuffle histogram's schedule on the CPU: an emulation, in
plain PyTorch, of what ``csrc/histogram.cu::histogram_shuffle_kernel``
does, against the JAX package's ``histogram`` (interpret mode) and the
port's ``histogram_plain`` (the clipped counts) in every mode.

The emulation follows the kernel step by step: the persistent walk (block
``t % grid`` takes tile ``t``, thread ``t`` its values ``u * 256 + t``),
8-bit lane counts packed four bins to a 32-bit word, a flush after every
``FLUSH_TILES`` tiles of a block and after its last, each word's even and
odd bytes sent as two pairs of 16-bit counts through the warp's xor
butterfly (``lane_shuffle_xor`` with masks 16 .. 1), unpacked into 32-bit
per-warp sums, then the warps' sums and the blocks' added.  It asserts the
invariants the kernel's arithmetic rests on: no lane count passes 255
before its flush, and no 16-bit half of a packed word passes 65,535 at
any stage of the tree (no carry into the other half).  Counts are exact
integers, so every comparison is equality.  The module's mirrors of the
kernel's constants (``histogram.THREADS``, ``LOADS``, ``TILE``,
``FLUSH_TILES``) are held to ``csrc/histogram.cu``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops

from repro_torch.core.shuffle import lane_shuffle_xor
from repro_torch.kernels import histogram

MODES = histogram.MODES
MAX_BINS = histogram.max_bins("abstract+shuffle")


def emulate_shuffle(values: np.ndarray, bins: int,
                    grid: int) -> torch.Tensor:
    """The abstract+shuffle kernel's counts of ``values`` into ``bins``
    over ``grid`` blocks, its schedule emulated (see the module note)."""
    v = torch.from_numpy(values.astype(np.int64)).clamp(0, bins - 1)
    n = v.numel()
    tiles = max(1, -(-n // histogram.TILE))
    grid = min(grid, tiles)
    words = -(-bins // 4)
    i = torch.arange(n)
    tile = i // histogram.TILE
    block, step = tile % grid, tile // grid
    window = step // histogram.FLUSH_TILES        # the flush that takes it
    windows = int(window.max()) + 1 if n else 1
    warp, lane = i % histogram.THREADS // 32, i % 32
    shape = (grid, windows, histogram.WARPS, 32, words * 4)
    key = (((block * windows + window) * histogram.WARPS + warp) * 32
           + lane) * words * 4 + v
    counts = torch.bincount(key, minlength=int(np.prod(shape))
                            ).reshape(shape)
    assert int(counts.max()) <= 255, "a lane count passed 8 bits"
    c = counts.reshape(*shape[:-1], words, 4)
    word = c[..., 0] | c[..., 1] << 8 | c[..., 2] << 16 | c[..., 3] << 24
    sums = []
    for part in (word & 0x00FF00FF, (word >> 8) & 0x00FF00FF):
        for mask in (16, 8, 4, 2, 1):             # lanes.cuh's butterfly
            part = part + lane_shuffle_xor(part, mask, axis=3)
            assert int((part & 0xFFFF).max()) < 1 << 16
            assert int((part >> 16).max()) < 1 << 16
        assert torch.equal(part, part[:, :, :, :1].expand_as(part))
        sums.append(part[:, :, :, 0])            # [grid, windows, warps, words]
    ev, od = sums
    per_warp = torch.stack([ev & 0xFFFF, od & 0xFFFF, ev >> 16, od >> 16],
                           dim=-1).reshape(grid, windows, histogram.WARPS,
                                           words * 4)
    out = per_warp.sum(dim=1)          # the flushes into the 32-bit sums
    out = out.sum(dim=1)               # the warps, in order
    return out.sum(dim=0)[:bins].to(torch.int32)   # the blocks' atomics


def _values(case: str, bins: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "one_bin":
        return np.full(n, bins // 2, np.int32)
    if case == "off_the_ends":
        return rng.integers(-50, bins + 50, n).astype(np.int32)
    return rng.integers(0, bins, n).astype(np.int32)


def _jax(values: np.ndarray, bins: int, mode: str) -> np.ndarray:
    return np.asarray(ref_ops.histogram(jnp.asarray(values), bins,
                                        mode=mode))


# one block walks 20 tiles: every lane counts 320 values, past 255, so the
# flush after 15 tiles is what keeps the 8-bit counts exact; a ragged last
# tile (n not a multiple of 4,096); 1, 100, 256 bins, values off both ends
@pytest.mark.parametrize("case,bins,n,grid", [
    ("one_bin", 256, 20 * histogram.TILE, 1),
    ("one_bin", 1, 20 * histogram.TILE - 7, 1),
    ("off_the_ends", 256, 3 * histogram.TILE + 1461, 2),
    ("off_the_ends", 100, 17 * histogram.TILE + 3, 1),
    ("in_range", 256, 40 * histogram.TILE + 999, 3),
])
def test_emulated_shuffle_schedule_matches_jax_and_plain(case, bins, n, grid):
    values = _values(case, bins, n, seed=bins + n)
    got = emulate_shuffle(values, bins, grid)
    np.testing.assert_array_equal(got.numpy(), np.bincount(
        np.clip(values, 0, bins - 1), minlength=bins))
    for mode in MODES:
        np.testing.assert_array_equal(got.numpy(), _jax(values, bins, mode))
        plain = histogram.histogram_plain(torch.from_numpy(values), bins,
                                          mode=mode)
        assert torch.equal(got, plain)


@pytest.mark.parametrize("bins", [MAX_BINS, 768])
def test_emulated_shuffle_at_the_most_bins(bins):
    """At max_bins (804: 201 words a lane; the JAX kernels take a bin count
    that is a multiple of 128 or at most 128, so they are held at 768, the
    library row at 804) and with a ragged last tile."""
    values = _values("off_the_ends", bins, 5 * histogram.TILE + 77, seed=9)
    got = emulate_shuffle(values, bins, grid=2)
    jax_modes = MODES + ("library",) if bins % 128 == 0 else ("library",)
    for mode in jax_modes:
        np.testing.assert_array_equal(got.numpy(), _jax(values, bins, mode))
    for mode in MODES:
        assert torch.equal(got, histogram.histogram_plain(
            torch.from_numpy(values), bins, mode=mode))


def test_max_bins_rose_and_fits_the_shared_memory():
    """abstract+shuffle's 8-bit columns take 1,152 bytes a 4-bin word (its
    table, 8 warps x 32 lanes, and the warps' int32 sums), so it takes 804
    bins where its 16-bit columns took 427; every mode's largest bin count
    fits the 232,448 bytes a block may have, one more word does not."""
    assert MAX_BINS == 804 > 427
    for mode in MODES:
        most = histogram.max_bins(mode)
        assert histogram.smem_bytes(mode, most) <= 232448
        step = 4 if mode == "abstract+shuffle" else 1
        assert histogram.smem_bytes(mode, most + step) > 232448


@pytest.mark.parametrize("grid", [1, 3, 7])
def test_emulated_walk_does_not_depend_on_the_grid(grid):
    """However many blocks walk the tiles (1: one block flushes after every
    15 of its 41 tiles; 7: after its last 6 or 5), the counts are the
    clipped counts that the plain version gives in every mode."""
    values = _values("one_bin", 256, 40 * histogram.TILE + 999, seed=4)
    values[::3] = _values("off_the_ends", 256, values[::3].size, seed=5)
    got = emulate_shuffle(values, 256, grid)
    for mode in MODES:
        assert torch.equal(got, histogram.histogram_plain(
            torch.from_numpy(values), 256, mode=mode))


def test_the_mirrors_match_the_kernel_source():
    """THREADS, LOADS, TILE and FLUSH_TILES, which the emulation and
    ``launch_params`` use, are the constants csrc/histogram.cu builds."""
    src = (Path(histogram.__file__).resolve().parents[1] / "csrc"
           / "histogram.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, f"{name} not found in histogram.cu"
        return m.group(1).strip()

    assert int(const("kHistThreads")) == histogram.THREADS
    assert int(const("kHistLoads")) == histogram.LOADS
    assert const("kHistTile") == "kHistThreads * kHistLoads"
    assert const("kFlushTiles") == "255 / kHistLoads"
    assert histogram.TILE == histogram.THREADS * histogram.LOADS
    assert histogram.FLUSH_TILES == 255 // histogram.LOADS


def test_the_emulation_sees_an_overflow():
    """Without the flush (every tile of a block in one window) a lane of
    the one-bin case counts 320 values: the emulation's 8-bit check fires,
    so the flush is what the exact counts above rest on."""
    values = _values("one_bin", 256, 20 * histogram.TILE, seed=0)
    flush = histogram.FLUSH_TILES
    try:
        histogram.FLUSH_TILES = 1 << 20
        with pytest.raises(AssertionError, match="8 bits"):
            emulate_shuffle(values, 256, grid=1)
    finally:
        histogram.FLUSH_TILES = flush
