"""Deterministic, resumable, host-sharded synthetic LM data: the JAX
package's ``data/pipeline.py`` in numpy, batch for batch.

- **Deterministic by (seed, step, host)**: any host can regenerate any
  batch from the step index alone, so a restart needs no data state beyond
  the step counter.
- **Host-sharded**: each host makes only its slice of the global batch
  (``host_count`` / ``host_index``).
- **Prefetched**: a background thread keeps ``prefetch`` batches ready.

The token stream is a splitmix64-style counter hash of (seed, step, row,
position) with a Zipf-ish skew; batches carry the modality stubs
(``frames`` / ``patch_embeds``) the encdec and vlm families need.  The
dry run's ``make_batch_specs`` comes with the launch slice.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    host_count: int = 1
    host_index: int = 0
    prefetch: int = 2
    # modality stubs
    family: str = "dense"
    num_frames: int = 0
    num_patches: int = 0
    d_model: int = 0


def _hash_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int, base_row: int) -> np.ndarray:
    """splitmix64-style counter hash -> Zipf-skewed token ids."""
    with np.errstate(over="ignore"):     # uint64 wraparound is the point
        rows = np.arange(batch, dtype=np.uint64)[:, None] + np.uint64(base_row)
        cols = np.arange(seq, dtype=np.uint64)[None, :]
        x = (rows * np.uint64(0x9E3779B97F4A7C15)
             ^ cols * np.uint64(0xBF58476D1CE4E5B9)
             ^ np.uint64(step) * np.uint64(0x94D049BB133111EB)
             ^ np.uint64(seed))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    u = (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # Zipf-ish skew: id = floor(V * u^3) concentrates mass on low ids
    ids = np.minimum((vocab * u ** 3).astype(np.int64), vocab - 1)
    return ids.astype(np.int32)


class SyntheticLMDataset:
    """Iterator of host-local batches with save/restore state."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        self._step = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- deterministic batch synthesis ----

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        base_row = self.cfg.host_index * self.local_batch
        seq = cfg.seq_len + 1
        toks = _hash_tokens(cfg.seed, step, self.local_batch, seq,
                            cfg.vocab_size, base_row)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family in ("encdec", "audio") and cfg.num_frames:
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
            batch["frames"] = rng.standard_normal(
                (self.local_batch, cfg.num_frames, cfg.d_model),
                dtype=np.float32)
        if cfg.family == "vlm" and cfg.num_patches:
            rng = np.random.default_rng(
                (cfg.seed * 2_000_003 + step) & 0x7FFFFFFF)
            batch["patch_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.num_patches, cfg.d_model),
                dtype=np.float32)
        return batch

    # ---- iterator protocol with background prefetch ----

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_at(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def start(self):
        if self._thread is None:
            self._q = queue.Queue(maxsize=self.cfg.prefetch)
            self._stop.clear()
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
            self._q = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is not None:
            batch = self._q.get()
        else:
            batch = self.batch_at(self._step)
        self._step += 1
        return batch

    # ---- resumable state ----

    def state(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: Dict[str, int]):
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        was_running = self._thread is not None
        self.stop()
        self._step = int(state["step"])
        if was_running:
            self.start()
