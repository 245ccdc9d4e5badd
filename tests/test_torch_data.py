"""The port's synthetic LM pipeline against the JAX package's, on the CPU:
``batch_at`` bit for bit for the dense, encdec and vlm families, with one
host and with each of two hosts, across ``restore``, and through the
prefetch thread in order; then tests/test_substrate.py's data tests on the
port."""
import dataclasses

import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLMDataset as RefDataset

from repro_torch.data import DataConfig, SyntheticLMDataset

FAMILIES = {
    "dense": dict(),
    "encdec": dict(family="encdec", num_frames=12, d_model=16),
    "vlm": dict(family="vlm", num_patches=5, d_model=16),
}


def _pair(**kw):
    d = dict(global_batch=4, seq_len=16, vocab_size=1000, seed=7)
    d.update(kw)
    return SyntheticLMDataset(DataConfig(**d)), RefDataset(RefDataConfig(**d))


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_config_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(DataConfig)] == \
        [f.name for f in dataclasses.fields(RefDataConfig)]
    assert dataclasses.asdict(DataConfig(1, 2, 3)) == \
        dataclasses.asdict(RefDataConfig(1, 2, 3))


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batch_at_is_bitwise_the_reference(family, hosts):
    ds, ref = _pair(host_count=hosts[0], host_index=hosts[1],
                    **FAMILIES[family])
    for step in (0, 1, 5, 1 << 40):
        _equal(ds.batch_at(step), ref.batch_at(step))


def test_restore_and_prefetch_follow_the_reference():
    ds, ref = _pair(**FAMILIES["vlm"])
    for _ in range(3):
        _equal(next(ds), next(ref))
    assert ds.state() == ref.state() == {"step": 3, "seed": 7}
    ds2, ref2 = _pair(**FAMILIES["vlm"])
    ds2.restore({"step": 9, "seed": 7})
    ref2.restore({"step": 9, "seed": 7})
    ds2.start()
    try:
        for _ in range(4):
            _equal(next(ds2), next(ref2))
        ds2.restore({"step": 2, "seed": 7})     # restarts the producer
        ref2.restore({"step": 2, "seed": 7})
        _equal(next(ds2), next(ref2))
    finally:
        ds2.stop()
    assert ds2._thread is None
    with pytest.raises(AssertionError, match="seed"):
        ds2.restore({"step": 0, "seed": 8})


# --------------------------------------------------------------------------
# tests/test_substrate.py's data tests, on the port
# --------------------------------------------------------------------------


class TestData:
    def _cfg(self, **kw):
        d = dict(global_batch=4, seq_len=16, vocab_size=1000, seed=7)
        d.update(kw)
        return DataConfig(**d)

    def test_deterministic_by_step(self):
        ds1 = SyntheticLMDataset(self._cfg())
        ds2 = SyntheticLMDataset(self._cfg())
        np.testing.assert_array_equal(ds1.batch_at(5)["tokens"],
                                      ds2.batch_at(5)["tokens"])
        assert not np.array_equal(ds1.batch_at(5)["tokens"],
                                  ds1.batch_at(6)["tokens"])

    def test_labels_are_next_tokens(self):
        b = SyntheticLMDataset(self._cfg()).batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (4, 16)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_batch(self):
        full = SyntheticLMDataset(self._cfg(host_count=1)).batch_at(3)
        h0 = SyntheticLMDataset(self._cfg(host_count=2,
                                          host_index=0)).batch_at(3)
        h1 = SyntheticLMDataset(self._cfg(host_count=2,
                                          host_index=1)).batch_at(3)
        np.testing.assert_array_equal(
            np.concatenate([h0["tokens"], h1["tokens"]]), full["tokens"])

    def test_resume_replays_nothing(self):
        ds = SyntheticLMDataset(self._cfg())
        seen = [next(ds)["tokens"] for _ in range(4)]
        ds2 = SyntheticLMDataset(self._cfg())
        ds2.restore(ds.state())
        nxt = next(ds2)["tokens"]
        assert not any(np.array_equal(nxt, s) for s in seen)
        np.testing.assert_array_equal(nxt, ds.batch_at(4)["tokens"])

    def test_prefetch_thread_matches_sync(self):
        ds = SyntheticLMDataset(self._cfg()).start()
        try:
            got = [next(ds)["tokens"] for _ in range(3)]
        finally:
            ds.stop()
        for i, g in enumerate(got):
            np.testing.assert_array_equal(
                g, SyntheticLMDataset(self._cfg()).batch_at(i)["tokens"])

    def test_token_distribution_is_skewed(self):
        toks = SyntheticLMDataset(self._cfg(
            global_batch=64, seq_len=128)).batch_at(0)["tokens"]
        assert (toks < 100).mean() > 2 * (toks >= 900).mean()
