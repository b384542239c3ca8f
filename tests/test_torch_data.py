"""The port's data pipeline (``repro_torch.data``) against the
reference's (``repro.data``): the data legs of ``tests/test_substrates.py``
on the port (the prefetcher delivers in order, shards partition the
batch, a restart sees the batches it would have seen), and the tokens
equal the reference's bit for bit for every ``(seed, step, shard)``."""

import numpy as np
import pytest

from repro_torch.data import DataConfig, Prefetcher, SyntheticLMData


def test_prefetcher_delivers_in_order():
    data = SyntheticLMData(DataConfig(vocab_size=32, seq_len=4,
                                      global_batch=2))
    pf = Prefetcher(data, start_step=5)
    steps = [pf.next()[0] for _ in range(4)]
    pf.close()
    assert steps == [5, 6, 7, 8]


def test_data_sharding_partitions_batch():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=8,
                     num_shards=2, shard_id=0)
    d0 = SyntheticLMData(cfg)
    d1 = SyntheticLMData(
        DataConfig(vocab_size=64, seq_len=8, global_batch=8,
                   num_shards=2, shard_id=1))
    b0, b1 = d0.batch(0)["tokens"], d1.batch(0)["tokens"]
    assert b0.shape == (4, 8) and b1.shape == (4, 8)
    assert not np.array_equal(b0, b1)  # different shards, different data


def test_checkpoint_restores_mid_stream_data():
    """Restart consumes the same batches it would have seen (determinism)."""
    data = SyntheticLMData(DataConfig(vocab_size=64, seq_len=8,
                                      global_batch=4))
    run1 = [data.batch(s)["tokens"] for s in range(6)]
    run2 = [data.batch(s)["tokens"] for s in range(3, 6)]  # "resumed" at 3
    for a, b in zip(run1[3:], run2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2), (11, 4)])
def test_tokens_equal_the_reference(seed, shards):
    """Every shard's tokens and labels at several steps equal the
    reference pipeline's bit for bit (dtype too)."""
    ref = pytest.importorskip("repro.data")
    for shard in range(shards):
        kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed,
                  num_shards=shards, shard_id=shard)
        port = SyntheticLMData(DataConfig(**kw))
        want = ref.SyntheticLMData(ref.DataConfig(**kw))
        np.testing.assert_array_equal(port._next, want._next)
        for step in (0, 1, 7, 1000):
            got, exp = port.batch(step), want.batch(step)
            assert sorted(got) == sorted(exp) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == exp[k].dtype
                np.testing.assert_array_equal(got[k], exp[k])


def test_prefetcher_equals_the_reference_stream():
    """The prefetcher hands out (step, batch) in order from its start,
    the batches the reference's prefetcher hands out."""
    ref = pytest.importorskip("repro.data")
    kw = dict(vocab_size=50, seq_len=6, global_batch=2, seed=5)
    pf = Prefetcher(SyntheticLMData(DataConfig(**kw)), start_step=3)
    rf = ref.Prefetcher(ref.SyntheticLMData(ref.DataConfig(**kw)),
                        start_step=3)
    try:
        for _ in range(4):
            (s, b), (rs, rb) = pf.next(), rf.next()
            assert s == rs
            np.testing.assert_array_equal(b["tokens"], rb["tokens"])
    finally:
        pf.close()
        rf.close()
