"""The port's training data (``repro_torch.data``) against the reference's:
every case of ``tests/test_data.py`` on the port, and the corpus, every
batch and the prefetched stream equal to the reference's byte for byte
(numpy copies: no tolerance)."""

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.data.synthetic import synthetic_corpus as jsynthetic_corpus
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro_torch.data import (ByteTokenizer, DataConfig, ShardedLoader,
                              synthetic_corpus)


class TestTokenizer:
    def test_roundtrip(self):
        tok = ByteTokenizer()
        s = "ternary trit-planes, 1.58 bits!"
        assert tok.decode(tok.encode(s)) == s

    def test_batch_padding_equals_the_reference(self):
        tok = ByteTokenizer()
        b = tok.encode_batch(["ab", "cdef"], seq_len=8)
        assert b.shape == (2, 8)
        assert b[0, -1] == ByteTokenizer.PAD
        np.testing.assert_array_equal(
            b, JByteTokenizer().encode_batch(["ab", "cdef"], seq_len=8))


class TestSynthetic:
    def test_deterministic(self):
        assert synthetic_corpus(4096, seed=1) == synthetic_corpus(4096, seed=1)
        assert synthetic_corpus(4096, seed=1) != synthetic_corpus(4096, seed=2)

    def test_has_structure(self):
        text = synthetic_corpus(1 << 16, seed=0).decode("utf-8")
        assert "equals" in text and "recall slot" in text

    @pytest.mark.parametrize("seed", [0, 3])
    def test_corpus_equals_the_reference(self, seed):
        assert synthetic_corpus(1 << 16, seed=seed) == \
            jsynthetic_corpus(1 << 16, seed=seed)


class TestLoader:
    def test_batch_shapes_and_labels_shift(self):
        cfg = DataConfig(seq_len=32, global_batch=4)
        b = ShardedLoader(cfg).batch_at(0)
        assert b["tokens"].shape == (4, 32)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_deterministic_addressing(self):
        cfg = DataConfig(seq_len=16, global_batch=4, seed=3)
        l1, l2 = ShardedLoader(cfg), ShardedLoader(cfg)
        for step in (0, 1, 17, 12345):
            np.testing.assert_array_equal(l1.batch_at(step)["tokens"],
                                          l2.batch_at(step)["tokens"])

    def test_host_shards_partition_global_batch(self):
        g = DataConfig(seq_len=16, global_batch=8, n_hosts=1)
        full = ShardedLoader(g).batch_at(5)["tokens"]
        parts = [ShardedLoader(DataConfig(seq_len=16, global_batch=8,
                                          n_hosts=4, host_id=h))
                 .batch_at(5)["tokens"] for h in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), full)

    def test_prefetch_stream_matches_addressing(self):
        loader = ShardedLoader(DataConfig(seq_len=16, global_batch=2))
        it = loader.iterate(start_step=7)
        got = [next(it) for _ in range(3)]
        loader.close()
        for i, b in enumerate(got):
            np.testing.assert_array_equal(
                b["tokens"], loader.batch_at(7 + i)["tokens"])

    def test_producer_errors_propagate(self):
        loader = ShardedLoader(DataConfig(seq_len=16, global_batch=2))
        loader._ids = None  # corrupt the corpus → producer throws on slice
        it = loader.iterate(start_step=0)
        with pytest.raises(Exception):
            next(it)

    def test_uneven_host_split_raises(self):
        with pytest.raises(ValueError):
            DataConfig(global_batch=6, n_hosts=4)

    @pytest.mark.parametrize("kw", [
        dict(seq_len=32, global_batch=4),
        dict(seq_len=16, global_batch=8, seed=3, n_hosts=4, host_id=2),
        dict(seq_len=128, global_batch=8, seed=7, corpus_bytes=1 << 16)])
    def test_batches_equal_the_reference(self, kw):
        """Batches at steps far apart, and the prefetched stream from a
        resume step, equal the reference's byte for byte."""
        mine, ref = ShardedLoader(DataConfig(**kw)), \
            JShardedLoader(JDataConfig(**kw))
        for step in (0, 1, 12, 999, 123456):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        ours, theirs = mine.iterate(start_step=5), ref.iterate(start_step=5)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        mine.close()
        ref.close()
