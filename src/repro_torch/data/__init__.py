"""The training data: the byte tokenizer, the synthetic corpus and the
deterministic sharded loader (copies of the reference's ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.data.synthetic import synthetic_corpus
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "synthetic_corpus", "DataConfig", "ShardedLoader"]
