"""Byte-level tokenizer: vocab = 256 bytes + BOS/EOS/PAD specials (a copy of
the reference's)."""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 259

    def encode(self, text: str, *, bos: bool = True, eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Iterable[str], seq_len: int) -> np.ndarray:
        """Fixed-length right-padded batch (B, seq_len) int32."""
        rows = []
        for t in texts:
            ids = self.encode(t)[:seq_len]
            ids = ids + [self.PAD] * (seq_len - len(ids))
            rows.append(ids)
        return np.asarray(rows, np.int32)
