"""Byte-level tokenizer: vocab = 256 bytes + BOS/EOS/PAD specials (a copy of
the reference's, standard library only)."""

from __future__ import annotations

from typing import Iterable, List


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
