"""Symbol table, fairseq-compatible (a copy of
``daspeech_tpu/data/dictionary.py``).

Rebuild of ``fairseq/fairseq/data/dictionary.py``: ``<s> <pad> </s> <unk>``
pinned at indices 0-3, vocab files are "symbol count" lines, ``encode_line``
splits on whitespace (phoneme vocabularies use no BPE — the identity
tokenizer path of the reference).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence

import numpy as np


class Dictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
    ):
        self.symbols: List[str] = []
        self.indices = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = (
            bos, pad, eos, unk)
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        self.nspecial = 4

    def __len__(self):
        return len(self.symbols)

    def __getitem__(self, idx):
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def bos(self):
        return self.bos_index

    def pad(self):
        return self.pad_index

    def eos(self):
        return self.eos_index

    def unk(self):
        return self.unk_index

    def add_symbol(self, word: str) -> int:
        if word in self.indices:
            return self.indices[word]
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        return idx

    def index(self, word: str) -> int:
        return self.indices.get(word, self.unk_index)

    @classmethod
    def load(cls, path) -> "Dictionary":
        """Load a "symbol [count]" file (``Dictionary.add_from_file``)."""
        d = cls()
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            parts = line.rsplit(" ", 1)
            d.add_symbol(parts[0])
        return d

    def save(self, path) -> None:
        with open(path, "w") as f:
            for sym in self.symbols[self.nspecial:]:
                f.write(f"{sym} 1\n")

    def encode_line(
        self,
        line: str,
        append_eos: bool = True,
        prepend_bos: bool = False,
    ) -> np.ndarray:
        ids = [self.index(w) for w in line.strip().split()]
        if prepend_bos:
            ids = [self.bos_index] + ids
        if append_eos:
            ids = ids + [self.eos_index]
        return np.asarray(ids, dtype=np.int32)

    def string(self, ids: Sequence[int], remove_special: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if remove_special and i in (
                    self.bos_index, self.pad_index, self.eos_index):
                continue
            out.append(self[i])
        return " ".join(out)
