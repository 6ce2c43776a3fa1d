"""Tokenizer loading with an offline byte-level fallback (own copy of the
JAX package's ``utils/tokenizer.py``: ``ByteTokenizer``, ``HFTokenizer``,
``has_tokenizer`` (:56-62), ``load_tokenizer``).

Local HF tokenizer directories load through transformers, offline. When
no tokenizer artifact exists (random-init models, air-gapped nodes) a
deterministic byte-level tokenizer keeps the text -> tokens -> text path
working for any vocab >= 259; at llama-3's 128256 it serves text prompts
with no tokenizer files at all. A directory that holds tokenizer files on
a node without ``transformers`` is an error, never a quiet fall back to
the byte tokenizer, which would serve other text.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

# the files whose presence marks a tokenizer directory, and the files a
# copy of one carries
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                   "spiece.model", "tokenizer.model")
TOKENIZER_COPIED = TOKENIZER_FILES + ("merges.txt", "special_tokens_map.json",
                                      "added_tokens.json")


class ByteTokenizer:
    """UTF-8 bytes + {bos, eos, pad}. Token i in [3, 259) = byte i-3."""

    BOS, EOS, PAD = 0, 1, 2
    OFFSET = 3

    def __init__(self, vocab_size: int = 259):
        assert vocab_size >= 259, "byte tokenizer needs vocab >= 259"
        self.vocab_size = vocab_size
        self.eos_token_id = self.EOS
        self.bos_token_id = self.BOS

    def encode(self, text: str) -> List[int]:
        return [self.BOS] + [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(i - self.OFFSET for i in ids
                     if self.OFFSET <= i < self.OFFSET + 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Thin adapter over a local transformers tokenizer."""

    def __init__(self, path: str):
        try:
            import transformers
        except ImportError:
            raise ValueError(
                f"{path} holds tokenizer files, and transformers, which "
                "reads them, is not installed; pass a tokenizer_path this "
                "node can read or install transformers") from None
        self._tok = transformers.AutoTokenizer.from_pretrained(
            path, local_files_only=True)
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def has_tokenizer(path: Optional[str]) -> bool:
    """True if ``path`` holds HF tokenizer artifacts."""
    return bool(path) and any(os.path.exists(os.path.join(path, f))
                              for f in TOKENIZER_FILES)


def copy_tokenizer(src: str, dst: str) -> List[str]:
    """Copy the tokenizer files of directory ``src`` into ``dst``."""
    copied = []
    for name in TOKENIZER_COPIED:
        if os.path.isfile(os.path.join(src, name)):
            shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
            copied.append(name)
    return copied


def load_tokenizer(path: Optional[str], vocab_size: int):
    """Local HF tokenizer if a path is given, else byte-level fallback.
    Tiny test vocabs (< 259) get a 259-entry byte tokenizer whose ids may
    exceed the model vocab: such callers pass token ids, not text."""
    if path:
        return HFTokenizer(path)
    return ByteTokenizer(max(vocab_size, 259))
