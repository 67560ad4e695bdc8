"""CLIP byte-level BPE tokenizer (a copy of
``hmmc_tpu/tokenization/clip_bpe.py`` that needs only the standard library).

Same vocabulary (49,408 entries from the bundled merges file, with slot
49394 overwritten by ``[MASK]``), same specials and the same text cleaning
(ftfy when installed, else identity; double ``html.unescape``; whitespace
collapse; lowercase).

The JAX package splits words with the ``regex`` module's ``\\p{L}`` and
``\\p{N}`` classes. The standard ``re`` module has no such classes, so
they are built here from :mod:`unicodedata` categories (L* and N*), and
``\\s`` is the Unicode White_Space set that ``regex`` uses (stdlib ``\\s``
also takes U+001C..U+001F). Under ``regex``'s case-insensitive matching
U+0345 (a combining mark that case-folds to a letter) falls in none of the
pattern's classes, so it splits words and is dropped; the "other" class
here leaves it out too, and the pattern is case-sensitive (the text is
lowercased before the split, and stdlib's case-insensitive classes would
let U+0345 join the letters). A test compares the word split with the JAX
package's on every assigned code point.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple

try:  # optional; identity fallback only affects malformed unicode
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)
except ImportError:  # pragma: no cover - environment dependent
    def _fix_text(text: str) -> str:
        return text

_DEFAULT_BPE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "bpe_simple_vocab_16e6.txt.gz",
)

# Unicode White_Space
WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
              "\u202f\u205f\u3000")


def _class(codepoints) -> str:
    """A character-class body of ranges over sorted code points."""
    out, run = [], []
    for cp in list(codepoints) + [None]:
        if run and (cp is None or cp != run[-1] + 1):
            a, b = run[0], run[-1]
            out.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
            run = []
        if cp is not None:
            run.append(cp)
    return "".join(out)


@lru_cache(maxsize=None)
def unicode_classes() -> Tuple[str, str, str]:
    """(letters, numbers, other) character-class bodies matching
    ``regex``'s ``[\\p{L}]``, ``[\\p{N}]`` and ``[^\\s\\p{L}\\p{N}]``."""
    letters, numbers = [], []
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))
        if cat[0] == "L":
            letters.append(cp)
        elif cat[0] == "N":
            numbers.append(cp)
    lc, nc = _class(letters), _class(numbers)
    return lc, nc, f"^{WHITESPACE}{lc}{nc}\u0345"


@lru_cache(maxsize=None)
def word_pattern() -> "re.Pattern":
    letters, numbers, other = unicode_classes()
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        f"[{letters}]+|[{numbers}]|[{other}]+")


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Reversible byte<->printable-unicode table (GPT-2 scheme): printable
    latin bytes map to themselves, the rest are remapped above U+0100."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


_SPACES = re.compile(f"[{WHITESPACE}]+")


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _SPACES.sub(" ", text)
    return text.strip()


class ClipTokenizer:
    """CLIP BPE with the HMMC ``[MASK]`` slot. Host-side only."""

    def __init__(self, bpe_path: str = _DEFAULT_BPE):
        self._b2u = byte_to_unicode()
        self._pat = word_pattern()

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is a version header; CLIP uses exactly 48,894 merges
        # (49152 - 256 - 2 special tokens), matching tokenization_clip.py:69
        merge_lines = lines[1: 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(l.split()) for l in merge_lines]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merges)
        }

        base = list(byte_to_unicode().values())
        vocab = base + [u + "</w>" for u in base]
        vocab.extend("".join(pair) for pair in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        vocab[49394] = "[MASK]"  # HMMC MLM slot (tokenization_clip.py:76)

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.vocab_size = len(vocab)

        self.pad_token_id = self.encoder["<|endoftext|>"]
        self.cls_token_id = self.encoder["<|startoftext|>"]
        self.mask_token_id = self.encoder["[MASK]"]
        self.sep_token_id = self.encoder["<|endoftext|>"]

        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
            "[MASK]": "[MASK]",
        }

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        if not token:
            return token
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        text = _clean(text).lower()
        for piece in self._pat.findall(text):
            piece = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            tokens.extend(self._bpe(piece).split(" "))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder[t] for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))
