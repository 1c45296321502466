"""CLIP-compatible byte-pair-encoding tokenizer.

Counterpart of ``lidar_layout_tpu/encoders/bpe.py`` (OpenAI CLIP's
SimpleTokenizer semantics). The merge table loads from a gzip file such as
``bpe_simple_vocab_16e6.txt.gz`` (pass its path or set LIDM_BPE_VOCAB), and
that branch needs the ``regex`` package, imported only there. Without the
file, tokenization falls back to ``encoders/modules.simple_tokenize`` and
says so, which keeps the shapes and special tokens but not CLIP's tokens.
The repository holds no vocabulary file (ROADMAP queue 1, "Conditioning").
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOT, EOT = 49406, 49407
CONTEXT = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP scheme: keep
    printable ranges, remap the rest above 255)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPETokenizer:
    def __init__(self, vocab_path: Optional[str] = None):
        vocab_path = vocab_path or os.environ.get("LIDM_BPE_VOCAB")
        self.ok = bool(vocab_path) and os.path.isfile(str(vocab_path))
        if not self.ok:
            print("[clip] no BPE vocab file — byte-level fallback tokenizer "
                  "(set LIDM_BPE_VOCAB for CLIP-token parity)")
            return
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {}
        import regex   # the vocabulary branch only

        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        ids: List[int] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str],
                 context_length: int = CONTEXT) -> np.ndarray:
        if not self.ok:
            from .modules import simple_tokenize
            return simple_tokenize(texts, context_length)
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [SOT] + self.encode(t)[: context_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out
