"""Self-contained CLIP BPE tokenizer (a copy of
layoutllm_t2i_tpu/models/clip_tokenizer.py, which the port cannot import
without loading JAX through that package's models/__init__.py).

Reproduces the OpenAI CLIP / HF CLIPTokenizer encoding used by the reference
text encoder. The BPE merge table is data, not code — it is loaded from any
of the standard sources:

  * an explicit ``merges_path`` (``bpe_simple_vocab_16e6.txt[.gz]`` or a HF
    ``merges.txt``);
  * the HF cache (``~/.cache/huggingface``) if openai/clip-vit-large-patch14
    was downloaded there.

Offline test/bench runs that never touch real checkpoints can use
``HashTokenizer``, which maps words to stable pseudo-ids with the correct
special-token framing (not language-meaningful, but shape/flow compatible).
"""
from __future__ import annotations

import functools
import glob
import gzip
import html
import os
import re
from typing import List, Optional

import numpy as np


@functools.lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _find_merges_file() -> Optional[str]:
    env = os.environ.get("CLIP_BPE_PATH")
    if env and os.path.exists(env):
        return env
    for pat in [
        os.path.expanduser("~/.cache/huggingface/**/merges.txt"),
        os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
    ]:
        hits = sorted(glob.glob(pat, recursive=True))
        if hits:
            return hits[0]
    return None


class CLIPTokenizer:
    """BPE tokenizer with CLIP's vocab layout: 256 byte symbols, 256 byte+'</w>'
    symbols, 48894 merges, then <|startoftext|>/<|endoftext|>."""

    def __init__(self, merges_path: Optional[str] = None, max_length: int = 77):
        merges_path = merges_path or _find_merges_file()
        if merges_path is None:
            raise FileNotFoundError(
                "No CLIP BPE merges found. Set CLIP_BPE_PATH to a "
                "bpe_simple_vocab_16e6.txt.gz or HF merges.txt file."
            )
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
        else:
            with open(merges_path, encoding="utf-8") as f:
                merges = [ln for ln in f.read().split("\n") if ln and not ln.startswith("#")]
            merges = merges[: 49152 - 256 - 2]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
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

    def encode_text(self, text: str) -> List[int]:
        ids = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, max_length: Optional[int] = None, pad: bool = True) -> np.ndarray:
        """Returns (B, max_length) int32 ids: SOT + tokens + EOT, padded with EOT
        (HF CLIPTokenizer pads with the eos token)."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out = np.full((len(texts), max_length), self.eot, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_text(t)[: max_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
            if not pad:
                return np.asarray(ids, dtype=np.int32)[None]
        return out


class HashTokenizer:
    """Deterministic stand-in for offline smoke tests: hashes words to ids in
    [1000, 40000); correct SOT/EOT framing and padding."""

    def __init__(self, max_length: int = 77, vocab_size: int = 49408):
        self.max_length = max_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts, max_length: Optional[int] = None, pad: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.max_length
        out = np.full((len(texts), max_length), self.eot, dtype=np.int32)
        for i, t in enumerate(texts):
            words = whitespace_clean(basic_clean(t)).lower().split()
            ids = [1000 + (hash(w) % 39000) for w in words]
            ids = [self.sot] + ids[: max_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def default_tokenizer(max_length: int = 77):
    try:
        return CLIPTokenizer(max_length=max_length)
    except FileNotFoundError:
        return HashTokenizer(max_length=max_length)
