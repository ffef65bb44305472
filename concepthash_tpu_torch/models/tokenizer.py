"""The CLIP byte-level BPE tokenizer, read from a checkpoint's
``vocab.json`` and ``merges.txt`` (the port's own counterpart of the
``CLIPTokenizerFast`` that the reference's codebook calls,
concepthash_tpu/train/codebook.py).

A prompt is normalised as the fast tokenizer's normaliser does (NFC, every
run of whitespace to one space, lowercase) and split as its pre-tokenizer's
pattern splits it,
``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case
blind), here by a scanner over ``unicodedata`` categories, since ``re`` has
no ``\\p{..}``. Each piece's UTF-8 bytes map to the byte-level alphabet, its
last symbol takes the ``</w>`` word end, and the merges apply lowest rank
first. Ids are framed by ``<|startoftext|>`` (49406 in CLIP's vocabulary)
and ``<|endoftext|>`` (49407), which also pads unless the checkpoint's
``special_tokens_map.json`` or ``tokenizer_config.json`` names another pad
token (some CLIP checkpoints pad with ``!``); an id missing from the
vocabulary becomes ``<|endoftext|>``, the unknown token.
"""

from __future__ import annotations

import json
import os
import unicodedata

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# merges.txt lines read, after its "#version" line (as transformers reads)
_MAX_MERGES = 49152 - 256 - 2


def bytes_to_unicode() -> dict:
    """The byte-level alphabet: each byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def normalize(text: str) -> str:
    """NFC, each run of whitespace to one space, lowercase."""
    return _squeeze(unicodedata.normalize("NFC", text)).lower()


def _squeeze(text: str) -> str:
    out, space = [], False
    for ch in text:
        if ch.isspace():
            if not space:
                out.append(" ")
            space = True
        else:
            out.append(ch)
            space = False
    return "".join(out)


def pre_tokenize(text: str) -> list:
    """The pieces the pattern finds in ``text``, in order."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            low = text[i:i + 3].lower()
            hit = next((c for c in _CONTRACTIONS if low.startswith(c)), None)
            if hit:
                pieces.append(text[i:i + len(hit)])
                i += len(hit)
                continue
        if _letter(ch):
            j = i + 1
            while j < n and _letter(text[j]):
                j += 1
        elif _number(ch):
            j = i + 1
        elif ch.isspace():
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or _letter(text[j])
                                 or _number(text[j])):
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


def _pad_token(path: str) -> str:
    """The pad token a checkpoint directory names (a string, or a dict with
    its ``content``), else ``<|endoftext|>``."""
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        f = os.path.join(path, name)
        if os.path.exists(f):
            with open(f, encoding="utf-8") as fh:
                tok = json.load(fh).get("pad_token")
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok:
                return tok
    return EOS


class CLIPTokenizer:
    """``tokenizer(prompts, padding=True, truncation=True, max_length=77,
    return_tensors='np')`` as a Hugging Face CLIP tokenizer answers it."""

    def __init__(self, vocab: dict, merges: list, pad_token: str = EOS):
        self.encoder = dict(vocab)
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[BOS]
        self.eos_id = self.encoder[EOS]
        self.pad_id = self.encoder[pad_token]
        self._cache: dict = {}

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:_MAX_MERGES + 1]
        return cls(vocab, [tuple(line.split()) for line in lines],
                   pad_token=_pad_token(path))

    def bpe(self, piece: str) -> list:
        if piece in self._cache:
            return self._cache[piece]
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b)), i)
                     for i, (a, b) in enumerate(zip(word, word[1:]))]
            ranked = [r for r, _ in pairs if r is not None]
            if not ranked:
                break
            best = min(ranked)
            first, second = next((word[i], word[i + 1]) for r, i in pairs
                                 if r == best)
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[piece] = word
        return word

    def encode(self, text: str) -> list:
        """The ids of ``text`` without the framing tokens."""
        ids = []
        for piece in pre_tokenize(normalize(text)):
            symbols = "".join(self.byte_encoder[b]
                              for b in piece.encode("utf-8"))
            ids += [self.encoder.get(s, self.eos_id)
                    for s in self.bpe(symbols)]
        return ids

    def __call__(self, texts: list, padding: bool = False,
                 truncation: bool = False, max_length: int = 77,
                 return_tensors: str = "np") -> dict:
        """{'input_ids', 'attention_mask'}, (len(texts), L) int64 arrays:
        each row framed by the start and end tokens, cut to ``max_length``
        with ``truncation``, padded with the end token to the longest row
        with ``padding``."""
        if return_tensors != "np":
            raise ValueError("the port's tokenizer returns numpy arrays "
                             "(return_tensors='np')")
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation:
                ids = ids[:max(max_length - 2, 0)]
            rows.append([self.bos_id, *ids, self.eos_id])
        width = max(len(r) for r in rows)
        if not padding and any(len(r) != width for r in rows):
            raise ValueError("rows of different lengths need padding=True")
        return {"input_ids": np.asarray(
                    [r + [self.pad_id] * (width - len(r)) for r in rows],
                    np.int64),
                "attention_mask": np.asarray(
                    [[1] * len(r) + [0] * (width - len(r)) for r in rows],
                    np.int64)}
