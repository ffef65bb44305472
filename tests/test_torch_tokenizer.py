"""The port's CLIP tokenizer (``models.tokenizer.CLIPTokenizer``) against
transformers' ``CLIPTokenizer`` and ``CLIPTokenizerFast`` built from the same
``vocab.json`` and ``merges.txt``: a byte-level vocabulary (the 256 byte
symbols and their word ends) with merges learned from the prompts, and
``<|startoftext|>`` / ``<|endoftext|>`` at CLIP's ids 49406 / 49407. The
prompts are CUB class-name prompts with underscores, case, digits,
punctuation, contractions, repeated whitespace and non-ASCII letters; ids
and attention masks equal exactly, with ``padding=True`` and truncation at
77."""

import json

import numpy as np
import pytest

from concepthash_tpu_torch.models.tokenizer import (CLIPTokenizer,
                                                    bytes_to_unicode,
                                                    normalize, pre_tokenize)

transformers = pytest.importorskip("transformers")

PROMPTS = [
    "a photo of a Black footed Albatross",
    "a photo of a 001.Black_footed_Albatross",
    "a photo of a Brewer's Blackbird",
    "a photo of a Chuck-will's-widow",
    "a photo of a Crested   Auklet!!",
    "a photo of a Müller's Café bird",
    "a photo of a WHIP-POOR-WILL 2",
    "a photo of a Ānhinga, ñandú (Rhea) ",
    "A PHOTO OF A Le Conte Sparrow 'd 'LL",
    "a photo of a Red_faced_Cormorant 23",
]
LONG = "a photo of a" + " tern" * 90


def _write(path, prompts, n_merges=120):
    bu = bytes_to_unicode()
    base = list(bu.values())
    vocab = {c: i for i, c in enumerate(base + [c + "</w>" for c in base])}
    words = []
    for p in prompts:
        for piece in pre_tokenize(normalize(p)):
            sym = [bu[b] for b in piece.encode("utf-8")]
            words.append(sym[:-1] + [sym[-1] + "</w>"])
    merges = []
    for _ in range(n_merges):
        pairs = {}
        for w in words:
            for pair in zip(w, w[1:]):
                pairs[pair] = pairs.get(pair, 0) + 1
        if not pairs:
            break
        a, b = max(pairs, key=lambda p: (pairs[p], p))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        out = []
        for w in words:
            m, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    m.append(a + b)
                    i += 2
                else:
                    m.append(w[i])
                    i += 1
            out.append(m)
        words = out
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = _write(tmp_path_factory.mktemp("clip_tok"), PROMPTS + [LONG])
    vocab, merges = str(d / "vocab.json"), str(d / "merges.txt")
    return (CLIPTokenizer.from_dir(str(d)),
            transformers.CLIPTokenizer(vocab, merges),
            transformers.CLIPTokenizerFast(vocab, merges))


@pytest.mark.parametrize("which", ["slow", "fast"])
def test_ids_and_mask_equal_transformers(tokenizers, which):
    mine, slow, fast = tokenizers
    ref = slow if which == "slow" else fast
    kw = dict(padding=True, truncation=True, max_length=77,
              return_tensors="np")
    want, got = ref(PROMPTS, **kw), mine(PROMPTS, **kw)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"],
                                  want["attention_mask"])
    assert got["input_ids"].dtype == np.int64
    assert (got["input_ids"][:, 0] == 49406).all()
    # the merges apply: some ids above the 512 byte symbols
    assert (got["input_ids"][got["attention_mask"] == 1] >= 512).any()


@pytest.mark.parametrize("which", ["slow", "fast"])
def test_truncation_and_padding_at_77(tokenizers, which):
    mine, slow, fast = tokenizers
    ref = slow if which == "slow" else fast
    kw = dict(padding=True, truncation=True, max_length=77,
              return_tensors="np")
    batch = [LONG, "a photo of a wren"]
    want, got = ref(batch, **kw), mine(batch, **kw)
    assert got["input_ids"].shape == (2, 77)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"],
                                  want["attention_mask"])
    assert got["input_ids"][0, -1] == 49407          # eos after truncation
    assert (got["input_ids"][1, got["attention_mask"][1] == 0] == 49407).all()


def test_one_prompt_without_padding(tokenizers):
    mine, slow, _ = tokenizers
    np.testing.assert_array_equal(
        mine([PROMPTS[2]])["input_ids"],
        slow([PROMPTS[2]], return_tensors="np")["input_ids"])
    with pytest.raises(ValueError):
        mine(PROMPTS[:2])


def test_pre_tokenize_pattern():
    assert pre_tokenize("brewer's  1234 bird!!-x 'LL") == [
        "brewer", "'s", "1", "2", "3", "4", "bird", "!!-", "x", "'LL"]
    assert normalize("  Café\tAU  ") == " café au "
