"""Native (C++) WordPiece core vs the pure-Python reference implementation:
byte-identical ids on ASCII corpora, graceful fallback otherwise."""

import json
import pathlib

import numpy as np
import pytest

import autognothi.data.loader as dl
from autognothi.data.tokenizer import (
    WordPieceTokenizer,
    build_vocab,
    encode_batch,
)


@pytest.fixture(scope="module")
def tokenizer() -> WordPieceTokenizer:
    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    return WordPieceTokenizer(vocab)


def test_native_builds_and_matches_python(tokenizer):
    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text()
    )
    texts = [s["inputs"] for s in samples] + [
        "unseen words trigger subword splits!",
        "punctuation, splitting; works? (yes) -- $5.99",
        "",
    ]
    native = tokenizer.encode_batch_native(texts, 32)
    assert native is not None, "native tokenizer failed to build"
    python = np.stack([tokenizer.encode(t, 32)[0] for t in texts])
    np.testing.assert_array_equal(native, python)


def test_non_ascii_falls_back(tokenizer):
    assert tokenizer.encode_batch_native(["café au lait"], 16) is None
    # the adapter still produces output through the python path
    out = encode_batch(tokenizer, ["café au lait"], 16)
    assert out.shape == (1, 16)


def test_truncation_matches(tokenizer):
    long = "the service was outstanding " * 20
    native = tokenizer.encode_batch_native([long], 16)
    python = tokenizer.encode(long, 16)[0]
    np.testing.assert_array_equal(native[0], python)
    assert native[0][-1] in (tokenizer.sep_id, tokenizer.pad_id)


def test_nul_byte_falls_back(tokenizer):
    # NUL is the native wire-format record separator; must use python path
    assert tokenizer.encode_batch_native(["evil\x00text"], 16) is None
    out = encode_batch(tokenizer, ["evil\x00text"], 16)
    assert out.shape == (1, 16)
