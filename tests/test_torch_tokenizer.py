"""The port's stdlib-``re`` tokenizer against the JAX package's ``regex`` one and
the frozen ``tests/golden/tokenizer.npz`` ids: exact equality."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu.models.clip import tokenizer as jtok
from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames
from anomalyclip_tpu_torch.models.clip import tokenizer as ttok

ROOT = Path(__file__).resolve().parents[1]
LABELS = ROOT / "anomalyclip_tpu" / "labels"


@pytest.fixture(scope="module")
def golden():
    with np.load(ROOT / "tests" / "golden" / "tokenizer.npz") as data:
        return {k: data[k] for k in data.files}


def test_free_text_matches_golden(golden):
    np.testing.assert_array_equal(
        ttok.tokenize([str(t) for t in golden["texts"]]), golden["texts_ids"]
    )


@pytest.mark.parametrize("ds", ["ucf", "sht", "xd", "synthetic"])
def test_label_prompts_match_golden_and_jax(golden, ds):
    classnames = read_classnames(LABELS / f"{ds}_labels.csv")
    assert classnames == [str(c) for c in golden[f"{ds}_classnames"]]
    prompts = [f"{' '.join(['X'] * 8)} {name}." for name in classnames]
    ids = ttok.tokenize(prompts)
    np.testing.assert_array_equal(ids, golden[f"{ds}_prompt_ids"])
    np.testing.assert_array_equal(ids, jtok.tokenize(prompts))
    np.testing.assert_array_equal(ttok.tokenize(classnames), golden[f"{ds}_name_ids"])


def test_unicode_classes_match_regex_tokenizer():
    """Letters and numbers outside ASCII split as \\p{L} / \\p{N} split them."""
    texts = [
        "café naïve Ærøskøbing",
        "x² ³ Ⅻ ٣ 日本語の文 123abc",
        "it's we'll they'd I'M don't",
        "émoji 🙂 and symbols ©®™ — ‘quotes’",
        "ΣΙΣΥΦΟΣ ǅungla ﬁ ﬂ",
    ]
    np.testing.assert_array_equal(ttok.tokenize(texts), jtok.tokenize(texts))
    ours, theirs = ttok.ClipTokenizer(), jtok.ClipTokenizer()
    for text in texts:
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
