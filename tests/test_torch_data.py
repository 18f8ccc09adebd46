"""The port's synthetic corpora equal the reference's for the same
numpy seed."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import synthetic as RS  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402
from repro_torch.data.corpus import pack_documents  # noqa: E402


@pytest.mark.parametrize("name,scale,max_len", [
    ("ap", 0.01, 64), ("cgcbib", 0.005, None), ("neurips", 0.002, 128),
])
def test_paper_corpus_equals_reference(name, scale, max_len):
    a = RS.paper_corpus(name, np.random.default_rng(3), scale=scale,
                        max_len=max_len)
    b = TS.paper_corpus(name, np.random.default_rng(3), scale=scale,
                        max_len=max_len)
    assert a.V == b.V
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert b.num_tokens == a.num_tokens and b.max_len == a.max_len


def test_planted_corpus_equals_reference():
    ca, ta = RS.planted_topics_corpus(np.random.default_rng(7), D=20, V=30,
                                      K_true=4, doc_len=(5, 12))
    cb, tb = TS.planted_topics_corpus(np.random.default_rng(7), D=20, V=30,
                                      K_true=4, doc_len=(5, 12))
    np.testing.assert_array_equal(ca.tokens, cb.tokens)
    np.testing.assert_array_equal(ca.mask, cb.mask)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)
    assert TS.PAPER_CORPORA == RS.PAPER_CORPORA


def test_pack_documents_splits_long_docs_and_pads():
    docs = [np.arange(5), np.arange(2), np.arange(0)]
    c = pack_documents(docs, V=10, max_len=3, pad_docs_to=6)
    assert c.tokens.shape == (6, 3)
    assert c.num_tokens == 7
    np.testing.assert_array_equal(c.mask.sum(1), [3, 2, 2, 0, 0, 0])
