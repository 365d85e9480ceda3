"""The port's batch pipelines (``repro_torch.data.pipeline``) against
``repro.data.pipeline``: the same seed gives byte-identical batches
(every key, dtype and shape), over several batches of an iterator."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro_torch import data
from repro_torch.data import pipeline


@pytest.mark.parametrize("n,bs,kw", [
    (10, 3, {}), (10, 3, dict(drop_last=True)), (7, 7, dict(shuffle=False)),
    (1000, 64, dict(seed=5))])
def test_batch_iterator_is_the_reference(n, bs, kw):
    got = list(pipeline.batch_iterator(n, bs, **kw))
    want = list(ref_pipeline.batch_iterator(n, bs, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("batch,seq,vocab,seed", [
    (2, 16, 512, 0), (3, 33, 32001, 4), (1, 1, 7, 1)])
def test_synthesize_tokens_is_the_reference(batch, seq, vocab, seed):
    got = pipeline.synthesize_tokens(np.random.default_rng(seed), batch,
                                     seq, vocab)
    want = ref_pipeline.synthesize_tokens(np.random.default_rng(seed),
                                          batch, seq, vocab)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kw", [
    dict(), dict(weights=True), dict(frames=6, d_model=8),
    dict(patches=4, d_model=8, weights=True, seed=3)],
    ids=["tokens", "weights", "frames", "patches"])
def test_token_batch_iterator_is_the_reference(kw):
    got = list(itertools.islice(
        pipeline.token_batch_iterator(2, 12, 300, **kw), 3))
    want = list(itertools.islice(
        ref_pipeline.token_batch_iterator(2, 12, 300, **kw), 3))
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()


def test_exported_from_data():
    assert data.token_batch_iterator is pipeline.token_batch_iterator
    assert data.batch_iterator is pipeline.batch_iterator
    assert data.synthesize_tokens is pipeline.synthesize_tokens
