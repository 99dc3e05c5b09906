"""The port's data pipeline (its own copy of the JAX package's numpy-only
``data/pipeline.py``): twins of ``test_substrates.py::TestData``, and the
tokens and labels bitwise the reference's for 3 steps at 1, 2 and 4
shards and two corpus seeds."""
import numpy as np
import pytest

from repro.data import make_train_iterator as jax_iterator
from repro_torch.data import SyntheticLM, make_train_iterator


class TestData:
    def test_deterministic(self):
        a = next(make_train_iterator(vocab=100, global_batch=4, seq=16))
        b = next(make_train_iterator(vocab=100, global_batch=4, seq=16))
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_shards_partition_global_batch(self):
        """Global batch must be identical regardless of topology."""
        full = next(make_train_iterator(vocab=100, global_batch=8, seq=16))
        parts = [next(make_train_iterator(vocab=100, global_batch=8, seq=16,
                                          shard_index=i, num_shards=4))
                 for i in range(4)]
        stitched = np.concatenate([p["tokens"] for p in parts], 0)
        np.testing.assert_array_equal(full["tokens"], stitched)

    def test_labels_are_shift(self):
        b = next(make_train_iterator(vocab=50, global_batch=2, seq=8))
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])

    def test_markov_structure_learnable(self):
        """Bigram entropy must be well below unigram (the corpus has signal)."""
        corpus = SyntheticLM(vocab=64, seed=0, branching=4)
        toks = corpus.sample_tokens(20_000, seed=1)
        succ = {}
        for a, b in zip(toks[:-1], toks[1:]):
            succ.setdefault(int(a), set()).add(int(b))
        avg_branch = np.mean([len(s) for s in succ.values()])
        assert avg_branch <= 4.5  # ~branching, << vocab


def test_uneven_shards_are_refused():
    with pytest.raises(ValueError):
        make_train_iterator(vocab=10, global_batch=6, seq=4, num_shards=4)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_tokens_are_bitwise_the_references(shards, seed):
    for i in range(shards):
        kw = dict(vocab=512, global_batch=8, seq=33, shard_index=i,
                  num_shards=shards, seed=seed)
        ours, theirs = make_train_iterator(**kw), jax_iterator(**kw)
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
