"""RNN IO (reference ``python/mxnet/rnn/``): the bucketed sentence
iterator.  The RNN cells are not ported."""
from .io import BucketSentenceIter, encode_sentences

__all__ = ['BucketSentenceIter', 'encode_sentences']
