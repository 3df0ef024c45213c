"""RNN cells and IO (reference ``python/mxnet/rnn/``): the port of
``mxnet_tpu/rnn``."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences

__all__ = ['RNNParams', 'BaseRNNCell', 'RNNCell', 'LSTMCell', 'GRUCell',
           'FusedRNNCell', 'SequentialRNNCell', 'BidirectionalCell',
           'DropoutCell', 'ZoneoutCell', 'ResidualCell',
           'BucketSentenceIter', 'encode_sentences']
