"""LSTM language model (reference example/rnn/lstm_bucketing.py, the PTB
benchmark configuration) on FusedRNNCell, the fused RNN op — the port's copy
of ``mxnet_tpu/models/lstm_lm.py``: the same graph and node names, built
through ``mxnet_tpu_torch.symbol``."""
from .. import symbol as sym
from ..rnn.rnn_cell import FusedRNNCell


def get_symbol(vocab_size=10000, num_embed=200, num_hidden=200,
               num_layers=2, seq_len=35, dropout=0.0, **kwargs):
    data = sym.Variable('data')
    label = sym.Variable('softmax_label')
    embed = sym.Embedding(data, input_dim=vocab_size,
                          output_dim=num_embed, name='embed')
    cell = FusedRNNCell(num_hidden, num_layers=num_layers, mode='lstm',
                        dropout=dropout, prefix='lstm_')
    # layout NTC: (batch, seq, embed); zero initial states created in-op
    output, _ = cell.unroll(seq_len, inputs=embed, layout='NTC',
                            merge_outputs=True)
    pred = sym.Reshape(output, shape=(-1, num_hidden), name='reshape_out')
    pred = sym.FullyConnected(pred, num_hidden=vocab_size, name='pred')
    label_flat = sym.Reshape(label, shape=(-1,), name='label_flat')
    return sym.SoftmaxOutput(pred, label_flat, name='softmax')


def sym_gen_bucketing(vocab_size=10000, num_embed=200, num_hidden=200,
                      num_layers=2, dropout=0.0):
    """sym_gen for BucketingModule (reference lstm_bucketing.py)."""
    def sym_gen(seq_len):
        s = get_symbol(vocab_size=vocab_size, num_embed=num_embed,
                       num_hidden=num_hidden, num_layers=num_layers,
                       seq_len=seq_len, dropout=dropout)
        return s, ['data'], ['softmax_label']
    return sym_gen
