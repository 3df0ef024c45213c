"""Decoder-only transformer language model — the port's copy of
``mxnet_tpu/models/transformer_lm.py``, node for node, so both packages
build the same graph (the same node names, ops and attributes).

Pre-norm blocks: x + Attn(LN(x)), x + FFN(LN(x)); learned positional
embedding; every attention block runs the ``FlashAttention`` op
(ops/nn.py -> ops/attention.py), and under ``MXTPU_FUSE=aggressive``
each FFN's ``FullyConnected -> relu`` runs as ``fused_dot_epilogue``.
"""
import math

from .. import symbol as sym


def get_symbol(vocab_size=10000, num_embed=256, num_heads=4,
               num_layers=2, ffn_mult=4, seq_len=64,
               max_seq_len=None, **kwargs):
    """``max_seq_len``: size of the positional table (defaults to
    ``seq_len``).  Bucketing shares ONE table across bucket graphs by
    declaring it at the largest bucket's length and slicing the prefix
    per bucket (the lstm_bucketing shared-parameter convention)."""
    if num_embed % num_heads:
        raise ValueError('num_embed (%d) must be a multiple of num_heads '
                         '(%d)' % (num_embed, num_heads))
    head_dim = num_embed // num_heads
    if max_seq_len is None:
        max_seq_len = seq_len
    if max_seq_len < seq_len:
        raise ValueError('max_seq_len (%d) is below seq_len (%d)'
                         % (max_seq_len, seq_len))
    data = sym.Variable('data')                 # (N, T) token ids
    label = sym.Variable('softmax_label')       # (N, T)

    tok = sym.Embedding(data, input_dim=vocab_size,
                        output_dim=num_embed, name='tok_embed')
    # learned positions: one (max_seq_len, E) table, prefix-sliced
    pos_w = sym.Variable('pos_embed_weight',
                         shape=(max_seq_len, num_embed))
    pos = pos_w if max_seq_len == seq_len else sym.slice_axis(
        pos_w, axis=0, begin=0, end=seq_len, name='pos_slice')
    x = sym.broadcast_plus(tok, sym.Reshape(
        pos, shape=(1, seq_len, num_embed), name='pos_r'),
        name='embed_sum')

    for i in range(num_layers):
        p = 'blk%d' % i
        # ---- attention sublayer (pre-norm) ----
        h = sym.Reshape(x, shape=(-1, num_embed), name='%s_flat' % p)
        hn = sym.InstanceNorm(
            sym.Reshape(h, shape=(0, 1, -1), name='%s_nin' % p),
            name='%s_ln1' % p)
        hn = sym.Reshape(hn, shape=(-1, num_embed), name='%s_nflat' % p)
        qkv = sym.FullyConnected(hn, num_hidden=3 * num_embed,
                                 no_bias=True, name='%s_qkv' % p)
        qkv = sym.Reshape(qkv, shape=(-1, seq_len, 3, num_heads,
                                      head_dim), name='%s_qkv_r' % p)
        parts = sym.SliceChannel(qkv, num_outputs=3, axis=2,
                                 squeeze_axis=True, name='%s_split' % p)
        # (N, T, H, D) -> (N, H, T, D)
        q = sym.SwapAxis(parts[0], dim1=1, dim2=2, name='%s_q' % p)
        k = sym.SwapAxis(parts[1], dim1=1, dim2=2, name='%s_k' % p)
        v = sym.SwapAxis(parts[2], dim1=1, dim2=2, name='%s_v' % p)
        att = sym.FlashAttention(q, k, v, causal=True,
                                 scale=1.0 / math.sqrt(head_dim),
                                 name='%s_att' % p)
        att = sym.SwapAxis(att, dim1=1, dim2=2, name='%s_att_t' % p)
        att = sym.Reshape(att, shape=(-1, num_embed),
                          name='%s_att_flat' % p)
        proj = sym.FullyConnected(att, num_hidden=num_embed,
                                  no_bias=True, name='%s_proj' % p)
        x = sym.broadcast_plus(
            x, sym.Reshape(proj, shape=(-1, seq_len, num_embed),
                           name='%s_proj_r' % p),
            name='%s_res1' % p)

        # ---- FFN sublayer (pre-norm) ----
        f = sym.Reshape(x, shape=(-1, num_embed), name='%s_f' % p)
        fn = sym.InstanceNorm(
            sym.Reshape(f, shape=(0, 1, -1), name='%s_fnin' % p),
            name='%s_ln2' % p)
        fn = sym.Reshape(fn, shape=(-1, num_embed),
                         name='%s_fnflat' % p)
        up = sym.FullyConnected(fn, num_hidden=ffn_mult * num_embed,
                                name='%s_up' % p)
        up = sym.Activation(up, act_type='relu', name='%s_gelu' % p)
        down = sym.FullyConnected(up, num_hidden=num_embed,
                                  name='%s_down' % p)
        x = sym.broadcast_plus(
            x, sym.Reshape(down, shape=(-1, seq_len, num_embed),
                           name='%s_down_r' % p),
            name='%s_res2' % p)

    out = sym.Reshape(x, shape=(-1, num_embed), name='head_flat')
    logits = sym.FullyConnected(out, num_hidden=vocab_size,
                                name='lm_head')
    label_flat = sym.Reshape(label, shape=(-1,), name='label_flat')
    return sym.SoftmaxOutput(logits, label_flat, name='softmax')


def sym_gen_bucketing(vocab_size=10000, num_embed=256, num_heads=4,
                      num_layers=2, ffn_mult=4, max_seq_len=64):
    """sym_gen for BucketingModule (reference lstm_bucketing.py role):
    every bucket graph shares ALL parameters — the positional table is
    declared at ``max_seq_len`` and prefix-sliced per bucket."""
    def sym_gen(seq_len):
        s = get_symbol(vocab_size=vocab_size, num_embed=num_embed,
                       num_heads=num_heads, num_layers=num_layers,
                       ffn_mult=ffn_mult, seq_len=seq_len,
                       max_seq_len=max_seq_len)
        return s, ['data'], ['softmax_label']
    return sym_gen
