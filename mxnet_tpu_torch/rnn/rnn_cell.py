"""RNN cell API — the port of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
``python/mxnet/rnn/rnn_cell.py:42-930``).

The cells build symbols, so the symbol JSON they unroll into is the JAX
package's.  ``FusedRNNCell`` targets the fused RNN op (``ops/rnn_op.py``:
torch's fused RNN, cuDNN on the card) over the packed parameter blob,
which has the same layout in both packages, and can ``unfuse()`` into
explicit per-step cells.
"""
from __future__ import annotations

import numpy as np

from .. import symbol
from .. import ndarray as nd
from ..ops.rnn_op import rnn_param_layout, rnn_param_size

__all__ = ['RNNParams', 'BaseRNNCell', 'RNNCell', 'LSTMCell', 'GRUCell',
           'FusedRNNCell', 'SequentialRNNCell', 'BidirectionalCell',
           'DropoutCell', 'ZoneoutCell', 'ResidualCell']


class RNNParams(object):
    """Container for shared cell parameters (reference rnn_cell.py:42)."""

    def __init__(self, prefix=''):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract RNN cell (reference rnn_cell.py:73)."""

    def __init__(self, prefix='', params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele['shape'] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states (reference rnn_cell.py:140).

        Default creates free Variables named ``<prefix>begin_state_<i>``
        whose shapes are inferred/bound at bind time (the reference's
        ``sym.zeros`` default relied on nnvm backward shape inference;
        variables are this stack's equivalent, and ``simple_bind``
        allocates them zero-filled).
        """
        assert not self._modified, \
            'After applying modifier cells the base cell cannot be called ' \
            'directly. Call the modifier cell instead.'
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = '%sbegin_state_%d' % (self._prefix, self._init_counter)
            if func is None:
                state = symbol.Variable(name)
            else:
                fkwargs = {k: v for k, v in {**(info or {}),
                                             **kwargs}.items()
                           if k in ('shape', 'dtype', 'ctx')}
                state = func(name=name, **fkwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split packed blobs into per-gate weights (rnn_cell.py:170)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ['i2h', 'h2h']:
            weight = args.pop('%s%s_weight' % (self._prefix, group_name))
            bias = args.pop('%s%s_bias' % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = '%s%s%s_weight' % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = '%s%s%s_bias' % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """(reference rnn_cell.py:193)"""
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ['i2h', 'h2h']:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = '%s%s%s_weight' % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = '%s%s%s_bias' % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args['%s%s_weight' % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args['%s%s_bias' % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix='', layout='NTC', merge_outputs=None):
        """Unroll the cell over time (reference rnn_cell.py:216)."""
        self.reset()
        axis = layout.find('T')
        if inputs is None:
            inputs = [symbol.Variable('%st%d_data' % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                'unroll doesn\'t allow grouped symbol as input. Please ' \
                'convert to list first or let unroll handle splitting'
            inputs = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference rnn_cell.py:285)."""

    def __init__(self, num_hidden, activation='tanh', prefix='rnn_',
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name='%sh2h' % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name='%sout' % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py:333)."""

    def __init__(self, num_hidden, prefix='lstm_', params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._hW = self.params.get('h2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hB = self.params.get('h2h_bias')
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'},
                {'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_i', '_f', '_c', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = '%st%d_' % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name='%sh2h' % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name='%sslice' % name)
        in_gate = symbol.Activation(slice_gates[0], act_type='sigmoid',
                                    name='%si' % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type='sigmoid',
                                        name='%sf' % name)
        in_transform = symbol.Activation(slice_gates[2], act_type='tanh',
                                         name='%sc' % name)
        out_gate = symbol.Activation(slice_gates[3], act_type='sigmoid',
                                     name='%so' % name)
        next_c = symbol._plus(forget_gate * states[1],
                              in_gate * in_transform,
                              name='%sstate' % name)
        next_h = symbol._mul(out_gate, symbol.Activation(
            next_c, act_type='tanh'), name='%sout' % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference rnn_cell.py:401)."""

    def __init__(self, num_hidden, prefix='gru_', params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_r', '_z', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        seq_idx = self._counter
        name = '%st%d_' % (self._prefix, seq_idx)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name='%si2h' % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name='%sh2h' % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name='%si2h_slice' % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name='%sh2h_slice' % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type='sigmoid',
                                       name='%sr_act' % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type='sigmoid',
                                        name='%sz_act' % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type='tanh',
                                       name='%sh_act' % name)
        next_h = symbol._plus((1. - update_gate) * next_h_tmp,
                              update_gate * prev_state_h,
                              name='%sout' % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the whole sequence
    (reference rnn_cell.py:459, targeting cudnn_rnn-inl.h)."""

    def __init__(self, num_hidden, num_layers=1, mode='lstm',
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = '%s_' % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = ['l', 'r'] if bidirectional else ['l']
        self._parameter = self.params.get('parameters')

    @property
    def state_info(self):
        b = self._num_layers * len(self._directions)
        n = (self._mode == 'lstm') + 1
        return [{'shape': (b, 0, self._num_hidden), '__layout__': 'LNC'}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {'rnn_relu': [''], 'rnn_tanh': [''],
                'lstm': ['_i', '_f', '_c', '_o'],
                'gru': ['_r', '_z', '_o']}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """View the packed blob as per-layer args using the op layout."""
        args = {}
        specs, _ = rnn_param_layout(self._mode, li, lh, self._num_layers,
                                    self._bidirectional)
        for name, shape, offset in specs:
            size = 1
            for s in shape:
                size *= s
            args[self._prefix + name] = \
                arr.reshape((-1,))[offset:offset + size].reshape(shape)
        return args

    def unpack_weights(self, args):
        args = dict(args)
        arr = args.pop(self._parameter.name)
        h = self._num_hidden
        num_input = _infer_input_size(arr.size, self._mode, h,
                                      self._num_layers, self._bidirectional)
        packed = self._slice_weights(arr, num_input, h)
        args.update({name: nd_arr.copy() if hasattr(nd_arr, 'copy')
                     else nd_arr for name, nd_arr in packed.items()})
        return args

    def pack_weights(self, args):
        args = dict(args)
        w0 = args[self._prefix + 'l0_i2h_weight']
        num_input = w0.shape[1]
        total = rnn_param_size(self._mode, num_input, self._num_hidden,
                               self._num_layers, self._bidirectional)
        flat = np.zeros((total,), dtype='float32')
        specs, _ = rnn_param_layout(self._mode, num_input, self._num_hidden,
                                    self._num_layers, self._bidirectional)
        for name, shape, offset in specs:
            size = int(np.prod(shape))
            val = args.pop(self._prefix + name)
            flat[offset:offset + size] = \
                (val.asnumpy() if hasattr(val, 'asnumpy')
                 else np.asarray(val)).reshape(-1)
        args[self._parameter.name] = nd.array(flat)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError('FusedRNNCell cannot be stepped. '
                                  'Please use unroll')

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix='', layout='NTC', merge_outputs=None):
        """One fused RNN op over the whole sequence (rnn_cell.py:560)."""
        self.reset()
        axis = layout.find('T')
        if inputs is None:
            inputs = [symbol.Variable('%st%d_data' % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1
            if axis == 1:
                inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        else:
            assert len(inputs) == length
            inputs = [symbol.expand_dims(i, axis=0) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=0)
        kwargs = {}
        if begin_state is not None:
            states = begin_state
            kwargs['use_state'] = True
            kwargs['state'] = states[0]
            if self._mode == 'lstm':
                kwargs['state_cell'] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode,
                         name=self._prefix + 'rnn', **kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == 'lstm':
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = symbol.SliceChannel(outputs, axis=axis,
                                          num_outputs=length,
                                          squeeze_axis=1)
            outputs = [outputs[i] for i in range(length)]
        return outputs, states

    def unfuse(self):
        """Equivalent un-fused stacked cells (rnn_cell.py:620)."""
        stack = SequentialRNNCell()
        get_cell = {
            'rnn_relu': lambda cell_prefix: RNNCell(
                self._num_hidden, activation='relu', prefix=cell_prefix),
            'rnn_tanh': lambda cell_prefix: RNNCell(
                self._num_hidden, activation='tanh', prefix=cell_prefix),
            'lstm': lambda cell_prefix: LSTMCell(self._num_hidden,
                                                 prefix=cell_prefix),
            'gru': lambda cell_prefix: GRUCell(self._num_hidden,
                                               prefix=cell_prefix),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell('%sl%d_' % (self._prefix, i)),
                    get_cell('%sr%d_' % (self._prefix, i)),
                    output_prefix='%sbi_%s_%d' % (self._prefix,
                                                  self._mode, i)))
            else:
                stack.add(get_cell('%sl%d_' % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix='%s_dropout%d_' % (self._prefix,
                                                                i)))
        return stack


def _infer_input_size(total, mode, h, num_layers, bidirectional):
    """Solve packed blob size for the layer-0 input size."""
    for num_input in range(1, 100000):
        if rnn_param_size(mode, num_input, h, num_layers,
                          bidirectional) == total:
            return num_input
    raise ValueError('cannot infer input size from parameter blob')


def _total_wo_input(mode, h, num_layers, bidirectional):
    return rnn_param_size(mode, 0, h, num_layers, bidirectional)


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (reference rnn_cell.py:656)."""

    def __init__(self, params=None):
        super().__init__(prefix='', params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                'Either specify params for SequentialRNNCell or child cells, not both.'
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix='', layout='NTC', merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, input_prefix=input_prefix,
                begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Run two cells in both directions (reference rnn_cell.py:730)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix='bi_'):
        super().__init__('', params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                'Either specify params for BidirectionalCell or child cells, not both.'
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError('Bidirectional cannot be stepped. '
                                  'Please use unroll')

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix='', layout='NTC', merge_outputs=None):
        self.reset()
        axis = layout.find('T')
        if inputs is None:
            inputs = [symbol.Variable('%st%d_data' % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1
            inputs = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name='%st%d' % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        states = [l_states, r_states]
        return outputs, states


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference rnn_cell.py:809)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class DropoutCell(BaseRNNCell):
    """Dropout on outputs (reference rnn_cell.py:775)."""

    def __init__(self, dropout, prefix='dropout_', params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:862)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            'FusedRNNCell doesn\'t support zoneout. Please unfuse first.'
        assert not isinstance(base_cell, BidirectionalCell), \
            'BidirectionalCell doesn\'t support zoneout since it doesn\'t ' \
            'support step. Please add ZoneoutCell to the cells underneath instead.'
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0. else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Residual connection around a cell."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol._plus(output, inputs)
        return output, states
