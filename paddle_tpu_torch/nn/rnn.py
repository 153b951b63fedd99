"""Recurrent layers: ``LSTM``, ``GRU``, ``SimpleRNN`` (multi-layer,
bidirectional, batch-first unless ``time_major``, ``sequence_length``) and
their cells, over the recurrence ops of ``ops/kernels/rnn.py``.

Counterpart of ``paddle_tpu/nn/rnn.py:18-249``: the reference's parameter
names and shapes (``weight_ih_l{k}[_reverse]`` ``[gates·H, in]``, ...; the
layouts torch's ``nn.LSTM`` takes), so ``models.from_jax_state_dict``
loads them name for name; inter-layer dropout through the ``dropout`` op.
The default initial states are zeros of ``[layers·directions, B, H]`` in
x's dtype on x's device.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from ..ops.dispatcher import call_op
from . import initializer as I
from .layer_base import Layer

__all__ = ["LSTM", "GRU", "SimpleRNN", "LSTMCell", "GRUCell",
           "SimpleRNNCell"]


class _RNNBase(Layer):
    GATES = {"lstm": 4, "gru": 3, "rnn": 1}

    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 time_major: bool = False, dropout: float = 0.0,
                 activation: str = "tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.num_directions = 2 if self.bidirectional else 1
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        g = self.GATES[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self._tags: List[str] = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                isize = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                tag = f"{layer}{'_reverse' if d else ''}"
                w_ih = self.create_parameter([g * hidden_size, isize],
                                             attr=weight_ih_attr,
                                             default_initializer=init)
                w_hh = self.create_parameter([g * hidden_size, hidden_size],
                                             attr=weight_hh_attr,
                                             default_initializer=init)
                b_ih = self.create_parameter([g * hidden_size], is_bias=True,
                                             attr=bias_ih_attr,
                                             default_initializer=init)
                b_hh = self.create_parameter([g * hidden_size], is_bias=True,
                                             attr=bias_hh_attr,
                                             default_initializer=init)
                for name, p in ((f"weight_ih_l{tag}", w_ih),
                                (f"weight_hh_l{tag}", w_hh),
                                (f"bias_ih_l{tag}", b_ih),
                                (f"bias_hh_l{tag}", b_hh)):
                    setattr(self, name, p)
                self._tags.append(tag)

    def _weights(self, idx: int) -> Tuple:
        """Layer-direction ``idx``'s (w_ih, w_hh, b_ih, b_hh), looked up
        by name (a moved or loaded layer keeps no stale references)."""
        tag = self._tags[idx]
        return tuple(getattr(self, f"{n}_l{tag}") for n in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def _run_layer(self, x, weights, h0, c0, reverse: bool, lens):
        """x: [T, B, I] (time-major internally). Direction and
        variable-length masking live in the kernel (per-sample in-range
        reverse — padding never leads the backward scan)."""
        w_ih, w_hh, b_ih, b_hh = weights
        if self.mode == "lstm":
            out, hT, cT = call_op("lstm_layer", x, w_ih, w_hh, b_ih, b_hh,
                                  h0, c0, lens, reverse=reverse)
        elif self.mode == "gru":
            out, hT = call_op("gru_layer", x, w_ih, w_hh, b_ih, b_hh, h0,
                              lens, reverse=reverse)
            cT = None
        else:
            out, hT = call_op("simple_rnn_layer", x, w_ih, w_hh, b_ih, b_hh,
                              h0, lens, reverse=reverse,
                              activation=self.activation)
            cT = None
        return out, hT, cT

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if not self.time_major:
            x = call_op("transpose", x, perm=[1, 0, 2])   # [T, B, I]
        B = x.shape[1]
        H, NL, ND = self.hidden_size, self.num_layers, self.num_directions

        if initial_states is None:
            zeros = x.new_zeros((NL * ND, B, H))
            h_init = zeros
            c_init = zeros if self.mode == "lstm" else None
        elif self.mode == "lstm":
            h_init, c_init = initial_states
        else:
            h_init, c_init = initial_states, None

        h_finals, c_finals = [], []
        layer_in = x
        for layer in range(NL):
            outs = []
            for d in range(ND):
                idx = layer * ND + d
                h0 = h_init[idx]
                c0 = c_init[idx] if c_init is not None else None
                out, hT, cT = self._run_layer(layer_in, self._weights(idx),
                                              h0, c0, reverse=bool(d),
                                              lens=sequence_length)
                outs.append(out)
                h_finals.append(hT)
                if cT is not None:
                    c_finals.append(cT)
            layer_in = (call_op("concat", outs, axis=-1) if ND == 2
                        else outs[0])
            if self.dropout and layer < NL - 1 and self.training:
                layer_in = call_op("dropout", layer_in, p=self.dropout,
                                   training=True)

        out = layer_in
        if not self.time_major:
            out = call_op("transpose", out, perm=[1, 0, 2])
        h_stack = call_op("stack", h_finals, axis=0)
        if self.mode == "lstm":
            c_stack = call_op("stack", c_finals, axis=0)
            return out, (h_stack, c_stack)
        return out, h_stack


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("lstm", input_size, hidden_size, num_layers,
                         direction, time_major, dropout,
                         weight_ih_attr=weight_ih_attr,
                         weight_hh_attr=weight_hh_attr,
                         bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("gru", input_size, hidden_size, num_layers,
                         direction, time_major, dropout,
                         weight_ih_attr=weight_ih_attr,
                         weight_hh_attr=weight_hh_attr,
                         bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("rnn", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         weight_ih_attr=weight_ih_attr,
                         weight_hh_attr=weight_hh_attr,
                         bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)


class _CellBase(Layer):
    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        g = _RNNBase.GATES[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self.mode = mode
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([g * hidden_size, input_size],
                                               attr=weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([g * hidden_size, hidden_size],
                                               attr=weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([g * hidden_size], is_bias=True,
                                             attr=bias_ih_attr,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([g * hidden_size], is_bias=True,
                                             attr=bias_hh_attr,
                                             default_initializer=init)


class LSTMCell(_CellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__("lstm", input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        B = inputs.shape[0]
        if states is None:
            z = inputs.new_zeros((B, self.hidden_size))
            states = (z, z)
        h, c = states
        x1 = call_op("unsqueeze", inputs, axis=0)
        out, hT, cT = call_op("lstm_layer", x1, self.weight_ih,
                              self.weight_hh, self.bias_ih, self.bias_hh,
                              h, c)
        return hT, (hT, cT)


class GRUCell(_CellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__("gru", input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        B = inputs.shape[0]
        if states is None:
            states = inputs.new_zeros((B, self.hidden_size))
        x1 = call_op("unsqueeze", inputs, axis=0)
        out, hT = call_op("gru_layer", x1, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh, states)
        return hT, hT


class SimpleRNNCell(_CellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("rnn", input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def forward(self, inputs, states=None):
        B = inputs.shape[0]
        if states is None:
            states = inputs.new_zeros((B, self.hidden_size))
        x1 = call_op("unsqueeze", inputs, axis=0)
        out, hT = call_op("simple_rnn_layer", x1, self.weight_ih,
                          self.weight_hh, self.bias_ih, self.bias_hh,
                          states, activation=self.activation)
        return hT, hT
