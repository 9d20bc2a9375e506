"""Recurrent layers (port of ``paddle1_tpu/nn/layer_rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell`` over ``RNNCellBase``, the
wrappers ``RNN`` and ``BiRNN``, and the multi-layer nets ``SimpleRNN``,
``LSTM`` and ``GRU`` over ``RNNBase``.

The JAX package computes them with ``lax.scan`` in XLA, outside any Pallas
kernel, so the port computes them with PyTorch's own recurrent ops: a cell
step is ``torch._VF.lstm_cell`` / ``gru_cell`` / ``rnn_tanh_cell`` /
``rnn_relu_cell`` (what ``torch.nn.LSTMCell`` calls), a net is one
``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu`` call a layer
(cuDNN on the card). Paddle's gate layouts are PyTorch's (LSTM ``i, f, g,
o`` in one ``[4H, in]`` weight; GRU ``r, z, n`` with ``n = tanh(W_in x +
b_in + r * (W_hn h + b_hn))``), and so are the parameter names
(``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
``bias_hh_l{k}``, ``_reverse`` for the second direction), so no weight is
rearranged. Every weight and bias starts from ``Uniform(±1/√H)``.

As in the JAX package, ``RNN`` calls its cell once per step in Python,
and ``sequence_length`` is taken and never read by ``RNN``, ``BiRNN`` and
the nets (the states run on over the padding; Paddle's reference masks
them: ROADMAP, "Notes on the reference"). Dropout goes between the
layers of a net only, in training, through ``F.dropout`` (the device's
default generator, which ``paddle.seed`` seeds), not through ``_VF``'s
own ``dropout`` argument, which takes no generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from ..core.tensor import Tensor
from . import functional as F
from .initializer import Uniform
from .layer_base import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU", "RNNCellBase", "RNNBase"]

_DIRECTIONS = {"forward": 1, "bidirect": 2, "bidirectional": 2}


def _uniform_params(layer, shapes_attrs, hidden_size, device, generator):
    """One parameter per ``(shape, attr, is_bias)``, each from
    ``Uniform(±1/√hidden_size)``."""
    std = 1.0 / math.sqrt(hidden_size)
    kw = dict(default_initializer=Uniform(-std, std),
              device=resolve_device(device), generator=generator)
    return [layer.create_parameter(shape, attr, is_bias=is_bias, **kw)
            for shape, attr, is_bias in shapes_attrs]


def _rows(fn, x, *states):
    """``fn`` (a ``_VF`` cell, which takes 1-D or 2-D inputs) on inputs
    of any rank: the leading dimensions folded into one and unfolded
    after."""
    if x.dim() <= 2:
        return fn(x, *states)
    lead = x.shape[:-1]
    flat = [torch.reshape(s, (-1, s.shape[-1])) for s in states]
    out = fn(torch.reshape(x, (-1, x.shape[-1])), *flat)
    if isinstance(out, tuple):
        return tuple(torch.reshape(o, (*lead, o.shape[-1])) for o in out)
    return torch.reshape(out, (*lead, out.shape[-1]))


class RNNCellBase(Layer):
    """Base of the cells: :meth:`get_initial_states`."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """``[batch, hidden_size]`` filled with ``init_value``, the batch
        read from ``batch_ref``'s ``batch_dim_idx`` axis, on its device.
        ``shape`` is taken and not read, as in the JAX package."""
        b = int(batch_ref.shape[batch_dim_idx])
        return torch.full((b, self.hidden_size), init_value,
                          dtype=dtypes.convert_dtype(dtype),
                          device=batch_ref.device).as_subclass(Tensor)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh for
    ``activation="tanh"``, else ReLU; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _uniform_params(self, (
             ([hidden_size, input_size], weight_ih_attr, False),
             ([hidden_size, hidden_size], weight_hh_attr, False),
             ([hidden_size], bias_ih_attr, True),
             ([hidden_size], bias_hh_attr, True)), hidden_size, device,
            generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        fn = torch._VF.rnn_tanh_cell if self.activation == "tanh" else \
            torch._VF.rnn_relu_cell
        h = _rows(lambda x, s: fn(x, s, self.weight_ih, self.weight_hh,
                                  self.bias_ih, self.bias_hh), inputs, states)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """The LSTM step, gates ``i, f, g, o`` packed in one ``[4H, in]``
    weight; returns ``(h', (h', c'))``. ``proj_size`` is taken and not
    applied, as in the JAX package."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = 4 * hidden_size
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _uniform_params(self, (
             ([g, input_size], weight_ih_attr, False),
             ([g, hidden_size], weight_hh_attr, False),
             ([g], bias_ih_attr, True), ([g], bias_hh_attr, True)),
            hidden_size, device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        new_h, new_c = _rows(
            lambda x, h_, c_: torch._VF.lstm_cell(
                x, (h_, c_), self.weight_ih, self.weight_hh, self.bias_ih,
                self.bias_hh), inputs, h, c)
        return new_h, (new_h, new_c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """The GRU step, gates ``r, z, n`` in one ``[3H, in]`` weight: ``n =
    tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))``, ``h' = (1 - z) * n +
    z * h``; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = 3 * hidden_size
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _uniform_params(self, (
             ([g, input_size], weight_ih_attr, False),
             ([g, hidden_size], weight_hh_attr, False),
             ([g], bias_ih_attr, True), ([g], bias_hh_attr, True)),
            hidden_size, device, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _rows(lambda x, s: torch._VF.gru_cell(
            x, s, self.weight_ih, self.weight_hh, self.bias_ih,
            self.bias_hh), inputs, states)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _cell_step(cell, x, states):
    res = cell(x, states)
    if isinstance(res, tuple) and len(res) == 2:
        return res
    return res, res


class RNN(Layer):
    """A cell over a sequence, one Python call of the cell a step
    (``[B, T, ...]``, or ``[T, B, ...]`` with ``time_major``; backwards
    with ``is_reverse``, the outputs in the input's order). Returns
    ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = torch.unbind(inputs, axis)
        if self.is_reverse:
            steps = steps[::-1]
        states = initial_states
        outs = []
        for x in steps:
            out, states = _cell_step(self.cell, x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, axis), states


class BiRNN(Layer):
    """A forward and a backward :class:`RNN`, their outputs concatenated
    on the last axis; the states are ``(forward's, backward's)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


class _RNNBase(Layer):
    """``num_layers`` recurrent layers, one or two directions each
    (``direction``: ``"forward"``, ``"bidirect"`` or ``"bidirectional"``),
    each layer one ``torch._VF`` call over the whole sequence. The states
    are ``[num_layers * directions, B, H]`` (LSTM's an ``(h, c)`` pair),
    zeros when not given. On the card each layer's weights are laid out
    as cuDNN's one contiguous chunk where their storage is made
    (:meth:`_cudnn_layout`). ``_VF``'s ``train`` flag (cuDNN's "keep what
    the backward needs") follows ``torch.is_grad_enabled()``: dropout is
    applied outside ``_VF``, so the flag changes no value, and following
    ``self.training`` would make a backward in eval mode raise on the
    card, where the JAX package differentiates it."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if direction not in _DIRECTIONS:
            raise InvalidArgumentError(
                f"direction must be one of {sorted(_DIRECTIONS)}, got "
                f"{direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.num_directions = _DIRECTIONS[direction]
        g = {"LSTM": 4, "GRU": 3}.get(self.MODE, 1) * hidden_size
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                params = _uniform_params(self, (
                    ([g, in_sz], weight_ih_attr, False),
                    ([g, hidden_size], weight_hh_attr, False),
                    ([g], bias_ih_attr, True), ([g], bias_hh_attr, True)),
                    hidden_size, device, generator)
                for kind, p in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), params):
                    self.add_parameter(f"{kind}{sfx}", p)
        self._cudnn_layout()

    def _layer_params(self, layer):
        out = []
        for d in range(self.num_directions):
            sfx = f"_l{layer}" + ("_reverse" if d else "")
            out += [getattr(self, f"{k}{sfx}") for k in
                    ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        return out

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._cudnn_layout()
        return out

    @torch.no_grad()
    def _cudnn_layout(self):
        """Each layer's weights on the card as views into one buffer in
        cuDNN's layout (what ``torch.nn.LSTM.flatten_parameters`` does for a
        whole net), so that cuDNN neither copies them at every call nor
        warns. Run where the weights' storage is made: at construction and
        after a move or cast (``_apply``); values, names and ``Parameter``
        objects stay."""
        mode = {"LSTM": "LSTM", "GRU": "GRU"}.get(
            self.MODE, "RNN_TANH" if self.activation == "tanh" else
            "RNN_RELU")
        for layer in range(self.num_layers):
            params = self._layer_params(layer)
            if not all(torch.backends.cudnn.is_acceptable(p) and
                       p.dtype == params[0].dtype for p in params) or \
                    not torch._use_cudnn_rnn_flatten_weight():
                continue
            in_sz = self.input_size if layer == 0 else \
                self.hidden_size * self.num_directions
            with torch.cuda.device_of(params[0]):
                torch._cudnn_rnn_flatten_weight(
                    params, 4, in_sz,
                    torch.backends.cudnn.rnn.get_cudnn_mode(mode),
                    self.hidden_size, 0, 1, False, self.num_directions == 2)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        nl, nd, hs = self.num_layers, self.num_directions, self.hidden_size
        lstm = self.MODE == "LSTM"
        if self.MODE == "GRU":
            fn = torch._VF.gru
        elif not lstm:
            fn = torch._VF.rnn_tanh if self.activation == "tanh" else \
                torch._VF.rnn_relu
        x = inputs if self.time_major else torch.transpose(inputs, 0, 1)
        if initial_states is None:
            h0 = c0 = torch.zeros((nl * nd, x.shape[1], hs), dtype=x.dtype,
                                  device=x.device)
        elif lstm:
            h0, c0 = initial_states
        else:
            h0 = initial_states
        train = torch.is_grad_enabled()
        hs_out, cs_out = [], []
        for layer in range(nl):
            lo, hi = layer * nd, (layer + 1) * nd
            params = self._layer_params(layer)
            if lstm:
                x, h, c = torch._VF.lstm(x, (h0[lo:hi], c0[lo:hi]), params,
                                         True, 1, 0.0, train, nd == 2, False)
                cs_out.append(c)
            else:
                x, h = fn(x, h0[lo:hi], params, True, 1, 0.0, train, nd == 2,
                          False)
            hs_out.append(h)
            if self.dropout > 0 and self.training and layer < nl - 1:
                x = F.dropout(x, self.dropout, training=True)
        out = x if self.time_major else torch.transpose(x, 0, 1)
        h = torch.cat(hs_out, 0)
        if lstm:
            return out, (h, torch.cat(cs_out, 0))
        return out, h


class SimpleRNN(_RNNBase):
    """Elman RNN layers (``activation`` ``"tanh"`` or ``"relu"``)."""

    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, **kwargs)


class LSTM(_RNNBase):
    """LSTM layers; the states are an ``(h, c)`` pair."""

    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class GRU(_RNNBase):
    """GRU layers."""

    MODE = "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


# the public base classes (reference nn/layer/rnn.py RNNCellBase,
# RNNBase): custom cells subclass RNNCellBase; RNNBase is the machinery
# behind SimpleRNN / LSTM / GRU
RNNBase = _RNNBase
