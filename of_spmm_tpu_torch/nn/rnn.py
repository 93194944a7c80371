"""Recurrent layers, the counterparts of the JAX package's
``of_spmm_tpu/nn/rnn.py``: ``LSTM``, ``GRU`` and ``RNN`` (tanh or relu),
each single-layer and unidirectional over (T, B, I) sequences.

Parameters ``w_ih`` (G H, I), ``w_hh`` (G H, H), ``b_ih`` and ``b_hh``
(G H,) in torch's gate order (i, f, g, o for the LSTM, r, z, n for the
GRU), uniform in +-1/sqrt(H). ``forward(x, state=None)`` returns
``(ys, final state)``: (h, c) for the LSTM, h for the others, each
(B, H); ``state`` defaults to zeros.

The time loop is torch's own recurrence (``torch._VF.lstm`` / ``gru`` /
``rnn_tanh`` / ``rnn_relu``, what ``torch.nn.LSTM`` calls) with these
four tensors as its one layer's weights: one call for the whole sequence
(cuDNN on the card) instead of T steps from Python. Its equations are the
JAX step's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from of_spmm_tpu_torch.nn.layers import _uniform
from of_spmm_tpu_torch.utils.device import resolve_device


class _Recurrent(torch.nn.Module):
    _gates = 1

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        g, h, bound = self._gates * self.hidden_size, self.hidden_size, 1.0 / math.sqrt(hidden_size)
        self.w_ih = _uniform((g, self.input_size), bound, dev, generator)
        self.w_hh = _uniform((g, h), bound, dev, generator)
        self.b_ih = _uniform((g,), bound, dev, generator)
        self.b_hh = _uniform((g,), bound, dev, generator)

    def _weights(self) -> list:
        return [self.w_ih, self.w_hh, self.b_ih, self.b_hh]

    def _zeros(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros((1, x.shape[1], self.hidden_size))

    def _run(self, fn, x: torch.Tensor, hx):
        # (input, hx, weights, has_biases, num_layers, dropout, train,
        # bidirectional, batch_first); train=True keeps what cuDNN's
        # backward needs (there is no dropout)
        return fn(x, hx, self._weights(), True, 1, 0.0, True, False, False)


class LSTM(_Recurrent):
    """Single-layer unidirectional LSTM over (T, B, I)."""

    _gates = 4

    def forward(self, x: torch.Tensor, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        hx = ((self._zeros(x), self._zeros(x)) if state is None
              else (state[0][None], state[1][None]))
        ys, h, c = self._run(torch._VF.lstm, x, hx)
        return ys, (h[0], c[0])


class GRU(_Recurrent):
    """Single-layer unidirectional GRU over (T, B, I)."""

    _gates = 3

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None):
        ys, h = self._run(torch._VF.gru, x, self._zeros(x) if state is None else state[None])
        return ys, h[0]


class RNN(_Recurrent):
    """Elman RNN, h = act(x w_ih^T + b_ih + h w_hh^T + b_hh), act tanh or relu."""

    def __init__(self, input_size: int, hidden_size: int, nonlinearity: str = "tanh",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, device=device, generator=generator)
        self.nonlinearity = nonlinearity

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor] = None):
        fn = torch._VF.rnn_tanh if self.nonlinearity == "tanh" else torch._VF.rnn_relu
        ys, h = self._run(fn, x, self._zeros(x) if state is None else state[None])
        return ys, h[0]


__all__ = ["GRU", "LSTM", "RNN"]
