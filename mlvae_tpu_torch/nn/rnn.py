"""Multi-layer, optionally bidirectional, batch-first LSTM and GRU
(counterparts of ``mlvae_tpu/nn/rnn.py`` ``LSTM`` and ``GRU``).

Parameters carry ``torch.nn.LSTM``'s names and layouts
(``weight_ih_l{k}[_reverse]`` (4H, In), ``weight_hh_l{k}[_reverse]``
(4H, H), ``bias_ih_...``, ``bias_hh_...``) and the gate order i, f, g, o.
The initial state is zero. Each layer takes the kernel tier the JAX
package's ``_lstm_layer`` picks (``mlvae_tpu/nn/rnn.py:150-223``):

- the fused input projection, for the streams ``MLVAE_PALLAS_FUSED``
  sends there (``PALLAS_LSTM_FUSED``: by default bf16 (AMP) streams only;
  ``1`` f32 streams too; ``0`` none): ``ops.lstm.LSTMFused`` (K3) where
  ``fused_eligible`` holds for the input width padded to a multiple of
  128, else ``LSTMSemiFused`` (K4) where ``semifused_eligible`` does (the
  budgets take the dtype: at H=512 an f32 layer of In 128 takes K3, of In
  512 K4, of In 1,024 neither). x and W_ih are zero-padded to that width
  exactly where the JAX package pads (the pad's backward slices dW_ih
  back), the bias is ``b_ih + b_hh`` summed in the stream dtype and then
  cast to f32, W_hh is cast to the stream dtype, and hs and the final
  states come back in it;
- every other layer takes K1 where H % 16 == 0 (on bf16 streams where H
  % 128 == 0): the input projection of every time step is one
  ``torch.matmul`` outside the recurrence in the stream dtype, as the JAX
  package leaves it to XLA, and the recurrence is
  ``ops.lstm.LSTMRecurrence`` (K1-fwd forward, K1-bwd backward on the
  card), so autograd gives dX, dW_ih and the biases from its dgx as XLA
  does from the Pallas kernel's; W_hh enters it in the stream dtype (on
  bf16 streams: LSTM_FC's four H=1024 layers, the CRDNN's first, In=7,680
  at H=512, and under ``MLVAE_PALLAS_FUSED=0`` every layer). The JAX
  package also leaves the kernels for a bf16-carry ``lax.scan`` when B is
  not a multiple of 16 (``_pallas_eligible``): that is a TPU tiling
  limit, not semantics, and the port keeps its kernels for every B.
- the JAX package's ``lax.scan`` path (``mlvae_tpu/nn/rnn.py:225-239``,
  with ``_lstm_cell``) is ``lstm_scan``, the plain recurrence in torch ops
  with its rounding points, on the card too (there is no Pallas kernel
  there to port). It takes a bf16 layer outside both fused tiers whose H
  is not a multiple of 128 (no K1 bf16 build; the JAX package's bf16-carry
  scan, e.g. w2v_CRDNN_CTC's H=32 under ``--bf16``), and a layer of either
  dtype whose H is not a multiple of 16 (no K1 build at all; the JAX
  package runs its scan at any H). ``lstm_route`` decides by shape and
  dtype before any launch.

The stack runs time-major, with one transpose in and one out. A
bidirectional layer outputs ``[fwd, bwd]``; the reverse direction is
indexing inside the recurrence, never a flip. Dropout applies between
layers and only while training, with one time-major (T, B, D*H) keep-mask
per gap, the shape the JAX module draws.

``GRU`` keeps ``torch.nn.GRU``'s constructor, parameter names and layouts
(gate order r, z, n) and the JAX ``GRU``'s semantics
(``mlvae_tpu/nn/rnn.py:345-460``): each layer direction forms
``x @ W_ih^T + b_ih`` as one ``torch.matmul`` outside the recurrence and
runs ``ops.gru.GRURecurrence`` (K5-fwd forward, K5-bwd backward on the
card) with W_hh cast to the stream dtype and b_hh to f32, for f32 and bf16
streams alike, but where the JAX ``_gru_layer`` runs its ``lax.scan``
(``mlvae_tpu/nn/rnn.py:362,386``) for a reason of semantics: a bf16 layer
whose H is not a multiple of 128, and a layer of either dtype whose H is
not a multiple of 16, take ``gru_scan``, its recurrence in torch ops
(``gru_route``). As for the LSTM, the JAX package's bf16-carry scan for a
bf16 B that is not a multiple of 16 is a TPU tiling limit, and the port
keeps its kernels for every B.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlvae_tpu_torch.nn.layers import dropout, uniform_
from mlvae_tpu_torch.ops.gru import GRURecurrence
from mlvae_tpu_torch.ops.lstm import (LSTMFused, LSTMRecurrence,
                                      LSTMSemiFused, fused_eligible,
                                      semifused_eligible)
from mlvae_tpu_torch.utils.envflags import env_tristate

LANE = 128   # the JAX package pads the fused kernels' input width to this

# ``MLVAE_PALLAS_FUSED`` as the JAX package reads it (``mlvae_tpu/nn/
# rnn.py``), at import: "auto" (unset) sends bf16 streams to the fused
# tiers, True (``1``) f32 streams too, False (``0``) neither, so that every
# layer takes K1 or the scan; any other value raises ``ValueError``.
PALLAS_LSTM_FUSED = env_tristate("MLVAE_PALLAS_FUSED", "auto")


def _fused_requested(dtype) -> bool:
    """Whether ``MLVAE_PALLAS_FUSED`` sends a ``dtype`` stream to the fused
    tiers (``_fused_requested`` of the JAX package): ``auto`` bf16 only,
    ``1`` f32 and bf16, ``0`` neither. Eligibility is the shape's."""
    if PALLAS_LSTM_FUSED == "auto":
        return dtype == torch.bfloat16
    return bool(PALLAS_LSTM_FUSED)


def fused_tier(In: int, H: int, dtype):
    """The fused kernel a ``dtype`` stream of input width ``In`` takes
    (``LSTMFused`` or ``LSTMSemiFused``), or None: where the switch
    requests the tiers for the dtype, the first whose budget the input
    width padded to a multiple of 128 fits, as the JAX package picks it."""
    if dtype not in (torch.float32, torch.bfloat16) \
            or not _fused_requested(dtype):
        return None
    In_pad = -(-In // LANE) * LANE
    if fused_eligible(In_pad, H, dtype):
        return LSTMFused
    if semifused_eligible(In_pad, H, dtype):
        return LSTMSemiFused
    return None


def takes_scan(H: int, dtype) -> bool:
    """Whether a recurrent layer of hidden width H on a ``dtype`` stream
    outside the fused tiers runs the plain recurrence: every H that is
    not a multiple of 16 (no K1 or K5 build), and a bf16 H that is not a
    multiple of 128 (the JAX package's bf16-carry scan, where its Pallas
    kernels need the 128-lane tile)."""
    return H % 16 != 0 or (dtype == torch.bfloat16 and H % LANE != 0)


def lstm_route(In: int, H: int, dtype):
    """What runs an LSTM layer: ``LSTMFused`` / ``LSTMSemiFused`` (K3,
    K4), ``"scan"`` (``lstm_scan``) or ``"k1"`` (``LSTMRecurrence``)."""
    tier = fused_tier(In, H, dtype)
    if tier is not None:
        return tier
    return "scan" if takes_scan(H, dtype) else "k1"


def gru_route(H: int, dtype) -> str:
    """``"scan"`` (``gru_scan``) or ``"k5"`` (``GRURecurrence``)."""
    return "scan" if takes_scan(H, dtype) else "k5"


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype (in bf16 this differs from ``torch.sigmoid``'s
    one rounding in about 30 % of values)."""
    return 1.0 / (1.0 + torch.exp(-x))


def lstm_scan(gx: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False):
    """The JAX package's ``lax.scan`` LSTM over gx (T, B, 4H) = x W_ih^T +
    biases and W_hh (4H, H), both in the stream dtype: ``h @ W_hh^T`` in
    that dtype (f32 sums), added to gx, the gates' sigmoid (``logistic``)
    and tanh, ``c = f c + i g`` and ``h = o tanh(c)``, each op rounded to
    the stream dtype, the carries (h, c) kept in it from zeros. Autograd gives the
    gradients. Returns (hs (T, B, H), c_last (B, H)), c_last after the last
    PROCESSED step (t=0 when ``reverse``)."""
    T, B, _ = gx.shape
    H = w_hh.shape[1]
    w_t = w_hh.t()
    h = gx.new_zeros((B, H))
    c = gx.new_zeros((B, H))
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = gx[t] + h @ w_t
        i = logistic(g[:, :H])
        f = logistic(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = logistic(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, 0), c


def gru_scan(gx: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """The JAX ``_gru_layer``'s ``lax.scan`` over gx (T, B, 3H) = x W_ih^T
    + b_ih, W_hh (3H, H) and b_hh (3H,), all in the stream dtype: ``gh = h
    @ W_hh^T + b_hh``, ``r``, ``z`` the ``logistic`` of gx + gh, ``n = tanh(gx_n
    + r gh_n)``, ``h = (1 - z) n + z h``, each op rounded to the stream
    dtype, h kept in it from zeros. Returns hs (T, B, H)."""
    T, B, _ = gx.shape
    H = w_hh.shape[1]
    w_t = w_hh.t()
    h = gx.new_zeros((B, H))
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = h @ w_t + b_hh
        x_t = gx[t]
        r = logistic(x_t[:, :H] + gh[:, :H])
        z = logistic(x_t[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(x_t[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return torch.stack(hs, 0)


class _Stack(nn.Module):
    """What the LSTM and GRU stacks share: their directions, parameter
    suffixes and dropout masks."""

    @property
    def _dirs(self) -> int:
        return 2 if self.bidirectional else 1

    def _suffixes(self, layer: int):
        return [f"l{layer}"] + ([f"l{layer}_reverse"]
                                if self.bidirectional else [])

    def dropout_shapes(self, B: int, T: int):
        """The keep-masks one training forward draws, in order: one
        (T, B, D*H) mask per gap between layers, none without dropout."""
        if self.dropout <= 0.0:
            return []
        return [(T, B, self._dirs * self.hidden_size)] * (self.num_layers - 1)


class LSTM(_Stack):
    """``forward(x (B, T, In)) -> (out (B, T, D*H), (h_n, c_n))`` with
    ``h_n``, ``c_n`` of shape (num_layers * D, B, H). The constructor takes
    the JAX ``LSTM``'s arguments in its order; ``bias=False`` means zero
    biases and no bias parameters, and ``batch_first=False`` is refused in
    ``forward``, as the JAX module refuses it."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, batch_first: bool = True,
                 dropout: float = 0.0, bidirectional: bool = False,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.batch_first = bool(batch_first)
        self.dropout = float(dropout)
        self.bidirectional = bool(bidirectional)
        self.bias = bool(bias)
        H = self.hidden_size
        bound = 1.0 / math.sqrt(H)
        for layer in range(self.num_layers):
            in_size = self.input_size if layer == 0 else H * self._dirs
            for sfx in self._suffixes(layer):
                shapes = [("weight_ih", (4 * H, in_size)),
                          ("weight_hh", (4 * H, H))]
                if self.bias:
                    shapes += [("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))]
                for name, shape in shapes:
                    self.register_parameter(f"{name}_{sfx}", nn.Parameter(
                        uniform_(torch.empty(shape, device=device), bound,
                                 generator)))

    def _gates(self, x: torch.Tensor, sfx: str, folded: bool):
        """x (T, B, In) -> gx (T, B, 4H). ``folded`` sums the two biases
        before adding them, as the JAX package does for bidirectional
        layers; otherwise they are added one after the other. Without
        biases gx is the product alone."""
        gx = torch.matmul(x, getattr(self, f"weight_ih_{sfx}").t())
        if not self.bias:
            return gx
        b_ih = getattr(self, f"bias_ih_{sfx}")
        b_hh = getattr(self, f"bias_hh_{sfx}")
        return gx + (b_ih + b_hh) if folded else gx + b_ih + b_hh

    def _fused(self, x: torch.Tensor, sfx: str, tier, reverse: bool):
        """One layer direction through a fused tier: x (T, B, In) f32 or
        bf16 -> (hs (T, B, H) in x's dtype, c_last (B, H) f32). The kernels take an f32 bias,
        zeros without biases."""
        w_ih = getattr(self, f"weight_ih_{sfx}")
        w_hh = getattr(self, f"weight_hh_{sfx}")
        if self.bias:
            bias = (getattr(self, f"bias_ih_{sfx}")
                    + getattr(self, f"bias_hh_{sfx}")).float()
        else:
            bias = x.new_zeros((4 * self.hidden_size,), dtype=torch.float32)
        pad = -x.shape[-1] % LANE
        if pad:
            x = F.pad(x, (0, pad))
            w_ih = F.pad(w_ih, (0, pad))
        return tier.apply(x.contiguous(), w_ih.to(x.dtype).contiguous(),
                          bias, w_hh.to(x.dtype).contiguous(), reverse)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None):
        """``masks``: the keep-masks of ``dropout_shapes``, else drawn from
        ``generator`` while training."""
        if not self.batch_first:
            raise ValueError("LSTM: only batch_first=True is supported")
        out = x.transpose(0, 1).contiguous()   # (T, B, In)
        last_h, last_c = [], []
        for layer in range(self.num_layers):
            outs = []
            route = lstm_route(out.shape[-1], self.hidden_size, out.dtype)
            for d, sfx in enumerate(self._suffixes(layer)):
                if route in ("scan", "k1"):
                    gx = self._gates(out, sfx, folded=self.bidirectional)
                    w_hh = getattr(self, f"weight_hh_{sfx}").to(gx.dtype)
                    hs, c_last = (lstm_scan if route == "scan"
                                  else LSTMRecurrence.apply)(
                        gx.contiguous(), w_hh.contiguous(), d == 1)
                else:
                    hs, c_last = self._fused(out, sfx, route, d == 1)
                # final state after the last PROCESSED step (t=0 reversed)
                last_h.append(hs[0] if d == 1 else hs[-1])
                last_c.append(c_last.to(x.dtype))
                outs.append(hs)
            out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, train, generator,
                              mask=masks[layer] if masks else None)
        return (out.transpose(0, 1),
                (torch.stack(last_h, 0), torch.stack(last_c, 0)))


class GRU(_Stack):
    """``forward(x (B, T, In)) -> (out (B, T, D*H), h_n (num_layers * D, B,
    H))``. ``bias=False`` means zero biases and no bias parameters."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, batch_first: bool = True,
                 dropout: float = 0.0, bidirectional: bool = False,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not batch_first:
            raise ValueError("only batch_first=True is supported")
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout)
        self.bidirectional = bool(bidirectional)
        self.bias = bool(bias)
        H = self.hidden_size
        bound = 1.0 / math.sqrt(H)
        for layer in range(self.num_layers):
            in_size = self.input_size if layer == 0 else H * self._dirs
            for sfx in self._suffixes(layer):
                shapes = [("weight_ih", (3 * H, in_size)),
                          ("weight_hh", (3 * H, H))]
                if self.bias:
                    shapes += [("bias_ih", (3 * H,)), ("bias_hh", (3 * H,))]
                for name, shape in shapes:
                    self.register_parameter(f"{name}_{sfx}", nn.Parameter(
                        uniform_(torch.empty(shape, device=device), bound,
                                 generator)))

    def _bias(self, name: str, x: torch.Tensor):
        if self.bias:
            return getattr(self, name)
        return x.new_zeros((3 * self.hidden_size,))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None):
        """``masks``: the keep-masks of ``dropout_shapes``, else drawn from
        ``generator`` while training."""
        out = x.transpose(0, 1)   # (T, B, In)
        last_h = []
        for layer in range(self.num_layers):
            outs = []
            route = gru_route(self.hidden_size, out.dtype)
            for d, sfx in enumerate(self._suffixes(layer)):
                gx = torch.matmul(
                    out, getattr(self, f"weight_ih_{sfx}").t()) \
                    + self._bias(f"bias_ih_{sfx}", out)
                w_hh = getattr(self, f"weight_hh_{sfx}").to(out.dtype)
                b_hh = self._bias(f"bias_hh_{sfx}", out)
                if route == "scan":
                    hs = gru_scan(gx, w_hh, b_hh.to(out.dtype), d == 1)
                else:
                    hs = GRURecurrence.apply(
                        gx.contiguous(), w_hh.contiguous(),
                        b_hh.float().contiguous(), d == 1)
                # final state after the last PROCESSED step (t=0 reversed)
                last_h.append(hs[0] if d == 1 else hs[-1])
                outs.append(hs)
            out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, train, generator,
                              mask=masks[layer] if masks else None)
        return out.transpose(0, 1), torch.stack(last_h, 0)
