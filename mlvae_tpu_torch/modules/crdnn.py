"""The CRDNN acoustic encoder and VanillaNN (counterpart of
``mlvae_tpu/modules/crdnn.py``).

``CRDNN`` is SpeechBrain's ``lobes.models.CRDNN.CRDNN`` as the CTC recipes
configure it, with the JAX package's substitutions: each CNN block runs
two stages of a channels-last convolution (``nn.conv.Conv2d``, NHWC and
an HWIO weight), a LayerNorm over (freq, channels) with an (F, C) affine
and a leaky ReLU, then a frequency max-pool and channel dropout
(SpeechBrain's ``Dropout2d``: a (B, 1, 1, C) keep-mask); then a time
max-pool when ``time_pooling``; the features flattened to F*C; a
bidirectional ``nn.rnn.LSTM`` with dropout between its layers; and DNN
blocks of a Linear, a LayerNorm (the JAX package's in place of
SpeechBrain's BatchNorm1d), a leaky ReLU and dropout. The parameters carry
the JAX tree's names (``conv0a``, ``ln0a.gamma``, ``rnn.weight_ih_l0``,
``dnn0``, ``dnn_ln0.gamma``, ...), so ``convert.from_jax`` carries them
across as a flatten.

A training forward draws, in the JAX ``RngStream``'s order: each CNN
block's channel keep-mask (``cnn_dropout``), the LSTM's keep-masks
between layers (``rnn_dropout``, time-major), each DNN block's keep-mask
(``dnn_dropout``). ``draws`` lists them; ``noise`` replays them by name,
else they come from ``generator``.

Under AMP the stream stays in its dtype where the JAX module keeps it
(the convolutions, the pools, the activations, dropout, the LSTM and the
linears); the norms take f32 statistics and affine and return the stream
dtype. The first LSTM layer's input is 256 x 30 = 7,680 wide at the
recipe's widths: on bf16 streams it fits neither fused tier and takes K1
on bf16 streams; the later layers (In = 1,024) take the semi-fused tier.

``VanillaNN`` is the MLP of the HMM aligner recipe
(``speechbrain.lobes.models.VanillaNN.VanillaNN``): Linear and leaky ReLU
blocks, its weights under ``lin{i}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mlvae_tpu_torch.nn.conv import Conv2d, layer_norm, max_pool
from mlvae_tpu_torch.nn.layers import Linear, dropout, leaky_relu
from mlvae_tpu_torch.nn.rnn import LSTM


def ln_fc(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing (freq, channels) dims of (B, T, F, C)
    with an (F, C) affine; f32 statistics, the output in x's dtype."""
    xf = x.float()
    m = xf.mean(dim=(-2, -1), keepdim=True)
    v = (xf - m).square().mean(dim=(-2, -1), keepdim=True)
    out = (xf - m) * torch.rsqrt(v + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)


def dropout_channels(x: torch.Tensor, rate: float, mask: torch.Tensor
                     ) -> torch.Tensor:
    """Dropout2d on NHWC: ``mask`` (B, 1, 1, C) keeps or drops whole
    channels; kept ones scale by 1 / keep, the keep taken in x's dtype."""
    keep = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(mask.to(device=x.device, dtype=torch.bool), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Affine(nn.Module):
    """A norm's ``gamma`` (ones) and ``beta`` (zeros) of ``shape``."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(shape, device=device))
        self.beta = nn.Parameter(torch.zeros(shape, device=device))


class CRDNN(nn.Module):
    def __init__(self, input_size: int, activation=None,
                 dropout: float = 0.15, cnn_blocks: int = 2,
                 cnn_channels: Sequence[int] = (128, 256),
                 cnn_kernelsize: Sequence[int] = (3, 3),
                 time_pooling: bool = False, time_pooling_size: int = 2,
                 freq_pooling_size: int = 2, rnn_layers: int = 4,
                 rnn_neurons: int = 512, rnn_bidirectional: bool = True,
                 dnn_blocks: int = 2, dnn_neurons: int = 512,
                 generator: Optional[torch.Generator] = None, device=None,
                 **kwargs):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.input_size = int(input_size)
        self.dropout_rate = float(dropout)
        self.cnn_blocks = int(cnn_blocks)
        self.cnn_channels = tuple(int(c) for c in cnn_channels)
        kernel = tuple(int(k) for k in cnn_kernelsize)
        self.time_pooling = bool(time_pooling)
        self.time_pooling_size = int(time_pooling_size)
        self.freq_pooling_size = int(freq_pooling_size)
        self.dnn_blocks = int(dnn_blocks)
        in_ch, freq = 1, self.input_size
        for i in range(self.cnn_blocks):
            out_ch = self.cnn_channels[i]
            # both stages of a block see the block's F (SAME convolutions;
            # the pool comes after the norms)
            for stage, c_in in (("a", in_ch), ("b", out_ch)):
                setattr(self, f"conv{i}{stage}",
                        Conv2d(c_in, out_ch, kernel, **kw))
                setattr(self, f"ln{i}{stage}",
                        Affine((freq, out_ch), device=device))
            in_ch = out_ch
            freq = freq // self.freq_pooling_size
        self.rnn = LSTM(freq * in_ch, rnn_neurons, rnn_layers,
                        batch_first=True, dropout=self.dropout_rate,
                        bidirectional=rnn_bidirectional, **kw)
        dnn_in = rnn_neurons * (2 if rnn_bidirectional else 1)
        for i in range(self.dnn_blocks):
            setattr(self, f"dnn{i}", Linear(dnn_in, dnn_neurons, **kw))
            setattr(self, f"dnn_ln{i}", Affine((dnn_neurons,),
                                               device=device))
            dnn_in = dnn_neurons

    def pooled_length(self, T: int) -> int:
        return T // self.time_pooling_size if self.time_pooling else T

    def draws(self, B: int, T: int
              ) -> List[Tuple[str, str, tuple, float, torch.dtype]]:
        """A training forward's draws of input length T, in the JAX
        RngStream's order: (name, "bernoulli", shape, keep probability,
        f32), none without dropout."""
        if self.dropout_rate <= 0.0:
            return []
        keep, f32 = 1.0 - self.dropout_rate, torch.float32
        Tp = self.pooled_length(T)
        out = [("cnn_dropout", "bernoulli", (B, 1, 1, c), keep, f32)
               for c in self.cnn_channels[:self.cnn_blocks]]
        out += [("rnn_dropout", "bernoulli", s, keep, f32)
                for s in self.rnn.dropout_shapes(B, Tp)]
        out += [("dnn_dropout", "bernoulli",
                 (B, Tp, getattr(self, f"dnn{i}").weight.shape[0]), keep,
                 f32) for i in range(self.dnn_blocks)]
        return out

    def _mask(self, noise: Dict, name: str, i: int, shape, x, generator):
        if name in noise:
            return noise[name][i]
        return torch.rand(shape, device=x.device, generator=generator) \
            < 1.0 - self.dropout_rate

    def forward(self, feats: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict] = None) -> torch.Tensor:
        """feats (B, T, F) -> (B, T', dnn_neurons), T' the pooled length.
        ``train`` applies dropout (``noise``'s masks by name, else drawn
        from ``generator``)."""
        noise = noise or {}
        drop = train and self.dropout_rate > 0
        x = feats[..., None]   # (B, T, F, 1)
        for i in range(self.cnn_blocks):
            for stage in ("a", "b"):
                x = getattr(self, f"conv{i}{stage}")(x)
                ln = getattr(self, f"ln{i}{stage}")
                x = leaky_relu(ln_fc(x, ln.gamma, ln.beta))
            f = self.freq_pooling_size
            x = max_pool(x, (1, f), (1, f))
            if drop:
                B, C = x.shape[0], x.shape[-1]
                x = dropout_channels(x, self.dropout_rate, self._mask(
                    noise, "cnn_dropout", i, (B, 1, 1, C), x, generator))
        if self.time_pooling:
            p = self.time_pooling_size
            x = max_pool(x, (p, 1), (p, 1))
        B, T, F_, C = x.shape
        x = x.reshape(B, T, F_ * C)
        x, _ = self.rnn(x, train=drop, generator=generator,
                        masks=noise.get("rnn_dropout"))
        for i in range(self.dnn_blocks):
            x = getattr(self, f"dnn{i}")(x)
            ln = getattr(self, f"dnn_ln{i}")
            x = leaky_relu(layer_norm(x, ln.gamma, ln.beta))
            if drop:
                x = dropout(x, self.dropout_rate, True, generator,
                            mask=noise["dnn_dropout"][i]
                            if "dnn_dropout" in noise else None)
        return x


class VanillaNN(nn.Module):
    """``dnn_blocks`` of Linear and leaky ReLU, from ``input_size`` or the
    last entry of ``input_shape``."""

    def __init__(self, input_shape=None, input_size: Optional[int] = None,
                 dnn_blocks: int = 2, dnn_neurons: int = 512,
                 generator: Optional[torch.Generator] = None, device=None,
                 **kwargs):
        super().__init__()
        if input_size is None:
            if input_shape is None:
                raise ValueError("need input_size or input_shape")
            input_size = int(input_shape[-1])
        self.dnn_blocks = int(dnn_blocks)
        in_size = int(input_size)
        for i in range(self.dnn_blocks):
            setattr(self, f"lin{i}", Linear(in_size, int(dnn_neurons),
                                            generator=generator,
                                            device=device))
            in_size = int(dnn_neurons)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        for i in range(self.dnn_blocks):
            x = leaky_relu(getattr(self, f"lin{i}")(x))
        return x
