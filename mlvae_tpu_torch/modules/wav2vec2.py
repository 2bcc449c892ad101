"""wav2vec2 waveform encoder (counterpart of
``mlvae_tpu/modules/wav2vec2.py``; the YAML alias of SpeechBrain's
``HuggingFaceWav2Vec2`` as the w2v recipes use it, e.g.
``models/w2v_MD_VAE/model.yaml:11-17``).

The wav2vec2 topology in torch ops: the conv feature extractor (seven
convs of kernels (10, 3, 3, 3, 3, 2, 2) and strides (5, 2, 2, 2, 2, 2, 2),
one frame per 320 samples), the feature projection, the grouped
positional conv, L transformer layers and their dropout sites. Both HF
config families:

* ``feat_extract_norm="group"``, post-LN encoder (wav2vec2-base,
  ``_BASE_ARCH``);
* ``feat_extract_norm="layer"``, conv biases, pre-LN ("stable layer
  norm") encoder (wav2vec2-large-lv60, ``_LARGE_ARCH``, the recipes'
  source).

``normalize_wav`` and ``output_norm`` are the SpeechBrain wrapper's
``F.layer_norm(x, x.shape)``: one mean and variance over the whole padded
batch tensor (``whole_tensor_norm``). ``freeze`` stops gradients and
dropout (the forward runs under ``no_grad`` and in eval mode).

Numerics are the JAX module's: layer norms with f32 statistics returning
the stream dtype; the attention's scores and softmax in f32 and its value
product in the stream dtype, as matmuls and a softmax (the JAX module has
no kernel here, and ``scaled_dot_product_attention``'s numerics and
dispatch are not the JAX module's); the exact GELU as ``jax.nn.gelu``
writes it (``0.5 x erfc(-x sqrt(1/2))``, its constant in the stream
dtype); constants multiplied in the stream dtype.

Parameters keep the JAX module's names and layouts (linear weights (in,
out), conv kernels (K, in, out)), one module a transformer layer
(``layers.<i>.q_w`` ...); ``convert.from_jax`` / ``to_jax`` unstack and
stack the JAX module's leading layer axis, so checkpoints keep its layout.

Dropout: the three sites the JAX module draws from its stream, in its
order: the feature projection's (``w2v_feat_proj_dropout``), the
encoder input's (``w2v_hidden_dropout``), and one key split into four a
layer (``w2v_layer_dropout``: the attention probabilities, the attention
output, the FFN activation, the FFN output). ``draws`` lists them and
``forward(noise=...)`` replays them; without noise they are drawn from
``generator``.

Per-layer recompute: a training forward wraps each layer in
``torch.utils.checkpoint`` (on by default, off with
``MLVAE_W2V_REMAT=0``, the JAX trunk's ``jax.checkpoint`` switch), so the
backward keeps each layer's input only and recomputes the rest. A layer's
masks are drawn before the checkpointed call (``_layer_masks``, in the
order the layer draws them) and its parameters are bound at the call (the
AMP step's bf16 copies), so the recompute uses the forward's masks and
weights.

Weights: random, of the same topology, unless ``source`` or else
``save_path`` names a local HF snapshot directory (its ``config.json``
and ``pytorch_model.bin`` or ``model.safetensors``, read with ``torch``
and ``json`` only; ``convert.hf_state_dict_to_port`` maps HF's names).
Nothing is fetched, and ``transformers`` is never imported.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mlvae_tpu_torch.convert import hf_state_dict_to_port
from mlvae_tpu_torch.nn.layers import dropout, uniform_
from mlvae_tpu_torch.parallel import mesh
from mlvae_tpu_torch.parallel import tp as tp_ops

logger = logging.getLogger(__name__)

_CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
_CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)

# HF config families (transformers Wav2Vec2Config defaults)
_BASE_ARCH = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, feat_extract_norm="group", conv_bias=False,
    do_stable_layer_norm=False,
)
_LARGE_ARCH = dict(
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
    intermediate_size=4096, feat_extract_norm="layer", conv_bias=True,
    do_stable_layer_norm=True,
)



def remat_enabled() -> bool:
    """Whether a training forward recomputes each layer in the backward
    (``torch.utils.checkpoint``; on unless ``MLVAE_W2V_REMAT`` is 0 or
    false), keeping only each layer's (B, T, D) input, as the JAX trunk's
    ``jax.checkpoint`` does."""
    return os.environ.get("MLVAE_W2V_REMAT", "1").lower() not in (
        "0", "false")


def _scalar(value: float, x: torch.Tensor) -> float:
    """``value`` rounded to x's dtype, as JAX takes a Python scalar."""
    return float(torch.tensor(value, dtype=x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: ``0.5 x erfc(-x sqrt(1/2))``,
    each op in x's dtype."""
    return 0.5 * x * torch.erfc(-x * _scalar(math.sqrt(0.5), x))


def whole_tensor_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``F.layer_norm(x, x.shape)``: one mean and variance over every
    element, batch and padding included; f32 statistics. Under data
    parallelism the batch is the global one: the sums go over the data
    group (``mesh.data_all_reduce``), as the JAX step's over its mesh."""
    xf = x.float()
    n = xf.numel() * mesh.data_size()
    m = mesh.data_all_reduce(xf.sum()) / n
    v = mesh.data_all_reduce(((xf - m) ** 2).sum()) / n
    return ((xf - m) * torch.rsqrt(v + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Over the last axis, f32 statistics, back in x's dtype."""
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = ((xf - m) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - m) * torch.rsqrt(v + eps) * scale.float()
            + bias.float()).to(x.dtype)


def _holder(**tensors) -> nn.Module:
    """A module holding ``tensors`` as parameters under their names."""
    m = nn.Module()
    for name, t in tensors.items():
        m.register_parameter(name, nn.Parameter(t))
    return m


def conv_output_length(n: int, kernels: Sequence[int] = _CONV_KERNELS,
                       strides: Sequence[int] = _CONV_STRIDES) -> int:
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
    return n


def find_snapshot(candidates: Sequence[str]) -> Optional[Path]:
    """The first of ``candidates`` that is a local HF snapshot directory
    (a ``config.json`` beside ``pytorch_model.bin`` or
    ``model.safetensors``); None otherwise. No network, no HF cache."""
    for src in candidates:
        if not src:
            continue
        path = Path(src)
        if (path / "config.json").is_file() and any(
                (path / n).is_file()
                for n in ("model.safetensors", "pytorch_model.bin")):
            return path
    return None


_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "F64": torch.float64,
                       "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file parsed by hand: an 8-byte little-endian
    header length, a JSON header of (dtype, shape, data offsets), the raw
    little-endian data."""
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        buf = bytearray(data[start:end])
        t = torch.frombuffer(buf, dtype=dtype) if buf else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def read_snapshot_weights(path: Path) -> Dict[str, torch.Tensor]:
    """An HF snapshot's state dict (``model.safetensors`` first)."""
    if (path / "model.safetensors").is_file():
        return read_safetensors(path / "model.safetensors")
    return torch.load(path / "pytorch_model.bin", map_location="cpu",
                      weights_only=True)


class Wav2Vec2Encoder(nn.Module):
    """``forward(wavs (B, L)) -> (B, conv_output_length(L), hidden)``."""

    def __init__(self, source: str = "", output_norm: bool = True,
                 freeze: bool = True, save_path: Optional[str] = None,
                 output_size: int = 1024, normalize_wav: bool = True,
                 hidden_size: Optional[int] = None,
                 num_hidden_layers: Optional[int] = None,
                 num_attention_heads: Optional[int] = None,
                 intermediate_size: Optional[int] = None,
                 conv_dim: Optional[Sequence[int]] = None,
                 conv_kernel: Sequence[int] = _CONV_KERNELS,
                 conv_stride: Sequence[int] = _CONV_STRIDES,
                 conv_bias: Optional[bool] = None,
                 feat_extract_norm: Optional[str] = None,
                 do_stable_layer_norm: Optional[bool] = None,
                 num_conv_pos_embeddings: int = 128,
                 num_conv_pos_embedding_groups: int = 16,
                 layer_norm_eps: float = 1e-5,
                 hidden_dropout: float = 0.1, feat_proj_dropout: float = 0.1,
                 attention_dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None, device=None,
                 **kwargs):
        super().__init__()
        self.source = source
        self.output_norm = bool(output_norm)
        self.freeze = bool(freeze)
        self.normalize_wav = bool(normalize_wav)
        self.save_path = save_path

        # architecture: local snapshot config > kwargs > family
        snapshot = find_snapshot([source, save_path or ""])
        if snapshot is not None:
            cfg = json.loads((snapshot / "config.json").read_text())
            arch = {k: cfg[k] for k in _LARGE_ARCH}
            conv_dim = tuple(cfg["conv_dim"])
            conv_kernel = tuple(cfg["conv_kernel"])
            conv_stride = tuple(cfg["conv_stride"])
            num_conv_pos_embeddings = cfg["num_conv_pos_embeddings"]
            num_conv_pos_embedding_groups = \
                cfg["num_conv_pos_embedding_groups"]
            layer_norm_eps = cfg["layer_norm_eps"]
            hidden_dropout = cfg.get("hidden_dropout", hidden_dropout)
            feat_proj_dropout = cfg.get("feat_proj_dropout",
                                        feat_proj_dropout)
            attention_dropout = cfg.get("attention_dropout",
                                        attention_dropout)
            if cfg["hidden_size"] != output_size:
                logger.warning("wav2vec2 snapshot hidden_size=%d overrides "
                               "output_size=%d", cfg["hidden_size"],
                               output_size)
        else:
            if source:
                logger.info("no local snapshot for %s; the encoder keeps "
                            "its random initialization of the same "
                            "topology", source)
            # family defaults by declared size; tiny sizes (tests) shrink
            # depth and width and keep the topology
            fam = _BASE_ARCH if output_size == 768 else _LARGE_ARCH
            if output_size >= 768:
                arch = dict(fam)
            else:
                arch = dict(fam, hidden_size=output_size,
                            num_hidden_layers=2,
                            num_attention_heads=max(1, output_size // 32),
                            intermediate_size=4 * output_size)
        for k, v in [("hidden_size", hidden_size),
                     ("num_hidden_layers", num_hidden_layers),
                     ("num_attention_heads", num_attention_heads),
                     ("intermediate_size", intermediate_size),
                     ("conv_bias", conv_bias),
                     ("feat_extract_norm", feat_extract_norm),
                     ("do_stable_layer_norm", do_stable_layer_norm)]:
            if v is not None:
                arch[k] = v

        self.hidden_size = H = int(arch["hidden_size"])
        self.output_size = H
        self.num_hidden_layers = L = int(arch["num_hidden_layers"])
        self.num_attention_heads = int(arch["num_attention_heads"])
        self.intermediate_size = I = int(arch["intermediate_size"])
        self.feat_extract_norm = str(arch["feat_extract_norm"])
        self.conv_bias = bool(arch["conv_bias"])
        self.do_stable_layer_norm = bool(arch["do_stable_layer_norm"])
        self.conv_kernel = tuple(int(k) for k in conv_kernel)
        self.conv_stride = tuple(int(s) for s in conv_stride)
        self.conv_dim = tuple(int(c) for c in conv_dim) \
            if conv_dim is not None else (512,) * len(self.conv_kernel)
        self.num_conv_pos_embeddings = int(num_conv_pos_embeddings)
        self.num_conv_pos_embedding_groups = \
            int(num_conv_pos_embedding_groups)
        self.layer_norm_eps = float(layer_norm_eps)
        self.hidden_dropout = float(hidden_dropout)
        self.feat_proj_dropout = float(feat_proj_dropout)
        self.attention_dropout = float(attention_dropout)
        if H % self.num_attention_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must "
                f"divide hidden_size ({H})")

        kw = dict(device=device)

        def uni(shape, bound):
            return uniform_(torch.empty(shape, **kw), bound, generator)

        def ones(n):
            return torch.ones(n, **kw)

        def zeros(n):
            return torch.zeros(n, **kw)

        self.extractor = nn.Module()
        in_ch = 1
        for i, (k, out_ch) in enumerate(zip(self.conv_kernel,
                                            self.conv_dim)):
            t = {"weight": uni((k, in_ch, out_ch), 1.0 / math.sqrt(in_ch * k))}
            if self.conv_bias:
                t["bias"] = zeros(out_ch)
            if self.feat_extract_norm == "layer" or (
                    self.feat_extract_norm == "group" and i == 0):
                t["norm_scale"] = ones(out_ch)
                t["norm_bias"] = zeros(out_ch)
            self.extractor.add_module(f"conv{i}", _holder(**t))
            in_ch = out_ch
        C = self.conv_dim[-1]
        b = 1.0 / math.sqrt(C)
        self.proj = _holder(norm_scale=ones(C), norm_bias=zeros(C),
                            w=uni((C, H), b), b=uni((H,), b))
        kpc, g = self.num_conv_pos_embeddings, \
            self.num_conv_pos_embedding_groups
        std = math.sqrt(4.0 / (kpc * H))
        self.pos_conv = _holder(
            weight=std * torch.randn((kpc, H // g, H), generator=generator,
                                     **kw),
            bias=zeros(H))
        self.enc_norm = _holder(scale=ones(H), bias=zeros(H))
        bh, bi = 1.0 / math.sqrt(H), 1.0 / math.sqrt(I)
        self.layers = nn.ModuleList()
        for _ in range(L):
            t = {}
            for name in ("q", "k", "v", "o"):
                t[f"{name}_w"], t[f"{name}_b"] = uni((H, H), bh), uni((H,), bh)
            t["ff_in_w"], t["ff_in_b"] = uni((H, I), bh), uni((I,), bh)
            t["ff_out_w"], t["ff_out_b"] = uni((I, H), bi), uni((H,), bi)
            for name in ("ln1", "ln2"):
                t[f"{name}_s"], t[f"{name}_b"] = ones(H), zeros(H)
            self.layers.append(_holder(**t))

        # the model group this trunk is split over (``split_for_tp``)
        self.tp_mesh = None
        self.pretrained_loaded = False
        if snapshot is not None:
            state = hf_state_dict_to_port(read_snapshot_weights(snapshot))
            self.load_state_dict(state, strict=True)
            self.pretrained_loaded = True
            logger.info("loaded wav2vec2 weights from %s", snapshot)

    # -- tensor parallelism ------------------------------------------------------
    def tensor_parallel_splits(self) -> Dict[str, int]:
        """The placement hook (the JAX module's ``partition_specs``):
        parameter name -> the dim it is split along over the model axis."""
        return tp_ops.wav2vec2_split_dims(self)

    def split_for_tp(self, tp_mesh) -> None:
        """Keep this model rank's shard of every split parameter (the full
        ones must be equal on every rank: same seed or restored)."""
        err = tp_ops.validate_tp(self, tp_mesh.n_model)
        if err:
            raise ValueError(f"cannot tensor-split the wav2vec2 trunk: {err}")
        params = dict(self.named_parameters())
        with torch.no_grad():
            for name, dim in self.tensor_parallel_splits().items():
                p = params[name]
                p.data = tp_ops.shard(p.data, dim, tp_mesh.n_model,
                                      tp_mesh.model_rank)
        self.tp_mesh = tp_mesh

    def _tp_slice(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's slice of a mask drawn for the whole trunk."""
        t = self.tp_mesh
        return tp_ops.shard(full, dim, t.n_model, t.model_rank)

    def _site_mask(self, mask, shape, dim, rate, train, generator):
        """A split site's keep-mask: the full draw's slice (drawn here from
        ``generator`` where none is given, the same on every model rank)."""
        if not train or rate <= 0.0:
            return None
        if mask is None:
            mask = torch.rand(shape, generator=generator,
                              device=self.layers[0].q_w.device) < 1.0 - rate
        return self._tp_slice(mask, dim)

    # -- draws -----------------------------------------------------------------
    def layer_dropout_sites(self, B: int, T: int):
        """A layer's four dropout sites, in the JAX module's key order:
        (shape, rate) of the attention probabilities, the attention output,
        the FFN activation and the FFN output."""
        H, nh, I = self.hidden_size, self.num_attention_heads, \
            self.intermediate_size
        hd = self.hidden_dropout
        return [((B, nh, T, T), self.attention_dropout), ((B, T, H), hd),
                ((B, T, I), hd), ((B, T, H), hd)]

    def draws(self, B: int, T: int, train: bool = False) -> List:
        """The draws of one forward over T frames, in the JAX module's
        RngStream order (see the module docstring); none when frozen or not
        training. ``w2v_layer_dropout`` is one stream key split into L * 4
        (kind ``bernoulli_split``, with the sites' shapes and keep
        probabilities; a site of rate 0 ignores its mask)."""
        if not train or self.freeze:
            return []
        f32, H = torch.float32, self.hidden_size
        out = []
        if self.feat_proj_dropout > 0:
            out.append(("w2v_feat_proj_dropout", "bernoulli", (B, T, H),
                        1.0 - self.feat_proj_dropout, f32))
        if self.hidden_dropout > 0:
            out.append(("w2v_hidden_dropout", "bernoulli", (B, T, H),
                        1.0 - self.hidden_dropout, f32))
        sites = self.layer_dropout_sites(B, T)
        out.append(("w2v_layer_dropout", "bernoulli_split",
                    [s for s, _ in sites] * self.num_hidden_layers,
                    [1.0 - r for _, r in sites] * self.num_hidden_layers,
                    f32))
        return out

    def _layer_masks(self, masks, h: torch.Tensor, train: bool,
                     generator) -> List:
        """A layer's four keep-masks, each missing one of a site that drops
        drawn from ``generator`` as the layer would draw it."""
        if not train:
            return list(masks)
        B, T = h.shape[:2]
        out = []
        for mask, (shape, rate) in zip(masks,
                                       self.layer_dropout_sites(B, T)):
            if mask is None and rate > 0.0:
                mask = torch.rand(shape, device=h.device,
                                  generator=generator) < 1.0 - rate
            out.append(mask)
        return out

    def conv_output_length(self, n: int) -> int:
        return conv_output_length(n, self.conv_kernel, self.conv_stride)

    # -- the forward ------------------------------------------------------------
    def _feature_extractor(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L) -> (B, T, C)."""
        eps = self.layer_norm_eps
        x = x.unsqueeze(1)                              # (B, 1, L)
        for i, s in enumerate(self.conv_stride):
            p = getattr(self.extractor, f"conv{i}")
            x = F.conv1d(x, p.weight.permute(2, 1, 0), stride=s)
            if self.conv_bias:
                x = x + p.bias[:, None]
            if self.feat_extract_norm == "layer":
                x = layer_norm(x.transpose(1, 2), p.norm_scale, p.norm_bias,
                               eps).transpose(1, 2)
            elif self.feat_extract_norm == "group" and i == 0:
                # HF GroupNorm(C, C): each channel over time, f32 stats
                xf = x.float()
                m = xf.mean(dim=2, keepdim=True)
                v = ((xf - m) ** 2).mean(dim=2, keepdim=True)
                xf = (xf - m) * torch.rsqrt(v + eps)
                x = (xf * p.norm_scale[:, None].float()
                     + p.norm_bias[:, None].float()).to(x.dtype)
            x = gelu(x)
        return x.transpose(1, 2)

    def _pos_conv(self, h: torch.Tensor) -> torch.Tensor:
        k = self.num_conv_pos_embeddings
        y = F.conv1d(h.transpose(1, 2), self.pos_conv.weight.permute(2, 1, 0),
                     padding=k // 2,
                     groups=self.num_conv_pos_embedding_groups)
        y = y.transpose(1, 2) + self.pos_conv.bias
        if k % 2 == 0:      # HF SamePadLayer
            y = y[:, :-1]
        return gelu(y)

    def _attention(self, lp, h, mask, train, generator):
        B, T, H = h.shape
        nh = self.num_attention_heads
        hd = H // nh
        if self.tp_mesh is not None:
            # this rank's heads: q/k/v column-split, o row-split
            mask = self._site_mask(mask, (B, nh, T, T), 1,
                                   self.attention_dropout, train, generator)
            nh //= self.tp_mesh.n_model
            h = tp_ops.copy_to_model(h, self.tp_mesh)

        def heads(x):
            return x.reshape(B, T, nh, hd)

        q = heads(h @ lp.q_w + lp.q_b) * _scalar(hd ** -0.5, h)
        k = heads(h @ lp.k_w + lp.k_b)
        v = heads(h @ lp.v_w + lp.v_b)
        # scores and softmax in f32; the value product in the stream dtype
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        attn = torch.softmax(scores, dim=-1)
        attn = dropout(attn, self.attention_dropout, train, generator,
                       mask=mask).to(h.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(B, T,
                                                               nh * hd)
        if self.tp_mesh is not None:
            return tp_ops.reduce_from_model(out @ lp.o_w,
                                            self.tp_mesh) + lp.o_b
        return out @ lp.o_w + lp.o_b

    def _layer(self, lp, h, masks, train, generator):
        eps, hd = self.layer_norm_eps, self.hidden_dropout

        def drop(x, i):
            return dropout(x, hd, train, generator, mask=masks[i])

        def ffn(x):
            if self.tp_mesh is None:
                f = drop(gelu(x @ lp.ff_in_w + lp.ff_in_b), 2)
                return drop(f @ lp.ff_out_w + lp.ff_out_b, 3)
            # ff_in column-split (the activation's dropout mask sliced
            # alike), ff_out row-split
            x = tp_ops.copy_to_model(x, self.tp_mesh)
            m2 = self._site_mask(masks[2], (*x.shape[:-1],
                                            self.intermediate_size), -1,
                                 hd, train, generator)
            f = dropout(gelu(x @ lp.ff_in_w + lp.ff_in_b), hd, train,
                        generator, mask=m2)
            y = tp_ops.reduce_from_model(f @ lp.ff_out_w, self.tp_mesh)
            return drop(y + lp.ff_out_b, 3)

        if self.do_stable_layer_norm:   # pre-LN (large-lv60)
            a = self._attention(lp, layer_norm(h, lp.ln1_s, lp.ln1_b, eps),
                                masks[0], train, generator)
            h = h + drop(a, 1)
            return h + ffn(layer_norm(h, lp.ln2_s, lp.ln2_b, eps))
        a = self._attention(lp, h, masks[0], train, generator)  # post-LN
        h = layer_norm(h + drop(a, 1), lp.ln1_s, lp.ln1_b, eps)
        return layer_norm(h + ffn(h), lp.ln2_s, lp.ln2_b, eps)

    def forward(self, wavs: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict] = None) -> torch.Tensor:
        """``noise`` replays ``draws`` (each site's masks in a list, as
        dropout masks replay); without it a training forward draws its
        masks from ``generator``."""
        train = train and not self.freeze
        ctx = torch.no_grad() if self.freeze else contextlib.nullcontext()
        noise = noise or {}
        with ctx:
            x = wavs
            if self.normalize_wav:
                x = whole_tensor_norm(x, 1e-5)
            x = self._feature_extractor(x)
            h = layer_norm(x, self.proj.norm_scale, self.proj.norm_bias,
                           self.layer_norm_eps)
            h = h @ self.proj.w + self.proj.b
            h = dropout(h, self.feat_proj_dropout, train, generator,
                        mask=noise.get("w2v_feat_proj_dropout", [None])[0])
            h = h + self._pos_conv(h)
            if not self.do_stable_layer_norm:
                h = layer_norm(h, self.enc_norm.scale, self.enc_norm.bias,
                               self.layer_norm_eps)
            h = dropout(h, self.hidden_dropout, train, generator,
                        mask=noise.get("w2v_hidden_dropout", [None])[0])
            layer_masks = noise.get("w2v_layer_dropout")
            remat = torch.is_grad_enabled() and remat_enabled()
            for i, lp in enumerate(self.layers):
                masks = layer_masks[4 * i:4 * i + 4] if layer_masks \
                    else [None] * 4
                if not remat:
                    h = self._layer(lp, h, masks, train, generator)
                    continue
                # the recompute must see the forward's masks (drawn here,
                # in the order the layer draws them) and its parameters
                # (under the AMP step's functional_call, the bf16 copies)
                masks = self._layer_masks(masks, h, train, generator)
                view = SimpleNamespace(**{n: getattr(lp, n) for n, _ in
                                          lp.named_parameters()})
                h = checkpoint(self._layer, view, h, masks, train, None,
                               use_reentrant=False,
                               preserve_rng_state=False)
            if self.do_stable_layer_norm:
                h = layer_norm(h, self.enc_norm.scale, self.enc_norm.bias,
                               self.layer_norm_eps)
            if self.output_norm:
                h = whole_tensor_norm(h, 1e-5)
        return h
