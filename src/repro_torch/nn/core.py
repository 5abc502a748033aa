"""Core layers: Dense, Embedding, RMSNorm, LayerNorm, and the
convolutions of the paper's image models: Conv2D (strided and
transposed), the PixelCNN MaskedConv2D with its raster-scan masks, and
concat_elu.

As in the reference, layers are namespaces of static functions over plain
dict parameters, so call sites read ``Dense.init`` / ``Dense.apply`` and a
parameter tree converts to and from the JAX one leaf for leaf. Weights
keep JAX's layouts: ``Dense.apply`` is ``x @ w`` over ``(in, out)``, and a
convolution's kernel is ``HWIO`` over activations that are ``NHWC`` at the
layer's boundary (``F.conv2d`` reads them as a channels-last view, so no
copy is made). A masked convolution keeps its mask as the ``_mask`` leaf,
which ``optim.zero_frozen`` freezes, and runs as one matmul over the
input's windows (see ``MaskedConv2D.apply``).

Initializers draw from an explicit ``torch.Generator``; they follow the
reference's scales, not its random numbers (tests that compare the two
frameworks load JAX's weights through ``checkpoint.io.params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _normal(gen: torch.Generator, shape, dtype, device, std: float):
    # drawn in float32 and then rounded, so every dtype sees one stream
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def variance_scaling(gen, shape, fan_in=None, scale=1.0,
                     dtype=torch.float32, device=None):
    """LeCun-style variance scaling (plain normal, std sqrt(scale/fan_in))."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 1 else 1
    return _normal(gen, shape, dtype, device,
                   math.sqrt(scale / max(1, fan_in)))


class Dense:
    @staticmethod
    def init(gen, in_dim: int, out_dim: int, use_bias: bool = True,
             dtype=torch.float32, device=None, scale: float = 1.0):
        params = {"w": variance_scaling(gen, (in_dim, out_dim), fan_in=in_dim,
                                        scale=scale, dtype=dtype,
                                        device=device)}
        if use_bias:
            params["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
        return params

    @staticmethod
    def apply(params, x):
        y = x @ params["w"]
        if "b" in params:
            y = y + params["b"]
        return y


class Embedding:
    @staticmethod
    def init(gen, vocab: int, dim: int, dtype=torch.float32, device=None,
             std: float = 0.02):
        return {"table": _normal(gen, (vocab, dim), dtype, device, std)}

    @staticmethod
    def apply(params, ids):
        return params["table"][ids]

    @staticmethod
    def attend(params, x):
        """Tied-readout logits: x @ table.T"""
        return x @ params["table"].T


class RMSNorm:
    @staticmethod
    def init(dim: int, dtype=torch.float32, device=None):
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}

    @staticmethod
    def apply(params, x, eps: float = 1e-6):
        dtype = x.dtype
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(dtype)


class LayerNorm:
    @staticmethod
    def init(dim: int, dtype=torch.float32, device=None):
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}

    @staticmethod
    def apply(params, x, eps: float = 1e-5):
        """Mean and variance in float32, the result cast back to x's
        dtype (the reference's order of operations)."""
        dtype = x.dtype
        x32 = x.float()
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * params["scale"].float() + params["bias"].float()).to(
            dtype)


# ---------------------------------------------------------------------------
# Convolutions (NHWC activations, HWIO kernels)
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int):
    """XLA's "SAME" padding (before, after) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int):
    """``jax.lax.conv_transpose``'s "SAME" padding (before, after) of the
    stride-dilated input."""
    before = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    return before, k + s - 2 - before


def _conv(x, w, stride):
    """NHWC ``x`` correlated with the HWIO kernel ``w`` (no flip), XLA's
    "SAME" padding where it pads both sides alike (every shape of the
    paper's models)."""
    pads = [_same_pads(x.shape[1 + a], w.shape[a], stride[a])
            for a in (0, 1)]
    if any(a != b for a, b in pads):
        raise NotImplementedError(f"uneven 'SAME' padding {pads}")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=tuple(stride), padding=(pads[0][0], pads[1][0]))
    return y.permute(0, 2, 3, 1)


def _conv_transpose(x, w, stride):
    """``jax.lax.conv_transpose(x, w, stride, "SAME")`` (NHWC, HWIO, the
    default ``transpose_kernel=False``): the stride-dilated input, padded,
    correlated with ``w`` unflipped. ``F.conv_transpose2d`` is conv2d's
    input gradient, which flips its kernel and pads the dilated input by
    ``k - 1 - padding``: so it gets ``w`` flipped and as ``(in, out, kh,
    kw)``, and the difference of the two pads as ``output_padding``."""
    pads = [_transpose_pads(w.shape[a], stride[a]) for a in (0, 1)]
    padding = tuple(w.shape[a] - 1 - pads[a][0] for a in (0, 1))
    extra = tuple(pads[a][1] - pads[a][0] for a in (0, 1))
    if min(padding) < 0 or not all(0 <= e < s for e, s in zip(extra,
                                                             stride)):
        raise NotImplementedError(
            f"kernel {tuple(w.shape[:2])} at stride {tuple(stride)}")
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           w.permute(2, 3, 0, 1).flip(2, 3),
                           stride=tuple(stride), padding=padding,
                           output_padding=extra)
    return y.permute(0, 2, 3, 1)


class Conv2D:
    """Convolution with XLA's "SAME" padding, the only padding the
    paper's models use."""

    @staticmethod
    def init(gen, in_ch: int, out_ch: int, kernel: Sequence[int] = (3, 3),
             use_bias: bool = True, dtype=torch.float32, device=None):
        kh, kw = kernel
        params = {"w": variance_scaling(gen, (kh, kw, in_ch, out_ch),
                                        fan_in=in_ch * kh * kw, dtype=dtype,
                                        device=device)}
        if use_bias:
            params["b"] = torch.zeros((out_ch,), dtype=dtype, device=device)
        return params

    @staticmethod
    def apply(params, x, stride: Sequence[int] = (1, 1),
              transpose: bool = False):
        """x: (B, H, W, C_in) -> (B, H', W', C_out). ``transpose`` is
        ``jax.lax.conv_transpose``: H' = H * stride."""
        if transpose:
            y = _conv_transpose(x, params["w"], stride)
        else:
            y = _conv(x, params["w"], stride)
        if "b" in params:
            y = y + params["b"]
        return y


def group_ids(n_ch: int, n_groups: int) -> np.ndarray:
    """Contiguous-block channel->group assignment (n_ch divisible preferred)."""
    return np.arange(n_ch) * n_groups // max(n_ch, 1)


def _pixelcnn_mask(kh: int, kw: int, gi: np.ndarray, go: np.ndarray,
                   mask_type: str) -> np.ndarray:
    """Raster-scan causal mask (kh, kw, in, out) for PixelCNN convolutions.

    Channels carry group ids ``gi``/``go`` (e.g. the R, G, B sub-channel
    groups; concat_elu duplicates the id vector): at the centre pixel,
    output group ``go`` sees input group ``g`` iff ``g < go`` (mask 'A',
    strict) or ``g <= go`` (mask 'B'). ``mask_type='T'`` is the strictly
    triangular spatial mask of the forecasting module: the centre pixel is
    blocked entirely.
    """
    in_ch, out_ch = len(gi), len(go)
    mask = np.ones((kh, kw, in_ch, out_ch), dtype=np.float32)
    ch, cw = kh // 2, kw // 2
    mask[ch + 1:, :, :, :] = 0.0          # rows below the centre
    mask[ch, cw + 1:, :, :] = 0.0         # the centre row, right of centre
    if mask_type == "T":
        mask[ch, cw, :, :] = 0.0
        return mask
    if mask_type == "A":
        centre = (gi[:, None] < go[None, :]).astype(np.float32)
    elif mask_type == "B":
        centre = (gi[:, None] <= go[None, :]).astype(np.float32)
    else:
        raise ValueError(f"unknown mask type {mask_type!r}")
    mask[ch, cw, :, :] = centre
    return mask


class MaskedConv2D:
    """PixelCNN masked convolution with channel-autoregressive centre
    masks (stride 1, "SAME")."""

    @staticmethod
    def init(gen, in_ch: int, out_ch: int, kernel=(3, 3), mask_type="B",
             groups_in=1, groups_out=1, use_bias: bool = True,
             dtype=torch.float32, device=None):
        """``groups_in``/``groups_out`` are ints (contiguous blocks) or
        per-channel group-id vectors."""
        params = Conv2D.init(gen, in_ch, out_ch, kernel, use_bias, dtype,
                             device)
        gi = (group_ids(in_ch, groups_in) if np.isscalar(groups_in)
              else np.asarray(groups_in))
        go = (group_ids(out_ch, groups_out) if np.isscalar(groups_out)
              else np.asarray(groups_out))
        mask = _pixelcnn_mask(kernel[0], kernel[1], gi, go, mask_type)
        params["_mask"] = torch.from_numpy(mask).to(dtype=dtype,
                                                    device=device)
        return params

    @staticmethod
    def apply(params, x):
        """x: (B, H, W, C_in) -> (B, H, W, C_out), stride 1, "SAME".

        Computed as one matmul over the input's windows, not through
        cuDNN: a masked weight is an exact zero, so in a plain product it
        adds an exact zero and the outputs at a pixel do not change, to
        the bit, with the inputs after it. The FFT and Winograd algorithms
        that cuDNN picks for some of the paper's shapes transform the
        input first and so leak later pixels into earlier outputs at the
        rounding level, which breaks predictive sampling's bitwise
        equality with ancestral sampling on the card. The windows are
        gathered in one copy whatever the batch (``F.unfold`` launches one
        im2col kernel per image), in the (i, j, c) order of the ``HWIO``
        kernel's rows."""
        w = params["w"] * params["_mask"]
        kh, kw, C, O = w.shape
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError("masked kernels have odd sizes")
        B, H, W, _ = x.shape
        xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        win = xp.unfold(1, kh, 1).unfold(2, kw, 1)     # (B, H, W, C, kh, kw)
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(B * H * W, -1)
        y = (cols @ w.reshape(-1, O)).reshape(B, H, W, O)
        if "b" in params:
            y = y + params["b"]
        return y


def concat_elu(x):
    """The concat_elu nonlinearity of PixelCNN++: elu([x, -x])."""
    return F.elu(torch.cat([x, -x], dim=-1))
