"""Procedural dataset stand-ins (nothing is downloaded — see DESIGN.md §7).
A numpy-only copy of the reference's ``repro.data.synthetic``: the same
seed gives the same arrays in both packages.

* ``binary_strokes``  — MNIST surrogate: random smooth pen strokes on a
  black canvas, binarized. Controls: stroke count/length. Spatially regular,
  mostly-background — the regime where predictive sampling shines (paper
  Fig. 3: background forecast correctly, edges not).
* ``quantized_textures`` — SVHN/CIFAR surrogate: smooth random fields
  (low-res Gaussian noise, bilinear-upsampled, channel-mixed) quantized to
  ``K`` levels. Controls: category count (1-bit vs 5-bit vs 8-bit — the
  paper's main axis of difficulty) and smoothness.
* ``synthetic_tokens`` — LM surrogate: Markov text with strong local
  structure + copy motifs, so learned models have predictable continuations.

All generators are numpy-based (host-side data pipeline), deterministic in
their seed, and stream batches — mirroring a real input pipeline.
"""
from __future__ import annotations

import numpy as np


def _smooth_field(rng, n, h, w, c, low=4):
    """Low-frequency random fields in [0, 1]: (n, h, w, c)."""
    base = rng.standard_normal((n, low, low, c)).astype(np.float32)
    # bilinear upsample low -> (h, w)
    ys = np.linspace(0, low - 1, h)
    xs = np.linspace(0, low - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, low - 1)
    x1 = np.minimum(x0 + 1, low - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    f = (base[:, y0][:, :, x0] * (1 - wy) * (1 - wx)
         + base[:, y1][:, :, x0] * wy * (1 - wx)
         + base[:, y0][:, :, x1] * (1 - wy) * wx
         + base[:, y1][:, :, x1] * wy * wx)
    f = (f - f.min(axis=(1, 2, 3), keepdims=True))
    f = f / (f.max(axis=(1, 2, 3), keepdims=True) + 1e-8)
    return f


def binary_strokes(n: int, height: int = 28, width: int = 28,
                   seed: int = 0) -> np.ndarray:
    """(n, H, W, 1) int {0,1} stroke images (MNIST stand-in)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, height, width), np.int32)
    for i in range(n):
        strokes = rng.integers(1, 4)
        for _ in range(strokes):
            # random smooth quadratic stroke
            p0 = rng.uniform(0.15, 0.85, 2) * (height, width)
            p1 = rng.uniform(0.15, 0.85, 2) * (height, width)
            pc = (p0 + p1) / 2 + rng.normal(0, height / 5, 2)
            ts = np.linspace(0, 1, 64)[:, None]
            pts = ((1 - ts) ** 2 * p0 + 2 * ts * (1 - ts) * pc + ts ** 2 * p1)
            ys = np.clip(pts[:, 0].astype(int), 0, height - 1)
            xs = np.clip(pts[:, 1].astype(int), 0, width - 1)
            imgs[i, ys, xs] = 1
            # thicken
            imgs[i, np.minimum(ys + 1, height - 1), xs] = 1
            imgs[i, ys, np.minimum(xs + 1, width - 1)] = 1
    return imgs[..., None]


def quantized_textures(n: int, height: int = 32, width: int = 32,
                       channels: int = 3, categories: int = 32,
                       seed: int = 0, low: int = 4) -> np.ndarray:
    """(n, H, W, C) int in [0, K) smooth-texture images (CIFAR stand-in)."""
    rng = np.random.default_rng(seed)
    f = _smooth_field(rng, n, height, width, channels, low=low)
    # channel correlation (natural-image-like)
    mix = np.eye(channels) * 0.7 + 0.3 / channels
    f = np.clip(f @ mix, 0.0, 1.0)
    q = np.minimum((f * categories).astype(np.int32), categories - 1)
    return q


def synthetic_tokens(n: int, seq_len: int, vocab: int, seed: int = 0,
                     order: int = 2) -> np.ndarray:
    """(n, S) int Markov token streams with copy motifs (LM stand-in)."""
    rng = np.random.default_rng(seed)
    eff = min(vocab, 256)  # active sub-vocabulary
    # sparse peaked transition table over hash of last `order` tokens
    n_ctx = 997
    table = rng.dirichlet(np.full(eff, 0.05), size=n_ctx).astype(np.float32)
    out = np.zeros((n, seq_len), np.int64)
    state = rng.integers(0, eff, (n, order))
    for s in range(seq_len):
        ctx = (state * np.array([31 ** i for i in range(order)])).sum(1) % n_ctx
        u = rng.random((n, 1))
        cdf = np.cumsum(table[ctx], axis=1)
        nxt = (u > cdf).sum(axis=1)
        out[:, s] = nxt
        state = np.concatenate([state[:, 1:], nxt[:, None]], axis=1)
    return (out % vocab).astype(np.int32)


def repetitive_tokens(n: int, seq_len: int, vocab: int, seed: int = 0,
                      motif_len: int = 8, mutate: float = 0.05) -> np.ndarray:
    """(n, S) token streams of repeated motifs with rare mutations — the
    weakly-coupled regime where speculative/predictive decoding shines
    (boilerplate/code-like text). Strong-coupling Markov chains (see
    ``synthetic_tokens``) are the paper's 'cascading errors' worst case."""
    rng = np.random.default_rng(seed)
    eff = min(vocab, 64)
    out = np.zeros((n, seq_len), np.int64)
    for i in range(n):
        motif = rng.integers(0, eff, motif_len)
        reps = -(-seq_len // motif_len)
        stream = np.tile(motif, reps)[:seq_len]
        flips = rng.random(seq_len) < mutate
        stream[flips] = rng.integers(0, eff, flips.sum())
        out[i] = stream
    return (out % vocab).astype(np.int32)


def image_batches(generator, n_total: int, batch: int, seed: int = 0, **kw):
    """Infinite batch stream over a fixed generated dataset (epoch shuffled)."""
    data = generator(n_total, seed=seed, **kw)
    rng = np.random.default_rng(seed + 1)
    while True:
        idx = rng.permutation(n_total)
        for s in range(0, n_total - batch + 1, batch):
            yield data[idx[s:s + batch]]


def token_batches(n_total: int, batch: int, seq_len: int, vocab: int,
                  seed: int = 0):
    data = synthetic_tokens(n_total, seq_len, vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        idx = rng.permutation(n_total)
        for s in range(0, n_total - batch + 1, batch):
            yield data[idx[s:s + batch]]
