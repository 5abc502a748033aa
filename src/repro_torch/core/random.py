"""JAX-compatible counter-based noise: threefry2x32, ``fold_in``, ``uniform``
and ``gumbel``, as torch ops on int64 tensors holding uint32 values.

The reference derives every verify round's Gumbel noise from
``jax.random`` keys (``engine/spec_decode.py:make_eps_fn``). To give the
same noise, this module reproduces JAX's bit path with
``jax_threefry_partitionable`` on (the JAX 0.9 default):

* a key is a pair of uint32 words; ``PRNGKey(seed)`` is ``(0, seed)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* ``split(key, n)`` gives the keys ``fold_in(key, i)`` for ``i < n``: with
  partitionable threefry, JAX's split hashes the flat index ``i`` as the
  counter pair ``(0, i)``, as ``fold_in`` hashes its data;
* ``random_bits(key, (V,))`` hashes the counters ``(0, i)`` for
  ``i < V`` and XORs the two output words; a shaped draw such as
  ``(B, d, K)`` counts the flat index, so the flat draw of ``B * d * K``
  values reshaped is JAX's shaped one;
* ``uniform`` keeps the top 23 bits as a mantissa in ``[1, 2)``, subtracts
  one, scales and clamps to ``minval``;
* ``gumbel`` is ``-log(-log(uniform(minval=tiny, maxval=1)))``.

The bits and the uniforms equal JAX's bitwise. Each of the two ``log``
steps of ``gumbel`` agrees with XLA's within one float32 ulp on the same
input: torch's ``log`` need not round as XLA's does. Composed, the inner
step's ulp is scaled by ``1 / -log(u)``, which is large for ``u`` near 1,
so a test that needs equal noise feeds one side's eps to the other.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    whose values are uint32 words. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` as JAX builds it with 64-bit mode off
    (its default): the seed is cut to its low 32 bits, so the key is the
    pair (0, seed mod 2**32)."""
    return (torch.tensor(0, dtype=torch.int64, device=device),
            torch.tensor(int(seed) & M32, dtype=torch.int64, device=device))


def fold_in(key, data):
    """``jax.random.fold_in`` over a tensor of non-negative int ``data``;
    the key words broadcast against it."""
    data = torch.as_tensor(data).to(torch.int64) & M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of ``num`` keys."""
    k1, k2 = fold_in(key, torch.arange(num, device=key[0].device))
    return [(k1[i], k2[i]) for i in range(num)]


def random_bits(key, n: int):
    """32-bit ``jax.random.bits(key, (n,))`` for each key in a batch of
    keys of shape ``S``: returns ``S + (n,)`` int64 values."""
    k1, k2 = key
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """float32 ``jax.random.uniform(key, (n,), minval=, maxval=)``."""
    bits = random_bits(key, n)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars, as JAX converts them; no host-to-device copy, so the
    # noise can be captured in a CUDA graph
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32)
                 - torch.tensor(minval, dtype=torch.float32))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(key, n: int):
    """float32 ``jax.random.gumbel(key, (n,))`` (the default mode)."""
    u = uniform(key, n, minval=_FLOAT32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))
