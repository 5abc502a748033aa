"""JAX-compatible counter-based noise: threefry2x32, ``fold_in``, ``uniform``,
``gumbel`` and ``normal``, as torch ops on int64 tensors holding uint32
values.

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
* narrower bits (``width`` 8 or 16) are the low bits of that XOR;
* ``uniform`` keeps the top mantissa bits as a mantissa in ``[1, 2)``,
  subtracts one, scales and clamps to ``minval``, in the output's dtype:
  float32 from 32 bits (23 of them), bfloat16 from 8 bits (7 of them; JAX
  draws at least 8), each step rounded to bfloat16 as JAX's are;
* ``gumbel`` is ``-log(-log(uniform(minval=tiny, maxval=1)))``;
* ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
  ``erfinv`` XLA's single-precision polynomial (M. Giles, "Approximating
  the erfinv function", GPU Computing Gems, 2011), evaluated in float32
  and rounded to the dtype before the product.

The bits equal JAX's bitwise, and so do the uniforms over the ranges the
port draws (``gumbel``'s and ``normal``'s, where scaling by the span is
exact): XLA fuses the float32 scale and shift into one multiply-add, so
over another float32 range a value may round once otherwise. Each of the
two ``log``
steps of ``gumbel`` agrees with XLA's within one float32 ulp on the same
input: torch's ``log`` need not round as XLA's does. Composed, the inner
step's ulp is scaled by ``1 / -log(u)``, which is large for ``u`` near 1,
so a test that needs equal noise feeds one side's eps to the other. For
the same reason (``log1p`` inside ``erfinv``) a float32 ``normal`` agrees
with JAX's within 4 ulps (95% of values bitwise); a bfloat16 one equals
it bitwise, as it rounds the float32 ``erfinv`` of each of the 128
uniforms it can draw to bfloat16 (``tests/test_torch_frontends.py``).
"""
from __future__ import annotations

import math

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


def random_bits(key, n: int, width: int = 32):
    """``jax.random.bits(key, (n,))`` of ``width`` bits (8, 16 or 32) for
    each key in a batch of keys of shape ``S``: returns ``S + (n,)`` int64
    values."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits: width {width}; want 8, 16 or 32")
    k1, k2 = key
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(counts), counts)
    return (y1 ^ y2) & ((1 << width) - 1)


# dtype -> (bits drawn, mantissa bits, the int dtype of its width, 1.0's bits)
_UNIFORM = {torch.float32: (32, 23, torch.int32, 0x3F800000),
            torch.bfloat16: (8, 7, torch.int16, 0x3F80)}


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32):
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)`` for a
    float32 or bfloat16 ``dtype``."""
    if dtype not in _UNIFORM:
        raise TypeError(f"uniform: dtype {dtype}; want float32 or bfloat16")
    width, mant, int_dtype, one = _UNIFORM[dtype]
    bits = random_bits(key, n, width)
    fbits = (bits >> (width - mant)) | one
    floats = fbits.to(int_dtype).view(dtype) - 1.0
    if dtype == torch.float32:
        # float32 scalars, as JAX converts them; no host-to-device copy, so
        # the noise can be captured in a CUDA graph
        lo = float(torch.tensor(minval, dtype=torch.float32))
        span = float(torch.tensor(maxval, dtype=torch.float32)
                     - torch.tensor(minval, dtype=torch.float32))
        return torch.clamp(floats * span + lo, min=lo)
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, n: int):
    """float32 ``jax.random.gumbel(key, (n,))`` (the default mode)."""
    u = uniform(key, n, minval=_FLOAT32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


# XLA's single-precision erfinv: a degree-8 polynomial in w - 2.5 for
# w = -log1p(-x^2) < 5, and in sqrt(w) - 3 above, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """The inverse error function of float32 ``x`` in (-1, 1), as XLA
    computes it (±1 give ±the largest float32)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape, dtype=torch.float32):
    """``jax.random.normal(key, shape, dtype)`` for one key and a float32
    or bfloat16 ``dtype``."""
    shape = tuple(shape)
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, math.prod(shape), lo, 1.0, dtype)
    root2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=u.device)
    return (root2 * erfinv(u.float()).to(dtype)).reshape(shape)
