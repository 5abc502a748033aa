"""The port's threefry noise against ``jax.random``: key words, bits and
uniforms bitwise; each ``log`` of the Gumbel transform within one float32
ulp; ``make_eps_fn`` within the error those two ulps propagate to."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro_torch.core import random as jr
from repro_torch.engine.spec_decode import make_eps_fn

TINY = float(np.finfo(np.float32).tiny)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed,sid,pos", [(0, 0, 0), (9, 3, 17),
                                          (2 ** 32 + 5, 123456, 2 ** 31 - 1)])
def test_fold_in_and_bits_bitwise(seed, sid, pos):
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 sid), pos)
    key = jr.fold_in(jr.fold_in(jr.prng_key(seed), sid), pos)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jkey)).astype(np.int64),
        [int(key[0]), int(key[1])])
    want = np.asarray(jax.random.bits(jkey, (4099,), jnp.uint32))
    got = jr.random_bits(key, 4099).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("stream", range(6))
def test_uniform_bitwise_and_gumbel_logs_within_one_ulp(stream):
    """One vocab-sized noise row per stream. Rows stay under torch's
    parallel grain (32768 elements): on its first call in a process,
    torch's multithreaded CPU ``log`` has been seen to return whole worker
    chunks ~1566 ulps off (ROADMAP.md §3), which is not the port's math."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(9), stream)
    key = jr.fold_in(jr.prng_key(9), stream)
    n = 30_000
    ju = np.asarray(jax.random.uniform(jkey, (n,), minval=TINY))
    u = jr.uniform(key, n, minval=TINY)
    np.testing.assert_array_equal(u.numpy(), ju)
    # the two log steps, each on the same float32 input
    inner_j = np.asarray(-jnp.log(jnp.asarray(ju)))
    assert _ulps(-torch.log(u), inner_j).max() <= 1
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    assert _ulps(-torch.log(torch.from_numpy(inner_j.copy())),
                 outer_j).max() <= 1
    np.testing.assert_array_equal(
        np.asarray(jax.random.gumbel(jkey, (n,))), outer_j)


def test_eps_fn_matches_reference_within_propagated_ulps():
    V = 512
    seq_ids = np.array([0, 7, 300], np.int32)
    positions = np.array([[5, 6, 7, 8], [0, 1, 2, 3], [99, 100, 101, 102]],
                         np.int32)
    want = np.asarray(jax_make_eps_fn(jax.random.PRNGKey(9), V)(
        jnp.asarray(seq_ids), jnp.asarray(positions)))
    got = make_eps_fn(9, V)(torch.from_numpy(seq_ids.astype(np.int64)),
                            torch.from_numpy(positions.astype(np.int64)))
    assert got.shape == (3, 4, V) and got.dtype == torch.float32
    # g = -log(t), t = -log(u): one ulp of t moves g by spacing(t) / t,
    # plus one ulp of g itself; twice that first-order estimate, since
    # each side's t and g carry their own rounding
    t = np.exp(-want.astype(np.float64))
    bound = 2 * (np.spacing(np.float32(t)) / t
                 + np.spacing(np.abs(want).astype(np.float32)))
    assert (np.abs(got.numpy().astype(np.float64) - want) <= bound).all()
