"""The plain versions of the port's WKV-recurrence and dense flash-decode
kernels against the reference's Pallas kernels, run in interpret mode as
tests/kernels runs them, and the solo sampler on the dense flash-decode
op's route against the reference.

On the CPU the port's ops take their plain versions (``ref.py``). The WKV
op in its zero-state form is held against ``rwkv_wkv`` (Pallas), including
lengths that are not a multiple of its 64-step chunk; its window form (a
given initial state, the state after every position) and its last-state
form against the model scan ``RWKV6TimeMix._wkv_scan`` in float32. The
dense flash-decode op against ``decode_attention`` (Pallas) with two query
heads per kv head, a sliding window, a cache length that is not a multiple
of the Pallas key block and up to 40 queries, at head width 64 and at
gemma's 256.

Tolerances: outputs and states 2e-5 relative to the largest value (float32
sums in another order, carried through up to 130 steps of the state);
attention outputs 2e-5 (float32 softmax sums in another order); the
sampler's ``row_stats``, tokens and windows bitwise under the same noise,
whole generations under the margin rule with tolerance 1e-4.

The dense flash-decode kernel's split-key plan (``split.split_plan``) and
its chunk-and-merge arithmetic are emulated in float32 torch ops and held
within 1e-6 against the plain version and the Pallas kernel: chunks with no
visible key, a row of length 0, several row tiles, chunks that do not
divide the keys; and at head width 256 with gemma's groups (4 and 8 query
heads over one kv head), windows the lengths run past, and the 64-wide
prefill chunk's 16 row tiles (there 4e-6 against the Pallas kernel, whose
256-long dot products are summed in another order).

The WKV kernel's prefill and zero-state schedule (the state in 8-row
groups by column, each group's partial of y summed in the thread's order,
the groups added once per chunk) is emulated in float32 torch ops and
held within 2e-5 against the Pallas kernel, the model scan and the plain
version.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.engine.spec_decode import PredictiveSampler as JaxSampler
from repro.engine.spec_decode import make_eps_fn as jax_make_eps_fn
from repro.engine.spec_decode import verify_round as jax_verify_round
from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.rwkv_wkv.ops import rwkv_wkv as jax_rwkv_wkv
from repro.models.ssm import RWKV6TimeMix as JaxTMix
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.agreement import check_token_agreement, top2_margin
from repro_torch.engine.spec_decode import PredictiveSampler, verify_round
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
from repro_torch.kernels.split import ROWS, split_plan

CPU = torch.device("cpu")
EPS_KEY = jax.random.PRNGKey(9)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _wkv_inputs(rng, B, T, H, hd):
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, size=(B, T, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("T,hd", [(16, 32), (64, 64), (100, 64),
                                  (130, 32)])
def test_wkv_plain_matches_pallas(T, hd):
    """The zero-state form; T = 100 and 130 leave a ragged last chunk,
    which the Pallas kernel pads with w = 1."""
    r, k, v, w, u = _wkv_inputs(np.random.default_rng(T + hd), 2, T, 4, hd)
    want = jax_rwkv_wkv(*map(jnp.asarray, (r, k, v, w, u)), use_kernel=True,
                        interpret=True)
    got = rwkv_wkv(*map(_t, (r, k, v, w, u)))
    assert got.shape == (2, T, 4, hd)
    _close_rel(got, want, 2e-5)


@pytest.mark.parametrize("W", [1, 8, 33])
def test_wkv_window_and_last_state_forms_match_model_scan(W):
    rng = np.random.default_rng(W)
    r, k, v, w, u = _wkv_inputs(rng, 2, W, 4, 32)
    s0 = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    jy, jS = JaxTMix._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    y, S = rwkv_wkv(*map(_t, (r, k, v, w, u, s0)), states="all")
    assert S.shape == (2, W, 4, 32, 32)
    _close_rel(y, jy, 2e-5)
    _close_rel(S, jS, 2e-5)
    y2, S2 = rwkv_wkv(*map(_t, (r, k, v, w, u, s0)), states="last")
    assert torch.equal(y2, y) and torch.equal(S2, S[:, -1])


@pytest.mark.parametrize("W,window,S,d", [
    pytest.param(1, 0, 70, 64, id="1-0-70"),
    pytest.param(8, 0, 70, 64, id="8-0-70"),
    pytest.param(8, 24, 70, 64, id="8-24-70"),
    pytest.param(40, 0, 96, 64, id="40-0-96"),
    pytest.param(40, 16, 83, 64, id="40-16-83"),
    pytest.param(8, 24, 70, 256, id="8-24-70-d256"),      # gemma's width
    pytest.param(40, 16, 83, 256, id="40-16-83-d256")])
def test_decode_attention_plain_matches_pallas(W, window, S, d):
    rng = np.random.default_rng(W + window + S)
    B, H, KV = 2, 4, 2
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    lengths = np.array([S - W, 3], np.int32)
    want = jax_decode_attention(*map(jnp.asarray, (q, k, v, lengths)),
                                window=window, block_k=16, interpret=True)
    got = decode_attention(*map(_t, (q, k, v, lengths)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _split_decode(q, k, v, lengths, window):
    """decode_attention.cu's arithmetic in float32 torch ops, on the plan
    ``split_plan`` gives the wrapper: per (sequence, kv head, row tile of
    ``ROWS`` w-major rows) the keys some row sees, [lo, hi], from the
    length; each split's even share of them, scored 32 keys at a time with
    an online softmax; the partials (m, l, acc) merged by weighing those
    with l > 0. Returns (out, number of empty chunks, n_tiles, n_splits)."""
    B, W, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    n_tiles, n_splits = split_plan(S, W, G, KV, B, window)
    out = torch.zeros((B, W, H, d))
    empty = 0
    for b in range(B):
        L = int(lengths[b])
        for h in range(KV):
            for tile in range(n_tiles):
                r0 = tile * ROWS
                nr = min(ROWS, W * G - r0)
                rows = torch.arange(r0, r0 + nr)
                w, hq = rows // G, h * G + rows % G
                qr, qpos = q[b, w, hq].float(), L + w
                hi = min(L + (r0 + nr - 1) // G, S - 1)
                lo = max(0, L + r0 // G - window + 1) if window > 0 else 0
                per = -(-max(0, hi - lo + 1) // n_splits)
                ms, ls, accs = [], [], []
                for s in range(n_splits):
                    c_lo = lo + s * per
                    c_hi = min(hi, c_lo + per - 1)
                    m = torch.full((nr,), -1e30)
                    l, acc = torch.zeros(nr), torch.zeros((nr, d))
                    empty += c_lo > c_hi
                    for k0 in range(c_lo, c_hi + 1, 32):
                        kp = torch.arange(k0, min(k0 + 32, c_hi + 1))
                        vis = kp[None] <= qpos[:, None]
                        if window > 0:
                            vis &= kp[None] > qpos[:, None] - window
                        x = torch.where(
                            vis, (qr @ k[b, kp, h].float().T) / d ** 0.5,
                            torch.tensor(-1e30))
                        m_new = torch.maximum(m, x.amax(1))
                        p = torch.where(vis, torch.exp(x - m_new[:, None]),
                                        0.0)
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(1)
                        acc = acc * alpha[:, None] + p @ v[b, kp, h].float()
                        m = m_new
                    ms.append(m if c_lo <= c_hi
                              else torch.full((nr,), -float("inf")))
                    ls.append(l)
                    accs.append(acc)
                m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
                live = l > 0
                top = torch.where(live, m, -float("inf")).amax(0)
                wt = torch.where(live, torch.exp(m - top), 0.0)
                o = (wt[..., None] * acc).sum(0) / torch.clamp(
                    (wt * l).sum(0), min=1e-30)[:, None]
                out[b, w, hq] = o
    return out.to(q.dtype), empty, n_tiles, n_splits


@pytest.mark.parametrize("W,window,S,lengths,tiles,splits,empty", [
    (1, 0, 300, (0, 5), 1, 5, 12),        # length 0: one key, 4 empty
    (8, 0, 300, (250, 37), 1, 5, 0),      # shares of 52 and 9 keys
    (79, 0, 200, (1, 100), 10, 4, 2),     # 10 row tiles; 9 keys over 4
    (8, 100, 300, (250, 3), 1, 2, 0),     # a window, chunks of 54 keys
    (40, 16, 83, (43, 3), 5, 1, 0)])      # one split: no merge
def test_decode_split_and_merge_matches_plain_and_pallas(
        W, window, S, lengths, tiles, splits, empty):
    rng = np.random.default_rng(W + window + S)
    B, H, KV, d = 2, 4, 2, 64
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    got, n_empty, n_tiles, n_splits = _split_decode(
        *map(_t, (q, k, v, lens)), window)
    assert (n_tiles, n_splits, n_empty) == (tiles, splits, empty)
    want = decode_attention(*map(_t, (q, k, v, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    pallas = jax_decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                  window=window, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("W,window,S,lengths,tiles,splits", [
    (8, 0, 300, (250, 37), 3, 5),         # 48 rows: w * 6 + g, 3 tiles
    (8, 100, 300, (250, 3), 3, 2),        # a window
    (79, 0, 200, (1, 100), 30, 2)])       # the prompt prefill's width
def test_decode_split_and_merge_at_a_group_of_6(W, window, S, lengths, tiles,
                                               splits):
    """dbrx's GQA group, 48 query heads over 8 kv heads (G = 6), cut to 12
    over 2: a tile's 16 rows span three or four window positions."""
    rng = np.random.default_rng(W + window + S + 6)
    B, H, KV, d = 2, 12, 2, 64
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    got, _, n_tiles, n_splits = _split_decode(*map(_t, (q, k, v, lens)),
                                              window)
    assert (n_tiles, n_splits) == (tiles, splits)
    want = decode_attention(*map(_t, (q, k, v, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    pallas = jax_decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                  window=window, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("W,window,S,lengths,H,tiles,splits", [
    (8, 16, 83, (40, 70), 4, 2, 1),       # gemma3-1b: G = 4, the window bites
    (8, 100, 300, (250, 3), 4, 2, 2),     # a window wide enough to split
    (8, 0, 300, (250, 37), 8, 4, 5),      # gemma-2b: G = 8
    (64, 16, 140, (70, 0), 4, 16, 1)])    # the prefill chunk: 16 row tiles
def test_decode_split_and_merge_at_head_width_256(W, window, S, lengths, H,
                                                  tiles, splits):
    """gemma's head width 256 over one kv head: the same plan and merge;
    a tile's 16 rows span 4 or 2 window positions. Against the Pallas
    kernel 4e-6: its q.k dot products are 256 long, four times the reduced
    widths' 64, summed in another order."""
    rng = np.random.default_rng(W + window + S + H)
    B, KV, d = 2, 1, 256
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    got, _, n_tiles, n_splits = _split_decode(*map(_t, (q, k, v, lens)),
                                              window)
    assert (n_tiles, n_splits) == (tiles, splits)
    want = decode_attention(*map(_t, (q, k, v, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    pallas = jax_decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                  window=window, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=4e-6,
                               atol=4e-6)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen3-1.7b", reduced=True)
    jcfg = jax_get_config("qwen3-1.7b", reduced=True)
    jparams = JaxLM.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, params_from_numpy(tree, cfg)


def _jax_eps_for_port(vocab):
    jeps = jax.jit(jax_make_eps_fn(EPS_KEY, vocab))

    def eps_fn(seq_ids, positions):
        return _t(jeps(jnp.asarray(seq_ids.numpy(), jnp.int32),
                       jnp.asarray(positions.numpy(), jnp.int32)))
    return eps_fn


def test_solo_sampler_on_the_decode_op_matches_jax(qwen):
    """The solo sampler with ``use_attention_kernel`` (the dense flash-
    decode op in the prompt prefill and every round): three rounds'
    ``row_stats``, tokens and windows bitwise against the reference, then
    whole generations under the margin rule."""
    cfg, jcfg, jparams, params = qwen
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab, size=(3, 6))
    s = PredictiveSampler(cfg, params, window=8, max_len=40,
                          eps_fn=_jax_eps_for_port(cfg.vocab), device=CPU,
                          use_attention_kernel=True)
    js = JaxSampler(jcfg, jparams, window=8, max_len=40, eps_key=EPS_KEY)
    st = s.init_state(prompts, 3)
    jst = js.init_state(jnp.asarray(prompts, jnp.int32), 3)
    target = np.array([10, 30, 6], np.int64)
    for _ in range(3):
        st, stats = verify_round(params, cfg, s.eps_fn, st, _t(target),
                                 use_attention_kernel=True)
        jst, jstats = jax_verify_round(jparams, jcfg, js.eps_fn, jst,
                                       jnp.asarray(target, jnp.int32))
        np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(jst.tokens))
        np.testing.assert_array_equal(st.cand.numpy(), np.asarray(jst.cand))
    toks, _ = s.generate(prompts[:2, :5], 20)
    jtoks, _ = js.generate(jnp.asarray(prompts[:2, :5], jnp.int32), 20)
    jeps = jax_make_eps_fn(EPS_KEY, cfg.vocab)
    for b in range(2):
        ref = np.asarray(jtoks[b, :25])

        def margin_at(p, ref=ref, b=b):
            logits, _, _ = JaxLM.apply(jparams, jcfg,
                                       jnp.asarray(ref[None, :p], jnp.int32))
            e = jeps(jnp.asarray([b], jnp.int32),
                     jnp.asarray([[p]], jnp.int32))
            return top2_margin(np.asarray(logits[0, -1] + e[0, 0]))
        check_token_agreement(ref, toks[b, :25].numpy(), margin_at, tol=1e-4,
                              start=5)


def _spread_wkv(r, k, v, w, u, s0):
    """rwkv_wkv.cu's form 0 and 2 schedule in float32 torch ops: the state
    in row groups of 8 (a warp's) by column; per step each group's partial
    of y_t summed as the thread sums it (even rows into one accumulator,
    odd rows into another, the two added), the groups' partials added in
    order once per chunk, and S <- w S + k v per element. Columns are
    independent, so the CTAs' column halves and the 16-step chunks change
    no value. Returns (y, the state after the last position)."""
    B, T, H, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]                    # (1, H, hd, 1)
    S = s0.clone() if s0 is not None else torch.zeros((B, H, hd, hd))
    y = torch.zeros((B, T, H, hd))
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        part = (r[:, t, :, :, None] * (S + uu * kv)).reshape(
            B, H, hd // 8, 8, hd)
        ya, yb = part[:, :, :, 0], part[:, :, :, 1]
        for m in range(2, 8, 2):
            ya = ya + part[:, :, :, m]
            yb = yb + part[:, :, :, m + 1]
        groups = ya + yb                                # (B, H, hd/8, hd)
        acc = groups[:, :, 0]
        for g in range(1, hd // 8):
            acc = acc + groups[:, :, g]
        y[:, t] = acc
        S = w[:, t, :, :, None] * S + kv
    return y, S


@pytest.mark.parametrize("B,T,hd", [(2, 1, 64), (1, 17, 64), (2, 33, 32),
                                    (3, 100, 32)])
def test_wkv_spread_schedule_matches_pallas_and_model_scan(B, T, hd):
    """The spread kernel's schedule from the zero state against the Pallas
    kernel, and from a random float32 state (the prefill form) against the
    model scan, at T = 1, past one and two 16-step chunks, hd 32 and 64,
    B up to 3; within 2e-5 relative to the largest value, as the plain
    version."""
    rng = np.random.default_rng(500 + T + hd + B)
    r, k, v, w, u = _wkv_inputs(rng, B, T, 4, hd)
    y0, _ = _spread_wkv(*map(_t, (r, k, v, w, u)), None)
    want = jax_rwkv_wkv(*map(jnp.asarray, (r, k, v, w, u)), use_kernel=True,
                        interpret=True)
    _close_rel(y0, want, 2e-5)
    s0 = rng.standard_normal((B, 4, hd, hd)).astype(np.float32)
    y, S = _spread_wkv(*map(_t, (r, k, v, w, u, s0)))
    jy, jS = JaxTMix._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    _close_rel(y, jy, 2e-5)
    _close_rel(S, np.asarray(jS)[:, -1], 2e-5)
    py, pS = rwkv_wkv(*map(_t, (r, k, v, w, u, s0)), states="last")
    _close_rel(y, py, 2e-5)
    _close_rel(S, pS, 2e-5)
