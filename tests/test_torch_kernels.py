"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's ops take their plain versions, which are held here
against the JAX kernels run in interpret mode (as tests/kernels runs
them): spec_verify bitwise; the paged writeback bitwise on every pool block
but the sink 0; the fused paged decode and the fused MLA latent decode
with pools bitwise (sink excluded) and outputs within 2e-5 (float32 softmax
sums in another order).

The paged decode kernel's split-key design (``csrc/paged_decode.cu``) is
emulated in float32 torch ops on the plan ``split_plan`` gives the wrapper:
row tiles and key splits, each key read from the window rows or through
the block table entries its CTA staged, the cap at the table's span, the
32-key stages and the merge, and the writeback shared out over the CTAs of
a kv head. It is held within 1e-6 against the plain version and the Pallas
kernel, its pools bitwise (sink excluded), and its writeback must write
every in-table window slot exactly once and no slot the attention reads;
also at gemma's head width 256 (4 and 8 query heads over one kv head,
windows the lengths run past, the 64-wide prefill chunk) and at
mistral-large-123b's group of 12 (6 row tiles of a verify window).

The latent kernel's bf16 tensor-core arithmetic (``csrc/paged_latent.cu``)
is emulated in float32 torch ops on bf16-valued inputs, on the plan
``latent_plan`` gives the wrapper: 64-row tiles of rows w * H + h, q read
through the model's views, column splits, 32-key tiles from the window
rows or the table, the score K-sliced in k16 steps over r then dr in two
halves, the softmax in log2 units and P split hi + lo. It is held within
1e-4 against the Pallas kernel and the plain version (P keeps 16 bits of
mantissa), its pools bitwise (sink excluded), and its commit must write
every in-table window slot once and no slot the attention reads.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_write_kernel
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ops import \
    paged_latent_attention as jax_paged_latent
from repro.kernels.spec_verify.kernel import spec_verify_kernel
from repro_torch.kernels.paged_attention.kernel import latent_plan
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_latent_attention,
                                                     paged_window_write)
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.kernels.split import ROWS, split_plan

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _t(a):
    return torch.from_numpy(np.array(a))


def _verify_inputs(rng, R, V):
    logits = rng.standard_normal((R, V)).astype(np.float32)
    eps = rng.gumbel(size=(R, V)).astype(np.float32)
    top = (logits + eps).max(axis=1)
    # exact ties: the lowest index must win
    logits[0, 3] = logits[0, V - 2] = top[0] + 1.0
    eps[0, 3] = eps[0, V - 2] = 0.0
    logits[1, :] = -np.inf                 # an all -inf row picks index 0
    return logits, eps


@pytest.mark.parametrize("R,V", [(8, 512), (16, 3000), (3, 1024)])
def test_spec_verify_plain_matches_pallas_bitwise(R, V):
    logits, eps = _verify_inputs(np.random.default_rng(R * V), R, V)
    want = np.asarray(spec_verify_kernel(jnp.asarray(logits),
                                         jnp.asarray(eps), interpret=True))
    got = spec_verify(_t(logits), _t(eps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _tables(rng, B, nb, P, alloc):
    """Distinct physical blocks per row over [1, P); entries past a row's
    ``alloc`` stay 0 (the sink), as for a table not yet grown."""
    ids = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    tables = ids.astype(np.int32)
    for b, a in enumerate(alloc):
        tables[b, a:] = 0
    return tables


@pytest.mark.parametrize("W,active", [(1, [1, 1]), (8, [1, 0]),
                                      (64, [1, 1])])
def test_paged_write_plain_matches_pallas(W, active):
    rng = np.random.default_rng(W)
    B, bs, KV, d, nb = 2, 16, 2, 64, 6
    P = 1 + B * nb
    pool = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    new = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    start = np.array([3, nb * bs - W - 5], np.int32)
    tables = _tables(rng, B, nb, P, [nb, nb - 1])
    act = np.array(active, np.int32)
    want = np.asarray(paged_write_kernel(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(start), jnp.asarray(act), interpret=True))
    got = paged_window_write(_t(pool), _t(new), _t(tables), _t(start),
                             _t(act))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


@pytest.mark.parametrize("W,window,d", [
    pytest.param(1, 0, 64, id="1-0"), pytest.param(8, 0, 64, id="8-0"),
    pytest.param(64, 0, 64, id="64-0"), pytest.param(8, 24, 64, id="8-24"),
    pytest.param(8, 24, 256, id="8-24-d256")])           # gemma's width
def test_paged_decode_plain_matches_pallas(W, window, d):
    rng = np.random.default_rng(100 + W + window)
    B, H, KV, bs, nb = 2, 4, 2, 16, 6
    P = 1 + B * nb
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    kp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    vp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    kn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    vn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    lengths = np.array([nb * bs - W - 3, 2], np.int32)
    tables = _tables(rng, B, nb, P, [nb, -(-(2 + W) // bs)])
    want, wk, wv = jax_paged(*map(jnp.asarray, (q, kp, vp, kn, vn, tables,
                                                lengths)),
                             window=window, interpret=True)
    got, gk, gv = paged_attention(*map(_t, (q, kp, vp, kn, vn, tables,
                                            lengths)), window=window)
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_array_equal(gv.numpy()[1:], np.asarray(wv)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("W", [1, 4, 8])
def test_paged_latent_plain_matches_pallas(W):
    """MLA's absorbed-latent decode at the reduced widths (4 heads, latent
    32, rope 16): one row near the end of its table, one short row whose
    table is not grown past its window."""
    rng = np.random.default_rng(200 + W)
    B, H, r, dr, bs, nb = 2, 4, 32, 16, 4, 6
    P = 1 + B * nb
    ql = rng.standard_normal((B, W, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, W, H, dr)).astype(np.float32)
    cp = rng.standard_normal((P, bs, r)).astype(np.float32)
    kp = rng.standard_normal((P, bs, dr)).astype(np.float32)
    cn = rng.standard_normal((B, W, r)).astype(np.float32)
    kn = rng.standard_normal((B, W, dr)).astype(np.float32)
    lengths = np.array([nb * bs - W - 1, 3], np.int32)
    tables = _tables(rng, B, nb, P, [nb, -(-(3 + W) // bs)])
    scale = 1.0 / 64 ** 0.5                 # 1/sqrt(qk_nope + qk_rope)
    want, wc, wk = jax_paged_latent(
        *map(jnp.asarray, (ql, qr, cp, kp, cn, kn, tables, lengths)),
        scale=scale, interpret=True)
    got, gc, gk = paged_latent_attention(
        *map(_t, (ql, qr, cp, kp, cn, kn, tables, lengths)), scale=scale)
    np.testing.assert_array_equal(gc.numpy()[1:], np.asarray(wc)[1:])
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _split_paged_decode(q, kp, vp, kn, vn, tables, lengths, window):
    """paged_decode.cu's arithmetic in float32 torch ops, on the plan
    ``split_plan`` gives the wrapper over the span nb * bs. Per (sequence,
    kv head, row tile of ``ROWS`` w-major rows) the keys some row sees,
    [lo, hi], capped at nb * bs - 1; each split's even share, its table
    entries staged once, each key from k_new/v_new inside the window and
    through the staged entries elsewhere, scored 32 keys at a time with an
    online softmax; the partials merged by weighing those with l > 0. The
    pools are read as they were before the call; the writeback (row w of a
    head by its CTA w mod the head's CTA count) goes to copies. Returns
    (out, k_pool, v_pool, writes, reads): the pool slots (block, slot,
    head) written with their write counts and those read."""
    B, W, H, d = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    G, S = H // KV, nb * bs
    n_tiles, n_splits = split_plan(S, W, G, KV, B, window)
    per_max = -(-S // n_splits)
    out = torch.zeros((B, W, H, d))
    k_out, v_out = kp.clone(), vp.clone()
    writes, reads = {}, set()
    for b in range(B):
        L = int(lengths[b])
        for h in range(KV):
            for cta in range(n_tiles * n_splits):          # the writeback
                for w in range(cta, W, n_tiles * n_splits):
                    blk = (L + w) // bs
                    if blk < nb:
                        slot = (int(tables[b, blk]), (L + w) % bs, h)
                        writes[slot] = writes.get(slot, 0) + 1
                        k_out[slot] = kn[b, w, h]
                        v_out[slot] = vn[b, w, h]
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
                    blk0 = c_lo // bs
                    tab = tables[b, blk0:c_hi // bs + 1].tolist()
                    assert len(tab) <= (per_max + bs - 2) // bs + 1
                    m = torch.full((nr,), -1e30)
                    l, acc = torch.zeros(nr), torch.zeros((nr, d))
                    for k0 in range(c_lo, c_hi + 1, 32):
                        kpos = list(range(k0, min(k0 + 32, c_hi + 1)))
                        kr, vr = [], []
                        for p in kpos:
                            if L <= p < L + W:
                                kr.append(kn[b, p - L, h])
                                vr.append(vn[b, p - L, h])
                            else:
                                slot = (tab[p // bs - blk0], p % bs, h)
                                reads.add(slot)
                                kr.append(kp[slot])
                                vr.append(vp[slot])
                        kr = torch.stack(kr).float()
                        vr = torch.stack(vr).float()
                        kt = torch.tensor(kpos)
                        vis = kt[None] <= qpos[:, None]
                        if window > 0:
                            vis &= kt[None] > qpos[:, None] - window
                        x = torch.where(vis, (qr @ kr.T) / d ** 0.5,
                                        torch.tensor(-1e30))
                        m_new = torch.maximum(m, x.amax(1))
                        p = torch.where(vis, torch.exp(x - m_new[:, None]),
                                        0.0)
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vr
                        m = m_new
                    ms.append(m if c_lo <= c_hi
                              else torch.full((nr,), -float("inf")))
                    ls.append(l)
                    accs.append(acc)
                m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
                live = l > 0
                top = torch.where(live, m, -float("inf")).amax(0)
                wt = torch.where(live, torch.exp(m - top), 0.0)
                out[b, w, hq] = (wt[..., None] * acc).sum(0) / torch.clamp(
                    (wt * l).sum(0), min=1e-30)[:, None]
    return out.to(q.dtype), k_out, v_out, writes, reads


@pytest.mark.parametrize("W,window,lengths,empty,plan", [
    (1, 0, (0, 37), False, (1, 2)),        # a row of length 0
    (8, 0, (70, 3), False, (1, 2)),        # shares of 39 keys: two stages
    (64, 0, (16, 20), False, (8, 2)),      # 8 row tiles
    (8, 24, (70, 3), False, (1, 1)),       # a window: one split, no merge
    (8, 0, (93, 5), False, (1, 2)),        # rows past the table's span
    (8, 0, (37, 0), True, (1, 2))])        # an empty slot: all-zero table
def test_paged_split_decode_matches_plain_and_pallas(W, window, lengths,
                                                     empty, plan):
    _check_paged_split(W, window, lengths, empty, plan, H=4, KV=2)


@pytest.mark.parametrize("W,window,lengths,plan", [
    (8, 0, (70, 3), (3, 2)),               # 48 rows: w * 6 + g over 3 tiles
    (8, 24, (70, 3), (3, 1)),              # a window
    (1, 0, (0, 37), (1, 2))])              # 6 rows in one tile
def test_paged_split_decode_at_a_group_of_6(W, window, lengths, plan):
    """dbrx's GQA group, 48 query heads over 8 kv heads (G = 6), cut to 12
    over 2: a tile's 16 rows span three or four window positions."""
    _check_paged_split(W, window, lengths, False, plan, H=12, KV=2)


@pytest.mark.parametrize("W,window,lengths,H,d,plan", [
    (8, 24, (70, 30), 4, 256, (2, 1)),     # gemma3-1b: G = 4, a window
    (8, 70, (80, 30), 4, 256, (2, 2)),     # a window wide enough to split
    (8, 0, (70, 3), 8, 256, (4, 2)),       # gemma-2b: G = 8
    (64, 24, (16, 20), 4, 256, (16, 1)),   # the prefill chunk, 16 tiles
    (8, 0, (70, 3), 12, 64, (6, 2))])      # mistral-large-123b: G = 12
def test_paged_split_decode_at_the_dense_configs_groups(W, window, lengths,
                                                        H, d, plan):
    """One kv head, as gemma has (mistral's 8 run alike): a tile's 16 rows
    span 4 window positions at G = 4, and 2 at G = 8 and 12."""
    _check_paged_split(W, window, lengths, False, plan, H=H, KV=1, d=d)


def _check_paged_split(W, window, lengths, empty, plan, H, KV, d=64):
    rng = np.random.default_rng(300 + W + window + lengths[0])
    B, bs, nb = 2, 16, 6
    P = 1 + B * nb
    q = rng.standard_normal((B, W, H, d)).astype(np.float32)
    kp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    vp = rng.standard_normal((P, bs, KV, d)).astype(np.float32)
    kn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    vn = rng.standard_normal((B, W, KV, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    alloc = [min(nb, -(-(L + W) // bs)) for L in lengths]
    tables = _tables(rng, B, nb, P, alloc)
    if empty:
        tables[1] = 0
    ins = (q, kp, vp, kn, vn, tables, lens)
    assert split_plan(nb * bs, W, H // KV, KV, B, window) == plan
    got, gk, gv, writes, reads = _split_paged_decode(*map(_t, ins), window)
    # every in-table window slot written once, none the attention reads
    want_writes = {(int(tables[b, (L + w) // bs]), (L + w) % bs, h)
                   for b, L in enumerate(lengths) for w in range(W)
                   for h in range(KV) if L + w < nb * bs}
    assert set(writes) == want_writes
    assert set(writes.values()) == {1}
    assert not reads & set(writes)
    plain, pk, pv = paged_attention(*map(_t, ins), window=window)
    np.testing.assert_array_equal(gk.numpy()[1:], pk.numpy()[1:])
    np.testing.assert_array_equal(gv.numpy()[1:], pv.numpy()[1:])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    want, wk, wv = jax_paged(*map(jnp.asarray, ins), window=window,
                             interpret=True)
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_array_equal(gv.numpy()[1:], np.asarray(wv)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_latent_plan_fills_the_card_from_the_shapes():
    """64-row tiles, and the fewest column splits whose CTAs reach one per
    SM, else the most the kernel is compiled for: 4 at the verify (B = 2,
    W = 8) and decode shapes, 2 at a 64-wide prefill chunk, 1 at the
    reduced widths."""
    assert latent_plan(128 * 8, 2, 512, 64) == (16, 4)
    assert latent_plan(128 * 64, 1, 512, 64) == (128, 2)
    assert latent_plan(128, 2, 512, 64) == (2, 4)
    assert latent_plan(4 * 8, 2, 32, 16) == (1, 1)
    assert latent_plan(4 * 64, 1, 32, 16) == (4, 1)
    assert latent_plan(8 * 8, 3, 512, 64) == (1, 4)


def _bf16(a):
    """float32 values that bfloat16 holds exactly (the kernel's operands)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _tc_latent(ql, qr, cp, kp, cn, kn, tables, lengths, scale):
    """paged_latent.cu's bf16 tensor-core arithmetic in float32 torch ops,
    on the plan ``latent_plan`` gives the wrapper: per sequence, 64-row
    tiles of rows w * H + h, each query row read from q_lat and q_rope
    through their (b, w, h) indexing (the kernel's strides); per column
    split, the tile's visible keys in 32-key tiles, each key from
    c_new/kr_new inside the window and through the table elsewhere; the
    score of a k16 step as a float32 product of bf16 values (exact), summed
    over the steps of each half of the 576-deep product (r, then dr), the
    halves added; the online softmax in log2 units (exp2); P split into
    hi = bf16(p) and lo = bf16(p - hi), each multiplied by the tile's
    c_kv rows (its split's columns) 16 keys at a time. The pools are read
    as they were before the call; the window commit (row w by the CTA
    w mod the sequence's CTA count) goes to copies. Returns (out, c_pool,
    kr_pool, writes, reads): the slots written with their counts and those
    read."""
    B, W, H, r = ql.shape
    dr = qr.shape[-1]
    bs, nb = cp.shape[1], tables.shape[1]
    span, R = nb * bs, H * W
    n_tiles, splits = latent_plan(R, B, r, dr)
    steps = (r + dr) // 16
    scale2 = scale * 1.4426950408889634
    out = torch.zeros((B, W, H, r))
    c_out, k_out = cp.clone(), kp.clone()
    writes, reads = {}, set()
    for b in range(B):
        L = int(lengths[b])
        n_ctas = n_tiles * splits
        for cta in range(n_ctas):                      # the commit
            for w in range(cta, W, n_ctas):
                if L + w < span:
                    slot = (int(tables[b, (L + w) // bs]), (L + w) % bs)
                    writes[slot] = writes.get(slot, 0) + 1
                    c_out[slot], k_out[slot] = cn[b, w], kn[b, w]
        for tile in range(n_tiles):
            row0 = tile * 64
            nr = min(64, R - row0)
            rows = torch.arange(row0, row0 + nr)
            w, h = rows // H, rows % H
            q = torch.cat([ql[b, w, h], qr[b, w, h]], -1).float()
            n_keys = min(L + (row0 + nr - 1) // H + 1, span)
            last = torch.clamp(L + w, max=n_keys - 1)
            for cq in range(splits):
                cols = slice(cq * r // splits, (cq + 1) * r // splits)
                m = torch.full((nr,), -1e30)
                l, acc = torch.zeros(nr), torch.zeros((nr, r // splits))
                for k0 in range(0, n_keys, 32):
                    kr_ = []
                    for p in range(k0, min(k0 + 32, n_keys)):
                        if p >= L:
                            kr_.append(torch.cat([cn[b, p - L], kn[b, p - L]]))
                        else:
                            slot = (int(tables[b, p // bs]), p % bs)
                            reads.add(slot)
                            kr_.append(torch.cat([cp[slot], kp[slot]]))
                    K = torch.stack(kr_).float()
                    halves = []
                    for lo_, hi_ in ((0, steps // 2), (steps // 2, steps)):
                        part = torch.zeros((nr, K.shape[0]))
                        for st in range(lo_, hi_):
                            ks = slice(16 * st, 16 * st + 16)
                            part = part + q[:, ks] @ K[:, ks].T
                        halves.append(part)
                    s = halves[0] + halves[1]
                    vis = (torch.arange(k0, k0 + K.shape[0])[None]
                           <= last[:, None])
                    x = torch.where(vis, s * scale2, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.amax(1))
                    p = torch.where(vis, torch.exp2(x - m_new[:, None]), 0.0)
                    alpha = torch.exp2(m - m_new)
                    l = alpha * l + p.sum(1)
                    m = m_new
                    hi = p.to(torch.bfloat16).float()
                    lo = (p - hi).to(torch.bfloat16).float()
                    acc = acc * alpha[:, None]
                    V = K[:, cols]
                    for j0 in range(0, K.shape[0], 16):
                        js = slice(j0, j0 + 16)
                        acc = acc + hi[:, js] @ V[js]
                        acc = acc + lo[:, js] @ V[js]
                out[b, w, h, cols] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out, c_out, k_out, writes, reads


@pytest.mark.parametrize("W,H,r,dr,lengths,empty", [
    (1, 4, 32, 16, (60, 3), False),         # decode, reduced widths
    (8, 4, 32, 16, (83, 0), True),          # verify; an empty slot
    (64, 4, 32, 16, (16, 20), False),       # a prefill chunk: 4 row tiles
    (8, 16, 32, 16, (45, 9), False),        # tiles spanning several w
    (8, 8, 512, 64, (50, 7), False)])       # the full latent: 4 splits
def test_latent_tensor_core_arithmetic_matches_plain_and_pallas(
        W, H, r, dr, lengths, empty):
    """The emulated kernel on bf16-valued inputs, q_lat and q_rope as the
    model's views (a permutation; the rope slice of q's rows): pools
    bitwise against the Pallas kernel (sink excluded), every in-table
    window slot written once and none the attention reads, and the output
    within 1e-4 of the Pallas kernel's and the plain version's (float32
    sums in another order, and P kept to 16 bits of mantissa: p - hi - lo
    is below 2^-16 p)."""
    rng = np.random.default_rng(400 + W + H + r)
    B, bs, nb = 2, 16, 6
    P = 1 + B * nb
    ql = _bf16(rng.standard_normal((H, B, W, r)).astype(np.float32))
    qr = _bf16(rng.standard_normal((B, W, H, 128 + dr)).astype(np.float32))
    cp, kp, cn, kn = (_bf16(rng.standard_normal(s).astype(np.float32))
                      for s in ((P, bs, r), (P, bs, dr), (B, W, r),
                                (B, W, dr)))
    lens = np.array(lengths, np.int32)
    alloc = [min(nb, -(-(L + W) // bs)) for L in lengths]
    tables = _tables(rng, B, nb, P, alloc)
    if empty:
        tables[1] = 0
    scale = 1.0 / (128 + dr) ** 0.5
    ql_v = _t(ql).permute(1, 2, 0, 3)           # (B, W, H, r), strided
    qr_v = _t(qr)[..., 128:]                     # the rope slice
    ins = (cp, kp, cn, kn, tables, lens)
    got, gc, gk, writes, reads = _tc_latent(ql_v, qr_v, *map(_t, ins),
                                            scale)
    want_writes = {(int(tables[b, (L + w) // bs]), (L + w) % bs)
                   for b, L in enumerate(lengths) for w in range(W)
                   if L + w < nb * bs}
    assert set(writes) == want_writes and set(writes.values()) == {1}
    assert not reads & set(writes)
    want, wc, wk = jax_paged_latent(
        jnp.asarray(ql.transpose(1, 2, 0, 3)), jnp.asarray(qr[..., 128:]),
        *map(jnp.asarray, ins), scale=scale, interpret=True)
    np.testing.assert_array_equal(gc.numpy()[1:], np.asarray(wc)[1:])
    np.testing.assert_array_equal(gk.numpy()[1:], np.asarray(wk)[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain, _, _ = paged_latent_attention(
        ql_v, qr_v, *map(_t, ins), scale=scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)
