"""Attention-free mixers: the RWKV-6 ("Finch") time and channel mix, and
the Mamba-1 selective SSM (as interleaved in Jamba).

All of them support:
* ``full``   — scan from the zero state over the whole sequence (apply);
* ``window`` — scan a W-token verify window from a carried state snapshot,
  returning the state after every position so the engine can adopt the one
  at its accept point (DESIGN.md §5: recurrent state is cumulative, so the
  engine snapshots at the last accepted position); with
  ``last_state_only`` only the state after the window's last position
  (prefill, which adopts exactly that one);
* ``advance_state`` — the reference's two-pass memory mode: the window
  recomputed with every update frozen from position ``accept`` on, so only
  the state after ``accept`` tokens exists (no per-position stack). It is
  a loop over time, as the reference's ``lax.scan``, and equals the
  per-position state at ``accept - 1`` bitwise, on the plain routes (on
  the card's WKV kernel route, within that kernel's rounding).

The WKV recurrence has two routes. The plain route is the reference's
model scan (``_wkv_scan``, ``_wkv_scan_chunked``): a loop over time that
carries the state in the model's dtype, rounding it at every step. The
kernel route (``use_kernel``) is the WKV op (``kernels/rwkv_wkv``): the
CUDA kernel on CUDA tensors, its float32 plain version on CPU tensors,
both carrying the state in float32. In float32 the two routes compute the
same function; in bfloat16 they differ by the state's rounding, which is
large: a decay near ``exp(-exp(-6))`` takes less than half a bf16 ulp off
the state, so the plain route's per-step rounding loses much of it.

The carried state ``S`` is stored in float32 whatever the model's dtype
(the reference stores it in the model's dtype). The kernel route reads and
writes it unrounded, so its tokens do not depend on where verify windows
and prefill chunks split the sequence; the plain route rounds it to the
model's dtype on entry, as the reference's scan does, which makes it
equal to the reference with either storage.

The decay ``w = exp(-exp(w0 + lora(x)))`` is computed in float32 and cast
to the model's dtype, as in the reference.

Mamba's selective scan has one route, the reference's: a float32 loop
over time (no kernel; the reference's scan is XLA ops). Its state ``h`` is
stored in float32 too, where the reference casts it to the model's dtype
at every window boundary: rounded there, the state would depend on where
windows and prefill chunks split the sequence, and the engine would part
from the solo sampler in bfloat16. The conv state holds the last three
conv inputs in the model's dtype, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv
from repro_torch.nn.core import Dense, LayerNorm, _normal


def _lora_init(gen, dim, rank, out_dim, dtype, device):
    return {"a": _normal(gen, (dim, rank), dtype, device, 0.02),
            "b": _normal(gen, (rank, out_dim), dtype, device, 0.02)}


def _lora_apply(p, x, base=None):
    y = torch.tanh(x @ p["a"]) @ p["b"]
    return y if base is None else base + y


def _shift(x, x_last=None):
    """The token-shifted inputs: x moved one position later, with
    ``x_last`` (B, D) (or zeros) in front."""
    first = (torch.zeros_like(x[:, :1]) if x_last is None
             else x_last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _at(x, accept):
    """x (B, W, ...) at position ``accept - 1`` of each row (0 where
    ``accept`` is 0, as the reference's ``take_along_axis``)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, (accept.long() - 1).clamp(min=0)]


def _wkv_step(S, r_t, k_t, v_t, w_t, u):
    """One step of the recurrence in the working dtype: returns (S_t, y_t)
    from S_{t-1} (B, H, hd, hd) and the step's (B, H, hd) rows."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
    return w_t[..., :, None] * S + kv, y


class RWKV6TimeMix:
    """Data-dependent-decay time mixing (the Finch contribution)."""

    MIX_KEYS = ("r", "k", "v", "w", "g")
    SCAN_CHUNK = 64

    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        D = cfg.d_model
        hd = cfg.rwkv_head_dim
        H = D // hd
        kw = dict(use_bias=False, dtype=dtype, device=device)
        half = lambda: 0.5 * torch.ones((D,), dtype=dtype,  # noqa: E731
                                        device=device)
        return {
            # token-shift interpolation factors (static part)
            "mu": {m: half() for m in RWKV6TimeMix.MIX_KEYS},
            "mu_x": half(),
            # data-dependent lerp LoRAs
            "lora": {m: _lora_init(gen, D, 32, D, dtype, device)
                     for m in RWKV6TimeMix.MIX_KEYS},
            "wr": Dense.init(gen, D, D, **kw),
            "wk": Dense.init(gen, D, D, **kw),
            "wv": Dense.init(gen, D, D, **kw),
            "wg": Dense.init(gen, D, D, **kw),
            "wo": Dense.init(gen, D, D, **kw),
            # decay: w_t = exp(-exp(w0 + lora_w(x_mixed))), data-dependent
            "w0": -6.0 + _normal(gen, (D,), dtype, device, 0.5),
            "w_lora": _lora_init(gen, D, 64, D, dtype, device),
            "u": 0.5 * torch.ones((H, hd), dtype=dtype, device=device),
            "ln_out": LayerNorm.init(D, dtype=dtype, device=device),
        }

    @staticmethod
    def _mix(p, x, x_prev):
        """Token-shift ddlerp (v6): per-stream data-dependent interpolation.
        x, x_prev: (B, T, D)."""
        dx = x_prev - x
        xx = x + dx * p["mu_x"]
        return {m: x + dx * (p["mu"][m] + _lora_apply(p["lora"][m], xx))
                for m in RWKV6TimeMix.MIX_KEYS}

    @staticmethod
    def _project(p, x, x_prev, cfg):
        B, T, D = x.shape
        hd = cfg.rwkv_head_dim
        H = D // hd
        m = RWKV6TimeMix._mix(p, x, x_prev)
        r = Dense.apply(p["wr"], m["r"]).reshape(B, T, H, hd)
        k = Dense.apply(p["wk"], m["k"]).reshape(B, T, H, hd)
        v = Dense.apply(p["wv"], m["v"]).reshape(B, T, H, hd)
        g = F.silu(Dense.apply(p["wg"], m["g"]))
        w = torch.exp(-torch.exp(
            (p["w0"] + _lora_apply(p["w_lora"], m["w"])).float()))
        w = w.reshape(B, T, H, hd).to(x.dtype)
        return r, k, v, w, g

    @staticmethod
    def _finish(p, y, g, B, T, D):
        y = LayerNorm.apply(p["ln_out"], y.reshape(B, T, D))
        return Dense.apply(p["wo"], y * g)

    @staticmethod
    def _wkv_scan(r, k, v, w, u, state0, every_state: bool = True):
        """The plain route: r, k, v, w (B, T, H, hd); state0 (B, H, hd, hd)
        in the working dtype. Returns y (B, T, H, hd) and the state after
        every step (B, T, H, hd, hd), or with ``every_state=False`` only
        the state after the last step."""
        S, ys, Ss = state0, [], []
        for t in range(r.shape[1]):
            S, y = _wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
            ys.append(y)
            if every_state:
                Ss.append(S)
        return torch.stack(ys, dim=1), (torch.stack(Ss, dim=1)
                                        if every_state else S)

    @staticmethod
    def _wkv_scan_chunked(r, k, v, w, u, state0):
        """The plain route over long sequences: chunks of ``SCAN_CHUNK``
        steps, each under ``torch.utils.checkpoint``, so a backward keeps
        only the chunk-boundary states (the reference's treatment)."""
        T = r.shape[1]
        ck = RWKV6TimeMix.SCAN_CHUNK
        while T % ck:
            ck //= 2

        def chunk(S, r_c, k_c, v_c, w_c):
            return RWKV6TimeMix._wkv_scan(r_c, k_c, v_c, w_c, u, S,
                                          every_state=False)

        S, ys = state0, []
        for c0 in range(0, T, ck):
            sl = slice(c0, c0 + ck)
            y, S = checkpoint(chunk, S, r[:, sl], k[:, sl], v[:, sl],
                              w[:, sl], use_reentrant=False)
            ys.append(y)
        return torch.cat(ys, dim=1)

    @staticmethod
    def full(p, x, cfg, use_kernel: bool = True):
        """x: (B, T, D) -> (B, T, D) from the zero state. With
        ``use_kernel``, CUDA tensors run the WKV kernel's zero-state form;
        the kernel has no backward yet, so a call that needs a gradient
        raises. Otherwise, and always on the CPU, the plain route
        (chunked from 256 positions)."""
        B, T, D = x.shape
        r, k, v, w, g = RWKV6TimeMix._project(p, x, _shift(x), cfg)
        if use_kernel and x.device.type == "cuda":
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (r, k, v, w, p["u"])):
                raise NotImplementedError(
                    "the WKV kernel has no backward yet: training RWKV-6 on "
                    "the kernel route waits for ROADMAP.md §1 item 15")
            y = rwkv_wkv(r, k, v, w, p["u"])
        else:
            S0 = torch.zeros((B, D // cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim), dtype=x.dtype,
                             device=x.device)
            if T >= 256:
                y = RWKV6TimeMix._wkv_scan_chunked(r, k, v, w, p["u"], S0)
            else:
                y, _ = RWKV6TimeMix._wkv_scan(r, k, v, w, p["u"], S0)
        return RWKV6TimeMix._finish(p, y, g, B, T, D)

    @staticmethod
    def init_state(cfg, batch: int, dtype=torch.float32, device=None):
        """The zero state: ``x_last`` in ``dtype``, ``S`` in float32."""
        D, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"x_last": torch.zeros((batch, D), dtype=dtype, device=device),
                "S": torch.zeros((batch, D // hd, hd, hd),
                                 dtype=torch.float32, device=device)}

    @staticmethod
    def window(p, x, cfg, state, use_kernel: bool = False,
               last_state_only: bool = False):
        """x: (B, W, D); ``state`` carries (x_last, S) from the accepted
        prefix. Returns (y, states): the state after every position, with
        leading (B, W) axes, or with ``last_state_only`` the state after the
        last position. ``use_kernel`` runs the recurrence through the WKV
        op. States ``S`` come back in float32 on both routes."""
        B, W, D = x.shape
        r, k, v, w, g = RWKV6TimeMix._project(
            p, x, _shift(x, state["x_last"]), cfg)
        S0 = state["S"]
        if use_kernel:
            y, Ss = rwkv_wkv(r, k, v, w, p["u"], S0.float(),
                             "last" if last_state_only else "all")
        else:
            y, Ss = RWKV6TimeMix._wkv_scan(r, k, v, w, p["u"],
                                           S0.to(x.dtype),
                                           every_state=not last_state_only)
            Ss = Ss.float()
        states = {"x_last": x[:, -1] if last_state_only else x, "S": Ss}
        return RWKV6TimeMix._finish(p, y, g, B, W, D), states

    @staticmethod
    def advance_state(p, x, cfg, state, accept, use_kernel: bool = False):
        """The two-pass memory mode: the state after the first ``accept``
        (B,) tokens of the window ``x`` (B, W, D), every update frozen from
        position ``accept`` on, with no per-position stack. It follows the
        route of ``window``: without ``use_kernel`` the plain route's
        update in the model's dtype from ``S`` rounded on entry, with it
        the WKV op's update in float32 (its plain version's arithmetic: on
        the CPU bitwise that route's state, on the card within the
        kernel's rounding). ``S`` comes back in float32."""
        _, k, v, w, _ = RWKV6TimeMix._project(
            p, x, _shift(x, state["x_last"]), cfg)
        if use_kernel:
            k, v, w = k.float(), v.float(), w.float()
            S = state["S"].float()
        else:
            S = state["S"].to(x.dtype)
        for t in range(x.shape[1]):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            live = (t < accept)[:, None, None, None]
            S = torch.where(live, w[:, t, :, :, None] * S + kv, S)
        return {"x_last": _at(x, accept), "S": S.float()}


class RWKV6ChannelMix:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        D, F_ = cfg.d_model, cfg.d_ff
        kw = dict(use_bias=False, dtype=dtype, device=device)
        return {
            "mu_k": 0.5 * torch.ones((D,), dtype=dtype, device=device),
            "mu_r": 0.5 * torch.ones((D,), dtype=dtype, device=device),
            "wk": Dense.init(gen, D, F_, **kw),
            "wv": Dense.init(gen, F_, D, **kw),
            "wr": Dense.init(gen, D, D, **kw),
        }

    @staticmethod
    def _apply(p, x, x_prev):
        dx = x_prev - x
        xk = x + dx * p["mu_k"]
        xr = x + dx * p["mu_r"]
        k = torch.square(torch.relu(Dense.apply(p["wk"], xk)))
        return torch.sigmoid(Dense.apply(p["wr"], xr)) * Dense.apply(p["wv"],
                                                                    k)

    @staticmethod
    def full(p, x, cfg):
        return RWKV6ChannelMix._apply(p, x, _shift(x))

    @staticmethod
    def init_state(cfg, batch: int, dtype=torch.float32, device=None):
        return {"x_last": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                      device=device)}

    @staticmethod
    def window(p, x, cfg, state, last_state_only: bool = False):
        y = RWKV6ChannelMix._apply(p, x, _shift(x, state["x_last"]))
        return y, {"x_last": x[:, -1] if last_state_only else x}

    @staticmethod
    def advance_state(p, x, cfg, state, accept):
        """The token-shift state after the first ``accept`` (B,) tokens."""
        return {"x_last": _at(x, accept)}


# ---------------------------------------------------------------------------
# Mamba-1 (Jamba's SSM layer)
# ---------------------------------------------------------------------------

def _softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` (torch's
    ``F.softplus`` turns linear past a threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba:
    """Mamba-1's selective SSM: ``in_proj`` to (u, z), a causal depthwise
    conv of width ``D_CONV`` over u, the input-dependent discretization
    (dt, B, C) and the float32 selective scan, gated by ``silu(z)``, then
    ``out_proj``. d_inner is ``2 * d_model``."""

    D_CONV = 4
    # the long-sequence scan's chunk (the reference's §Perf A1): a backward
    # keeps only the states at chunk boundaries
    SCAN_CHUNK = 64

    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        D = cfg.d_model
        DI = 2 * D
        N = cfg.ssm_state
        dt_rank = max(1, D // 16)
        kw = dict(dtype=dtype, device=device)
        A = torch.arange(1, N + 1, dtype=torch.float32,
                         device=device)[None].repeat(DI, 1)
        return {
            "in_proj": Dense.init(gen, D, 2 * DI, use_bias=False, **kw),
            "conv_w": _normal(gen, (Mamba.D_CONV, DI), dtype, device, 0.1),
            "conv_b": torch.zeros((DI,), **kw),
            "x_proj": Dense.init(gen, DI, dt_rank + 2 * N, use_bias=False,
                                 **kw),
            "dt_proj": Dense.init(gen, dt_rank, DI, **kw),
            "A_log": torch.log(A).to(dtype),
            "D": torch.ones((DI,), **kw),
            "out_proj": Dense.init(gen, DI, D, use_bias=False, **kw),
        }

    @staticmethod
    def _conv(p, u, conv_state):
        """Causal depthwise conv. u: (B, T, DI); conv_state (B, D_CONV - 1,
        DI) holds the last inputs of the accepted prefix. Returns
        (silu(conv), the last D_CONV - 1 inputs, ``ext`` = [conv_state, u]),
        the taps summed in the reference's order (Python's ``sum`` from
        0, then the bias)."""
        ext = torch.cat([conv_state.to(u.dtype), u], dim=1)
        T = u.shape[1]
        taps = [ext[:, t:t + T] * p["conv_w"][t] for t in range(Mamba.D_CONV)]
        y = sum(taps) + p["conv_b"]
        return F.silu(y), ext[:, -(Mamba.D_CONV - 1):], ext

    @staticmethod
    def _dt_b_c(p, u, cfg):
        """The discretization's inputs from the conv output u (B, T, DI):
        dt (B, T, DI), B and C (B, T, N), all float32, and A = -exp(A_log)
        (DI, N) in float32."""
        N = cfg.ssm_state
        R = p["dt_proj"]["w"].shape[0]
        xdbc = Dense.apply(p["x_proj"], u)
        dt = _softplus(Dense.apply(p["dt_proj"], xdbc[..., :R]).float())
        Bm = xdbc[..., R:R + N].float()
        Cm = xdbc[..., R + N:].float()
        A = -torch.exp(p["A_log"].float())
        return dt, Bm, Cm, A

    @staticmethod
    def _discretize(dt, Bm, u, A):
        """exp(dt A) and dt B u, (B, T, DI, N) float32, for every step at
        once: elementwise, so each step's values are those of the
        reference's per-step products."""
        dA = torch.exp(dt[..., None] * A)
        dBu = dt[..., None] * Bm[:, :, None, :] * u[..., None]
        return dA, dBu

    @staticmethod
    def _scan(dA, dBu, Cm, h, every_state: bool = True):
        """The recurrence h_t = dA_t h_{t-1} + dBu_t, y_t = sum_n h_t C_t,
        one step at a time from h (B, DI, N), all in float32. Returns y
        (B, T, DI) and the state after every step (B, T, DI, N), or with
        ``every_state=False`` the state after the last step."""
        ys, hs = [], []
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBu[:, t]
            ys.append((h * Cm[:, t, None, :]).sum(-1))
            if every_state:
                hs.append(h)
        return torch.stack(ys, dim=1), (torch.stack(hs, dim=1)
                                        if every_state else h)

    @staticmethod
    def _ssm_scan(p, u, cfg, h0, every_state: bool = True):
        """The selective scan over u (B, T, DI) from h0 (B, DI, N). Returns
        y in u's dtype (from the float32 ``y + u D``) and the float32
        state(s) of ``_scan``."""
        dt, Bm, Cm, A = Mamba._dt_b_c(p, u, cfg)
        u32 = u.float()
        dA, dBu = Mamba._discretize(dt, Bm, u32, A)
        y, hs = Mamba._scan(dA, dBu, Cm, h0.float(), every_state)
        y = y + u32 * p["D"].float()
        return y.to(u.dtype), hs

    @staticmethod
    def _ssm_scan_chunked(p, u, cfg, h0):
        """The scan over long sequences: chunks of ``SCAN_CHUNK`` steps
        (halved until it divides T), each under ``torch.utils.checkpoint``,
        so no (B, T, DI, N) tensor exists and a backward keeps only the
        states at chunk boundaries. Inputs and outputs are in u's dtype,
        the carry in float32 (the reference's layout). Returns y."""
        T = u.shape[1]
        dt, Bm, Cm, A = Mamba._dt_b_c(p, u, cfg)
        ck = Mamba.SCAN_CHUNK
        while T % ck:
            ck //= 2
        io = u.dtype
        dt, Bm, Cm = (a.to(io) for a in (dt, Bm, Cm))

        def chunk(h, dt_c, B_c, C_c, u_c, A):
            dt_c, B_c, C_c, u_c = (a.float() for a in (dt_c, B_c, C_c, u_c))
            dA, dBu = Mamba._discretize(dt_c, B_c, u_c, A)
            y, h = Mamba._scan(dA, dBu, C_c, h, every_state=False)
            return y.to(io), h

        h, ys = h0.float(), []
        for c0 in range(0, T, ck):
            sl = slice(c0, c0 + ck)
            y, h = checkpoint(chunk, h, dt[:, sl], Bm[:, sl], Cm[:, sl],
                              u[:, sl], A, use_reentrant=False)
            ys.append(y)
        y = torch.cat(ys, dim=1).float() + u.float() * p["D"].float()
        return y.to(io)

    @staticmethod
    def _run(p, x, cfg, conv_state, h0, every_state: bool = True):
        xz = Dense.apply(p["in_proj"], x)
        u, z = xz.chunk(2, dim=-1)
        u, new_conv, ext = Mamba._conv(p, u, conv_state)
        y, hs = Mamba._ssm_scan(p, u, cfg, h0, every_state)
        y = y * F.silu(z)
        return Dense.apply(p["out_proj"], y), new_conv, hs, ext

    @staticmethod
    def full(p, x, cfg):
        """x: (B, T, D) -> (B, T, D) from the zero state; the chunked,
        checkpointed scan from T = 256."""
        B, T, D = x.shape
        conv0 = torch.zeros((B, Mamba.D_CONV - 1, 2 * D), dtype=x.dtype,
                            device=x.device)
        h0 = torch.zeros((B, 2 * D, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        if T >= 256:
            xz = Dense.apply(p["in_proj"], x)
            u, z = xz.chunk(2, dim=-1)
            u = Mamba._conv(p, u, conv0)[0]
            y = Mamba._ssm_scan_chunked(p, u, cfg, h0)
            return Dense.apply(p["out_proj"], y * F.silu(z))
        y, _, _, _ = Mamba._run(p, x, cfg, conv0, h0, every_state=False)
        return y

    @staticmethod
    def init_state(cfg, batch: int, dtype=torch.float32, device=None):
        """The zero state: ``conv`` (B, D_CONV - 1, DI) in ``dtype``, ``h``
        (B, DI, N) in float32."""
        DI = 2 * cfg.d_model
        return {"conv": torch.zeros((batch, Mamba.D_CONV - 1, DI),
                                    dtype=dtype, device=device),
                "h": torch.zeros((batch, DI, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}

    @staticmethod
    def window(p, x, cfg, state, last_state_only: bool = False):
        """x: (B, W, D) from the carried ``state``. Returns (y, states): the
        conv inputs (B, W, D_CONV - 1, DI) and float32 SSM states (B, W,
        DI, N) after every position, so the engine can rewind to its
        accept point, or with ``last_state_only`` the state after the last
        position."""
        W = x.shape[1]
        y, new_conv, hs, ext = Mamba._run(p, x, cfg, state["conv"],
                                          state["h"],
                                          every_state=not last_state_only)
        if last_state_only:
            return y, {"conv": new_conv, "h": hs}
        # after window position t the last D_CONV - 1 inputs end at t:
        # ext positions t + 1 .. t + D_CONV - 1
        idx = (torch.arange(W, device=x.device)[:, None] + 1
               + torch.arange(Mamba.D_CONV - 1, device=x.device)[None, :])
        return y, {"conv": ext[:, idx], "h": hs}

    @staticmethod
    def advance_state(p, x, cfg, state, accept):
        """The two-pass memory mode: the window recomputed, every update
        masked off from position ``accept`` (B,) on, and only the state
        after the first ``accept`` tokens returned (no (B, W, DI, N)
        stack). Each live step is ``window``'s own arithmetic, so the
        state equals the per-position one at ``accept - 1`` bitwise (the
        carried state where ``accept`` is 0)."""
        xz = Dense.apply(p["in_proj"], x)
        u, _ = xz.chunk(2, dim=-1)
        u, _, ext = Mamba._conv(p, u, state["conv"])
        dt, Bm, _, A = Mamba._dt_b_c(p, u, cfg)
        dA, dBu = Mamba._discretize(dt, Bm, u.float(), A)
        h = state["h"].float()
        for t in range(x.shape[1]):
            live = (t < accept)[:, None, None]
            h = torch.where(live, dA[:, t] * h + dBu[:, t], h)
        # the conv inputs after ``accept`` tokens: ext positions accept ..
        # accept + D_CONV - 2
        idx = (accept.long()[:, None]
               + torch.arange(Mamba.D_CONV - 1, device=x.device)[None, :])
        conv = torch.gather(ext, 1, idx[:, :, None].expand(
            -1, -1, ext.shape[-1]))
        return {"conv": conv, "h": h}
