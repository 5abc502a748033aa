"""Attention-free mixer: RWKV-6 ("Finch") time and channel mix.

Both support:
* ``full``   — scan from the zero state over the whole sequence (apply);
* ``window`` — scan a W-token verify window from a carried state snapshot,
  returning the state after every position so the engine can adopt the one
  at its accept point (DESIGN.md §5: recurrent state is cumulative, so the
  engine snapshots at the last accepted position); with
  ``last_state_only`` only the state after the window's last position
  (prefill, which adopts exactly that one).

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
to the model's dtype, as in the reference. The reference's two-pass
``advance_state`` mode and Mamba are not ported yet (ROADMAP.md §1 item
15).
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
