"""FFN blocks: the dense MLP (``_mlp_init`` / ``_mlp_apply``, swiglu, geglu
and gelu) and the mixture-of-experts layer (``MoE``) with top-k routing.

``MoE.apply`` keeps the reference's fixed-shape formulation: a sort-based
dispatch into per-expert capacity buffers (E, C, D), batched expert
products, and a weighted combine back to the tokens. Every shape follows
from the input's shape and the capacity factor, never from the routing,
so the layer runs with no host sync. Three choices hold it to the
reference's integer results and make it deterministic on the card:

* top-k is a stable descending sort (``jax.lax.top_k`` takes the lower
  index on a tie; ``torch.topk`` promises no order);
* the dispatch is a gather: slot (e, c) takes expert e's c-th entry in the
  stably sorted order, which is where the reference's scatter puts it, and
  a dropped entry is simply never gathered;
* the combine gathers each token's k contributions through the inverse of
  the sort's permutation and adds them in float32 in ascending expert
  order, rounding once to the activations' dtype: the order and rounding
  in which the reference's scatter-add applies them on the CPU. No atomic
  add, so two runs give the same bits.

Covers DeepSeek-V3 (1 shared + 256 routed, top-8, sigmoid scores and
normalized weights) and DBRX (16 routed, top-4, softmax).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.core import Dense, _normal
from repro_torch.sharding import tensor_parallel as tp


def _mlp_init(gen, d_model, d_ff, kind, dtype, device=None):
    kw = dict(use_bias=False, dtype=dtype, device=device)
    p = {"up": Dense.init(gen, d_model, d_ff, **kw),
         "down": Dense.init(gen, d_ff, d_model, **kw)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = Dense.init(gen, d_model, d_ff, **kw)
    return p


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _glu_hidden(up, gate, kind):
    """The hidden activations of a gated (swiglu, geglu) or plain (gelu)
    MLP from its up and gate products."""
    if kind == "swiglu":
        return up * F.silu(gate)
    if kind == "geglu":
        return up * _gelu(gate)
    return _gelu(up)


def _mlp_apply(p, x, kind):
    # a column-parallel up and gate keep their columns for the
    # row-parallel down (``sharding/tensor_parallel.py``)
    gate = (Dense.apply(p["gate"], x, keep_sharded=True) if "gate" in p
            else None)
    return Dense.apply(p["down"], _glu_hidden(
        Dense.apply(p["up"], x, keep_sharded=True), gate, kind))


def _stacked_normal(gen, E, shape, dtype, device, std):
    """(E, *shape) normal values of ``std``, drawn one expert at a time so
    that a full-width leaf needs no float32 copy of itself."""
    out = torch.empty((E, *shape), dtype=dtype, device=device)
    if out.device.type != "meta":
        for e in range(E):
            out[e] = _normal(gen, shape, dtype, device, std)
    return out


def top_k(scores, k: int):
    """(values, indices) of the k largest scores of each row, largest
    first; equal scores in index order, as ``jax.lax.top_k`` gives them
    (``torch.topk`` promises no order among ties, and on the card not even
    the same set)."""
    w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k]


class MoE:
    @staticmethod
    def init(gen, cfg, dtype=torch.float32, device=None):
        """The reference's tree: ``router`` (Dense D -> E), ``experts``
        with stacked ``up`` and ``gate`` (E, D, F) and ``down`` (E, F, D)
        at std 0.02, and with shared experts ``shared``, a dense MLP of
        width ``moe_d_ff * n_shared_experts``."""
        E = cfg.n_experts
        D, Fw = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        p = {"router": Dense.init(gen, D, E, use_bias=False, dtype=dtype,
                                  device=device)}
        experts = {"up": _stacked_normal(gen, E, (D, Fw), dtype, device, 0.02),
                   "down": _stacked_normal(gen, E, (Fw, D), dtype, device,
                                           0.02)}
        if cfg.mlp_kind in ("swiglu", "geglu"):
            experts["gate"] = _stacked_normal(gen, E, (D, Fw), dtype, device,
                                              0.02)
        p["experts"] = experts
        if cfg.n_shared_experts:
            p["shared"] = _mlp_init(gen, D, Fw * cfg.n_shared_experts,
                                    cfg.mlp_kind, dtype, device)
        return p

    @staticmethod
    def route(p, x_flat, cfg):
        """x_flat: (N, D). Returns (expert ids (N, k) int32, weights (N, k)
        float32, router probabilities (N, E) float32). The router product
        runs in the parameters' dtype."""
        logits = Dense.apply(p["router"], x_flat).float()        # (N, E)
        if cfg.router_score == "sigmoid":                        # DeepSeek-V3
            scores = torch.sigmoid(logits)
        else:
            scores = torch.softmax(logits, dim=-1)
        w, ids = top_k(scores, cfg.top_k)
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
        return ids.to(torch.int32), w, torch.softmax(logits, dim=-1)

    @staticmethod
    def load_balance_loss(probs, ids, cfg):
        """Switch-style aux loss: E * sum_e f_e * p_e / k."""
        E = cfg.n_experts
        # one_hot's range check reads the ids on the host: compare instead
        onehot = (ids.long()[..., None] == torch.arange(
            E, device=ids.device)).float()                      # (N, k, E)
        f = torch.mean(torch.sum(onehot, dim=1), dim=0)         # routed share
        pbar = torch.mean(probs, dim=0)                         # mean prob
        return E * torch.sum(f * pbar) / cfg.top_k

    @staticmethod
    def capacity(N: int, cfg, capacity_factor: float | None) -> int:
        """Slots per expert: N * k without a factor (no token can drop),
        else max(1, int(N * k * cf) // E), in the reference's arithmetic."""
        if capacity_factor is None:
            return N * cfg.top_k
        return max(1, int(N * cfg.top_k * capacity_factor) // cfg.n_experts)

    @staticmethod
    def plan(ids, C: int):
        """The dispatch of ids (N, k): the N * k (token, expert) entries
        sorted by expert, stably, so each expert's entries keep token
        order. Returns (order, the sorted ids, each sorted entry's position
        in its expert's segment, keep = position < C)."""
        ids_flat = ids.reshape(-1)
        order = torch.argsort(ids_flat, stable=True)
        ids_s = ids_flat[order]
        first = torch.searchsorted(ids_s, ids_s, side="left")
        pos = torch.arange(ids_flat.numel(), device=ids.device) - first
        return order, ids_s, pos, pos < C

    @staticmethod
    def expert_sum(pe, xf, ids, w, C: int, e0: int, E_loc: int, cfg):
        """The float32 sum (N, D) of each token's contributions from experts
        ``[e0, e0 + E_loc)``, whose weights ``pe`` holds ((E_loc, ...)),
        added in ascending expert order. ``apply`` takes every expert; an
        expert-parallel rank (``sharding/moe_shard.py``) takes its own."""
        N, _ = xf.shape
        k = cfg.top_k
        dev = xf.device
        order, ids_s, pos, keep = MoE.plan(ids, C)

        # dispatch (E_loc, C, D): slot (e, c) holds expert e0 + e's c-th entry
        experts = torch.arange(e0, e0 + E_loc, dtype=ids_s.dtype, device=dev)
        start = torch.searchsorted(ids_s, experts, side="left")
        count = torch.searchsorted(ids_s, experts, side="right") - start
        slot = torch.arange(C, device=dev)
        src = (start[:, None] + slot).clamp(max=N * k - 1)     # (E_loc, C)
        buf = xf[order[src] // k].masked_fill_(
            ~(slot < count[:, None])[..., None], 0)

        # expert MLPs, batched over the range
        up = torch.bmm(buf, pe["up"])
        gate = torch.bmm(buf, pe["gate"]) if "gate" in pe else None
        out = torch.bmm(_glu_hidden(up, gate, cfg.mlp_kind), pe["down"])

        # combine: each token's k entries, found through the inverse
        # permutation, in ascending expert order (their sorted order); an
        # entry bound outside the range adds zero
        inv = torch.empty_like(order)
        inv[order] = torch.arange(N * k, device=dev)
        sp = torch.sort(inv.reshape(N, k), dim=-1).values          # (N, k)
        eid = ids_s[sp].long() - e0
        mine = keep[sp] & (eid >= 0) & (eid < E_loc)
        got = out[eid.clamp(0, E_loc - 1), pos[sp].clamp(max=C - 1)]
        got = got.masked_fill_(~mine[..., None], 0)             # (N, k, D)
        w_tk = torch.where(mine, w.reshape(N * k)[order[sp]], 0.0)
        contrib = got.float() * w_tk[..., None]
        acc = contrib[:, 0]
        for j in range(1, k):
            acc = acc + contrib[:, j]
        return acc

    @staticmethod
    def apply(p, x, cfg, capacity_factor: float | None = 1.25):
        """x: (B, T, D) -> (y (B, T, D), aux loss, a float32 scalar).

        ``capacity_factor=None`` is no-drop (C = N * k): each token's output
        then depends on that token alone, which the verify window and
        predictive sampling's exactness need. A finite factor caps each
        expert at C slots, filled in token order; the entries past C are
        dropped (training's trade).

        Placed experts (``sharding/tensor_parallel.py``) take the
        expert-parallel path of ``sharding/moe_shard.py``, as the
        reference dispatches there under an active mesh: each rank routing
        its data rank's tokens and running its own experts, one
        all-reduce over the model axis; split over data alone (data D x
        model 1), each data rank on its own tokens at their local
        capacity, the load-balancing loss averaged over data."""
        if tp.placements_of(p["experts"]["up"]):
            from repro_torch.sharding.moe_shard import moe_apply_placed
            return moe_apply_placed(p, x, cfg, capacity_factor)
        B, T, D = x.shape
        xf = x.reshape(B * T, D)
        ids, w, probs = MoE.route(p, xf, cfg)
        aux = MoE.load_balance_loss(probs, ids, cfg)
        C = MoE.capacity(B * T, cfg, capacity_factor)
        y = MoE.expert_sum(p["experts"], xf, ids, w, C, 0, cfg.n_experts,
                           cfg).to(x.dtype)
        if "shared" in p:
            y = y + _mlp_apply(p["shared"], xf, cfg.mlp_kind)
        return y.reshape(B, T, D), aux
