"""Expert-parallel MoE over ``torch.distributed``: the port of the
reference's ``sharding/moe_shard.py``, its ``shard_map`` bodies run by one
process per rank, each on its own slice of the experts.

* ``_moe_ep_only`` — the serving layout (the reference's ``ep_only``, and
  what its serving computes with E-sharded experts): tokens whole on every
  rank, each rank routing them all (the router is replicated) and
  dispatching only the entries bound for its ``E / M`` local experts, then
  one ``all_reduce`` of the float32 contributions over the expert axis,
  rounded once to the activations' dtype, as ``MoE.apply`` rounds.
* ``moe_apply_sharded`` — the training layout: tokens split over "data",
  experts over "model" and FSDP-split over "data" on their dim 1. Each
  (data, model) rank routes its own tokens, gathers its experts' weights
  over "data", computes its local experts and ``all_reduce``s over
  "model"; the load-balancing loss is averaged over "data". Its forward
  only: the backward is ROADMAP item 20c.

The token-choice semantics (top-k with ties in index order, capacity,
the stable sort of the dispatch, no-drop at ``capacity_factor=None``) are
``MoE.apply``'s; only the split of the expert products and the order of
the final sum differ. A shared expert runs on whole weights after the
expert sum, as the reference runs it outside its ``shard_map``.
"""
from __future__ import annotations

import torch

from repro_torch.models.moe import MoE, _glu_hidden, _mlp_apply
from repro_torch.sharding.tensor_parallel import placement_of, placements_of


def _moe_ep_only(p, x, cfg, capacity_factor, axis):
    """The serving layout over ``axis`` (the model axis): see the module
    docstring. ``p["experts"]`` holds this rank's ``E / M`` experts."""
    B, T, D = x.shape
    E = cfg.n_experts
    if E % axis.size:
        raise ValueError(f"{E} experts over {axis.size} ranks")
    E_loc = E // axis.size
    xf = x.reshape(B * T, D)
    ids, w, probs = MoE.route(p, xf, cfg)
    aux = MoE.load_balance_loss(probs, ids, cfg)
    C = MoE.capacity(B * T, cfg, capacity_factor)
    acc = MoE.expert_sum(p["experts"], xf, ids, w, C, axis.rank * E_loc,
                         E_loc, cfg)
    y = axis.all_reduce(acc).to(x.dtype)
    if "shared" in p:
        y = y + _mlp_apply(p["shared"], xf, cfg.mlp_kind)
    return y.reshape(B, T, D), aux


def moe_apply_sharded(p, x, cfg, capacity_factor, model, data):
    """The training layout's forward: ``x`` (b, T, D) this data rank's
    tokens, ``p["experts"]`` leaves (E / M, D / Dd, F) and (E / M, F / Dd,
    D) split over ``model`` on E and over ``data`` on dim 1, the router
    and any shared expert whole. Returns (y (b, T, D), aux averaged over
    ``data``)."""
    b, T, D = x.shape
    E = cfg.n_experts
    E_loc = E // model.size
    pe = {k: data.all_gather(v, dim=1) for k, v in p["experts"].items()}
    xf = x.reshape(b * T, D)
    ids, w, probs = MoE.route(p, xf, cfg)
    aux = data.all_reduce(MoE.load_balance_loss(probs, ids, cfg)) / data.size
    C = MoE.capacity(b * T, cfg, capacity_factor)
    acc = MoE.expert_sum(pe, xf, ids, w, C, model.rank * E_loc, E_loc, cfg)
    y = model.all_reduce(acc).to(x.dtype)
    if "shared" in p:
        y = y + _mlp_apply(p["shared"], xf, cfg.mlp_kind)
    return y.reshape(b, T, D), aux


def moe_apply_placed(p, x, cfg, capacity_factor):
    """``MoE.apply`` of placed experts: the training layout where they are
    also split over "data", else the serving one."""
    pls = placements_of(p["experts"]["up"])
    if "data" in pls:
        return moe_apply_sharded(p, x, cfg, capacity_factor,
                                 pls["model"].axis, pls["data"].axis)
    return _moe_ep_only(p, x, cfg, capacity_factor,
                        placement_of(p["experts"]["up"]).axis)
