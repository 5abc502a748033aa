"""Expert-parallel MoE over ``torch.distributed``: the port of the
reference's ``sharding/moe_shard.py``, its ``shard_map`` bodies run by one
process per rank, each on its own slice of the experts.

* ``moe_apply_sharded`` — the training layout: tokens split over "data",
  experts over "model" on E and FSDP-split over "data" on their dim 1
  (either axis may have one rank). Each (data, model) rank routes its own
  data rank's tokens with the capacity of that local count, gathers its
  experts' weights over "data" (``collectives.fsdp_gather``: the
  gradients are reduce-scattered), computes its local experts and sums
  the float32 contributions over "model" (``reduce_from``), rounded once
  to the activations' dtype, as ``MoE.apply`` rounds. Every model rank
  computes the routing and the load-balancing loss alike, but the expert
  sum only for its own experts, so ``copy_to`` goes on the inputs of that
  sum, the dispatched tokens and their combine weights, and not on ``x``
  before routing or on the router: either would count the routing's part
  of the gradient once per model rank. The loss is valued as the mean over
  "data" (the reference's ``pmean``) and differentiated as this data
  rank's own: the trainer scales each rank's loss by 1 / D and sums the
  gradients over data, so each rank's loss reaches the router once, as
  the mean does in the reference.
* ``_moe_ep_only`` — the serving layout (the reference's ``ep_only``, and
  what its serving computes with E-sharded experts), the training layout
  at one data rank: tokens whole on every rank, each rank routing them all
  and dispatching only the entries bound for its ``E / M`` local experts.
* ``no_tp`` (experts split over the joint axis): the reference's
  ``shard_map`` takes each data rank's tokens whole, so the model ranks'
  rows are gathered (``fsdp_gather`` over "model" on the batch dim), the
  layer runs on whole experts, and each rank keeps its own rows.

The token-choice semantics (top-k with ties in index order, capacity,
the stable sort of the dispatch, no-drop at ``capacity_factor=None``) are
``MoE.apply``'s; only the split of the expert products and the order of
the final sum differ. A shared expert runs on its own placed weights after
the expert sum, as the reference runs it outside its ``shard_map``.
"""
from __future__ import annotations

from repro_torch.models.moe import MoE, _mlp_apply
from repro_torch.sharding.collectives import (JOINT, Axis, copy_to,
                                              fsdp_gather, reduce_from)
from repro_torch.sharding.tensor_parallel import on_use, placements_of

# an axis of one rank: its collectives are the identity
_SOLO = Axis("solo", 0, 1)


def moe_apply_sharded(p, x, cfg, capacity_factor, model, data):
    """The training layout: ``x`` (b, T, D) this data rank's tokens,
    ``p["experts"]`` leaves (E / M, D / Dd, F) and (E / M, F / Dd, D)
    split over ``model`` on E and over ``data`` on dim 1 (either of one
    rank), the router and any shared expert as placed. Returns (y (b, T,
    D), aux: valued as the mean over ``data``, differentiated as this
    rank's own)."""
    b, T, D = x.shape
    E = cfg.n_experts
    if E % model.size:
        raise ValueError(f"{E} experts over {model.size} ranks")
    E_loc = E // model.size
    pe = {k: on_use(v) for k, v in p["experts"].items()}
    xf = x.reshape(b * T, D)
    ids, w, probs = MoE.route(p, xf, cfg)
    aux = MoE.load_balance_loss(probs, ids, cfg)
    if data.size > 1:
        mean = data.all_reduce(aux.detach().clone()) / data.size
        aux = mean + (aux - aux.detach())
    C = MoE.capacity(b * T, cfg, capacity_factor)
    acc = MoE.expert_sum(pe, copy_to(xf, model), ids, copy_to(w, model), C,
                         model.rank * E_loc, E_loc, cfg)
    y = reduce_from(acc, model).to(x.dtype)
    if "shared" in p:
        y = y + _mlp_apply(p["shared"], xf, cfg.mlp_kind)
    return y.reshape(b, T, D), aux


def _moe_ep_only(p, x, cfg, capacity_factor, axis):
    """The serving layout over ``axis`` (the model axis): see the module
    docstring. ``p["experts"]`` holds this rank's ``E / M`` experts."""
    return moe_apply_sharded(p, x, cfg, capacity_factor, axis, _SOLO)


def _moe_no_tp(p, x, cfg, capacity_factor, joint):
    """``no_tp``: this rank's rows ``x`` (b, T, D) among its data rank's
    (gathered over "model"), the layer on whole experts, this rank's rows
    of its output kept."""
    data, model = joint.parts
    y, aux = moe_apply_sharded(p, fsdp_gather(x, model, 0), cfg,
                               capacity_factor, _SOLO, data)
    b = x.shape[0]
    return y.narrow(0, model.rank * b, b), aux


def moe_apply_placed(p, x, cfg, capacity_factor):
    """``MoE.apply`` of placed experts, by their placement: see the module
    docstring."""
    pls = placements_of(p["experts"]["up"])
    if JOINT in pls:
        return _moe_no_tp(p, x, cfg, capacity_factor, pls[JOINT].axis)
    return moe_apply_sharded(
        p, x, cfg, capacity_factor,
        pls["model"].axis if "model" in pls else _SOLO,
        pls["data"].axis if "data" in pls else _SOLO)
