"""Sharding: the logical-axis rules (``api``), the parameter, cache and
activation placements of the production meshes (``rules``), the model
axis's process group and its collectives (``collectives``), tensor-
parallel parameters (``tensor_parallel``) and expert parallelism
(``moe_shard``) — the port of the reference's ``sharding`` package, with
the collectives GSPMD inserts there written out."""
from repro_torch.sharding.api import (NamedSharding, Rules, constrain,
                                      current_rules, logical_sharding,
                                      use_rules)

__all__ = ["constrain", "use_rules", "current_rules", "logical_sharding",
           "Rules", "NamedSharding"]
