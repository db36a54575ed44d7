"""Distribution layer: logical-axis rules on a torch ``DeviceMesh``
(``repro_torch.dist.sharding`` has the contract); everything public is
re-exported here."""

from repro_torch.dist.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                       AxisRules, Layout, axes_to_placements,
                                       current_rules, distribute_tree,
                                       full_tree, grad_placements, is_axes,
                                       layout_of, make_mesh,
                                       map_axes, param_placements,
                                       placed_like, replicated_like,
                                       rules_placements, shard,
                                       use_rules, with_overrides)

__all__ = [
    "AxisRules",
    "Layout",
    "MULTI_POD_RULES",
    "SINGLE_POD_RULES",
    "axes_to_placements",
    "current_rules",
    "distribute_tree",
    "full_tree",
    "grad_placements",
    "is_axes",
    "layout_of",
    "make_mesh",
    "map_axes",
    "param_placements",
    "placed_like",
    "replicated_like",
    "rules_placements",
    "shard",
    "use_rules",
    "with_overrides",
]
