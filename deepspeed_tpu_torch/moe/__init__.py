from .layer import MoE, Experts
from .sharded_moe import (capacity, gate, group_offsets, grouped_moe_ffn,
                          top1gating, top2gating, topkgating)

__all__ = ["MoE", "Experts", "capacity", "gate", "group_offsets",
           "grouped_moe_ffn", "top1gating", "top2gating", "topkgating"]
