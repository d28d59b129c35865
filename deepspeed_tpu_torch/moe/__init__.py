from .sharded_moe import group_offsets, grouped_moe_ffn

__all__ = ["group_offsets", "grouped_moe_ffn"]
