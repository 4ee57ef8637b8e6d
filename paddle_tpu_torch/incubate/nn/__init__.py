"""Fused transformer layers."""
from .fused_transformer import (FusedMultiTransformer, PagedKV,
                                qkv_split_rope_fused, rope_table)

__all__ = ["FusedMultiTransformer", "PagedKV", "qkv_split_rope_fused",
           "rope_table"]
