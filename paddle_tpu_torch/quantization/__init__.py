"""Quantization for serving (the port's subset).

Dynamic per-token activation quantization and the int8 x int8 product
with one dequant (``dynamic``), used by A8W8 serving. Weight-only int8
quantization of a transformer stack is
``FusedMultiTransformer.quantize_weight_only_int8``. Post-training
quantization (observers, ``QuantedLinear``) comes with a later slice of
the port.
"""
from __future__ import annotations

from .dynamic import (ACT_SCALE_EPS, absmax_scale, dynamic_act_quant,
                      int8_dot_dequant)

__all__ = ["ACT_SCALE_EPS", "absmax_scale", "dynamic_act_quant",
           "int8_dot_dequant"]
