"""AMP of the port: O1 ``auto_cast`` by the Paddle op lists, O2
``decorate``, dynamic loss scaling (``GradScaler``) and ``debugging``
(operator stats, the NaN/Inf checker)."""
from . import debugging
from .auto_cast import (amp_decorate, amp_guard, auto_cast, black_list,
                        decorate, get_amp_dtype, is_auto_cast_enabled,
                        white_list)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "AmpScaler", "debugging"]
