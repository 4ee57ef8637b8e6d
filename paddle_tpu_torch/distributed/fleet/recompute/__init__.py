from .recompute import checkpoint_policies, recompute

__all__ = ["recompute", "checkpoint_policies"]
