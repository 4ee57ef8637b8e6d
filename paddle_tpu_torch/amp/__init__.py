"""AMP of the port: O2 ``decorate``."""
from .auto_cast import amp_decorate, decorate

__all__ = ["decorate", "amp_decorate"]
