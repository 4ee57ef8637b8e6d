"""Vision of the port: ``models`` (the ResNet family)."""
from . import models

__all__ = ["models"]
