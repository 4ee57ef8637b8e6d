"""Vision models of the port (counterpart of
``paddle_tpu/vision/models``): the ResNet family. The other models of
the JAX package come with a later slice (ROADMAP A12)."""
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, wide_resnet50_2, wide_resnet101_2)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2"]
