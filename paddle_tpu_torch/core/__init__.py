"""Core runtime pieces of the port: dtypes, places and device
resolution, the tensor (``to_tensor``), seeded generators and the flags
registry."""
