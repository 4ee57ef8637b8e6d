"""Incubating APIs of the port (the fused serving transformer)."""
