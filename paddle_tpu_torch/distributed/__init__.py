"""Distributed training of the port: only ``fleet.recompute`` so far."""
