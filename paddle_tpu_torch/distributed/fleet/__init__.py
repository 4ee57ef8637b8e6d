"""``fleet`` of the port: only ``recompute`` so far."""
