"""Core runtime pieces of the port: device resolution, seeded
generators and the flags registry."""
