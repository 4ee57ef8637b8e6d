"""Profiling and metrics (the counters the engines write)."""
