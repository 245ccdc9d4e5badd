"""Benchmarks of the port on the card (device times only)."""
