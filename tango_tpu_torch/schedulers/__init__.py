"""Noise schedulers of the port."""
