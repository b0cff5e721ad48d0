"""Metrics and the JAX-to-torch parameter converter."""
