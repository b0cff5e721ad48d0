"""Numpy-only scan generators (ray-cast LiDAR)."""
