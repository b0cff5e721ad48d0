"""Sparse containers, batch voxelization and the geometry pass."""
