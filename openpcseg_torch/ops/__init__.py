"""Sparse compute ops: keys, kernel maps, convs and their Hopper kernels."""
