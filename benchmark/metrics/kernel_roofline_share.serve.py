"""Summed bound of the program's CUDA kernel calls over their device time (%): serve."""
from benchmark.lib import readers


def read(rec):
    return readers.kernel_roofline_share(rec, "serve")
