"""Scans whose per-point labels reached the host in the window, over its wall time."""
from benchmark.lib import readers


def read(rec):
    return readers.scans_per_s(rec, ("serve", "eval"))
