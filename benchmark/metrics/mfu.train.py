"""Model FLOPs of the traced steps over (the wall of the same steps run untraced x the bf16 peak) (%): train."""
from benchmark.lib import readers


def read(rec):
    return readers.mfu(rec, "train")
