"""1 - kernel busy time of the traced steps over the wall of the same steps run untraced (%): train."""
from benchmark.lib import readers


def read(rec):
    return readers.device_idle_share(rec, "train")
