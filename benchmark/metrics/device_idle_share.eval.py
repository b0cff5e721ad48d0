"""1 - kernel busy time of the traced steps over the wall of the same steps run untraced (%): eval."""
from benchmark.lib import readers


def read(rec):
    return readers.device_idle_share(rec, "eval")
