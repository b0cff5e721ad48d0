"""Device ms of the kernels that are not the program's own, per scan: eval."""
from benchmark.lib import readers


def read(rec):
    return readers.tail_device_ms_per_scan(rec, "eval")
