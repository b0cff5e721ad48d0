"""95th percentile of the latency of every request of the window."""
from benchmark.lib import readers


def read(rec):
    return readers.percentile(rec.get("latencies_ms", []), 95.0)
