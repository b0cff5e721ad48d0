"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names them, ``benchmark/configs/<config>.json`` holds
the configuration as it is run, ``benchmark/traffic/<traffic>.json`` the
mix, whose ``driver`` names ``benchmark/drivers/<driver>.py``, and
``benchmark/limits/<workload>.json`` the limit of each number compared. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled window of its own;
each metric is read by ``benchmark/metrics/<metric>.py``. Both compare
what the timed path produced with the plain reference
(``benchmark/reference/``) once the window has closed, and print each
number compared beside its limit, on standard error and under
``checks``, the last key of the line.

The run exits with another code than 0, and prints no result, where the
card is missing or has fewer devices than the cell asks for, where the
program is not in this checkout, or where a module of JAX or of the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "openpcseg_tpu")
PROGRAM = "openpcseg_torch"


def find(files: Path, kind: str, name: str) -> Path:
    """``<files>/<kind>/<name>``, else the benchmark's own
    ``benchmark/<kind>/<name>``: the harness finds each piece by its name,
    and a test can put a piece of its own in front."""
    for base in (files, BENCH):
        if (base / kind / name).exists():
            return base / kind / name
    raise FileNotFoundError(f"no {kind}/{name} under {files} or {BENCH}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The metrics this cell reports: its end-to-end metrics with --trace
    0, its per-layer metrics with --trace 1."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in
                                 names else [])]


class Ctx:
    """What a driver gets: the cell's files, the device, the scan pool,
    and the harness's hooks around the window."""

    def __init__(self, args, bench, config, traffic, device, fault=None):
        self.args, self.bench = args, bench
        self.config, self.traffic = config, traffic
        self.device, self.fault = device, fault
        self.seed, self.trace = args.seed, bool(args.trace)
        self.setup_s = None
        self.memory_peak = 0
        self.pool = self.dump = None

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def phase(self, name: str) -> None:
        """Log the seconds since the process started at a phase's end."""
        self.log(f"[{time.perf_counter() - T_START:8.3f} s] {name}")

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        self.setup_s = time.perf_counter() - T_START

    def make_weights(self, batches):
        """The cell's weights; the peak of device memory starts after them,
        so the reference's pass that sets BN's statistics is not in it."""
        import torch

        from benchmark.lib import weights
        p = weights.for_cell(self.config, self.traffic, self.seed,
                             self.device, batches)
        self.free()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return p

    def feed(self, batches):
        from benchmark.lib.scans import Feed
        return Feed(batches, self.traffic.get("augment"), self.seed)

    def tensor(self, x):
        import torch
        return torch.as_tensor(x).to(self.device)

    def tensors(self, batch):
        return tuple(self.tensor(batch[k])
                     for k in ("xyz", "feats", "labels", "valid"))

    def read_memory(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def run_window(self, window, prime=None) -> dict:
        """The measured window (--seconds of steps), or with --trace 1 the
        profiled window of the mix's ``trace_steps`` steps, run once
        untraced just before (``plain_s``, the wall of the same steps
        without the profiler's host cost). `prime` readies the first
        step's input before each window opens."""
        if prime:
            prime()
        if not self.trace:
            t0 = time.perf_counter()
            steps = window(seconds=self.args.seconds)
            return dict(steps=steps, window_s=time.perf_counter() - t0)
        from benchmark.lib import trace
        n = self.traffic["trace_steps"]
        t0 = time.perf_counter()
        window(n_steps=n)
        plain_s = time.perf_counter() - t0
        if prime:
            prime()
        done = []
        prof, wall = trace.profile(lambda: done.append(window(n_steps=n)))
        rec = dict(steps=done[0], window_s=wall, plain_s=plain_s,
                   **trace.reduce(prof))
        rec["port_kernel"] = trace.port_kernel_pattern()
        return rec

    def count_work(self, rec, feed, start, train: bool) -> None:
        """Model FLOPs and the program's kernels' summed bound over the
        traced window's steps (steps start, start + 1, ...), from the
        reference's geometry of each."""
        from benchmark.lib import work
        from benchmark.reference import geometry as G
        cfg = self.config
        flops, bound = 0.0, 0.0
        for j in range(rec["steps"]):
            geo = G.build(*self.tensors(feed.make(start + j)),
                          voxel_size=cfg["DATA"]["VOXEL_SIZE"])
            f, calls = work.step_work(work.geometry_counts(geo),
                                      cfg["MODEL"], cfg["num_class"], train)
            flops += f
            bound += sum(work.bound_s(c) for c in calls)
        rec.update(flops=flops, bound_s=bound,
                   peak_flops=work.BF16_TC_FLOPS)


def read_metric(files: Path, name: str, rec: dict):
    """The reading of metric `name` from a window's record, by the reader
    ``<files>/metrics/<name>.py``; None where it finds nothing to read."""
    return load_module(find(files, "metrics", f"{name}.py"),
                       f"benchmark_metric_{name}").read(rec)


def card_line() -> str:
    """nvidia-smi's name, power limit and draw, clocks and temperature."""
    import subprocess
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi unavailable: {exc}"
    return f"card ({q}): {out}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_files(bench: dict, workload: str, files: Path = BENCH):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        find(files, "traffic", f"{cell['traffic']}.json").read_text())
    limits = json.loads(
        find(files, "limits", f"{workload}.json").read_text())["limits"]
    return cell, config, traffic, {k: float(v) for k, v in limits.items()}


def main(argv=None, *, bench=None, files=BENCH, device=None, fault=None,
         pool_workers=0, dump=None) -> int:
    """One run. `bench`, `files` (a folder searched before the
    benchmark's own for traffic, limits, drivers and metrics), `device`
    (a CPU device skips the look for a card), `fault` (a planted fault of
    the timed path) and `pool_workers` are for the benchmark's tests;
    `dump`, a file the per-leaf readings of a training cell go to, is for
    its calibration."""
    args = parse(argv)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic, limits = cell_files(bench, args.workload, files)
    if (traffic.get("loop"), traffic.get("clients")) != ("closed", 1):
        raise SystemExit("the drivers send a closed loop with one client")
    # the repository's root, not this folder, on the path: the program
    # and the benchmark's package are found from there
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != BENCH]
    from benchmark.lib.scans import Pool

    # the scans are cast in worker processes, on all but two of the host's
    # cores, while torch starts here (cast after it, they made set-up some
    # 5 s longer and no steadier)
    pool = Pool(config["scans"], args.seed, traffic["pool_scans"],
                workers=pool_workers)
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                print("no CUDA device: the benchmark runs on the card only",
                      file=sys.stderr)
                return 2
            if torch.cuda.device_count() < cell["chips"]:
                print(f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"asks for {cell['chips']}", file=sys.stderr)
                return 2
            device = torch.device("cuda", 0)
            torch.cuda.init()
        print(f"[{time.perf_counter() - T_START:8.3f} s] torch started on "
              f"{device}", file=sys.stderr)
        import openpcseg_torch
        where = Path(openpcseg_torch.__file__).resolve()
        if ROOT not in where.parents:
            print(f"{PROGRAM} loads from {where}, outside this checkout",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ctx = Ctx(args, bench, config, traffic, device, fault)
        ctx.pool, ctx.dump, ctx.files = pool, dump, files
        driver = load_module(find(files, "drivers", f"{traffic['driver']}.py"),
                             f"benchmark.drivers.{traffic['driver']}")
        rec, compared = driver.run(ctx)
    finally:
        pool.close()
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    return report(ctx, cell, rec, compared, limits)


def report(ctx, cell, rec, compared, limits) -> int:
    import torch
    bench = ctx.bench
    correct = all(compared[k] <= limits[k] for k in limits)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], ctx.trace):
        if m["name"] == "setup_s":
            val = ctx.setup_s
        else:
            val = read_metric(ctx.files, m["name"], rec)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    err = sys.stderr
    if dev.type == "cuda":
        print(card_line(), file=err)
    print(f"window: {rec['steps']} steps in {rec['window_s']:.4f} s"
          + (f" traced, {rec['plain_s']:.4f} s untraced" if ctx.trace
             else "")
          + f"; {rec['attempted']} attempted, {rec['failed']} failed; "
          f"set-up {ctx.setup_s:.3f} s", file=err)
    if "latencies_ms" in rec:
        print(f"latency samples: {len(rec['latencies_ms'])}", file=err)
    print(f"launches per step: {json.dumps(rec['launches_per_step'])}",
          file=err)
    print(f"memory peak (max_memory_allocated): {ctx.memory_peak} bytes",
          file=err)
    if ctx.trace:
        from benchmark.lib import trace
        busy = trace.busy([(a, b) for _, a, b in rec["kernels"]],
                          rec["t0"], rec["t1"]) / 1e6
        device.update(busy_s=busy, window_s=rec["window_s"])
        out["breakdown"] = trace.breakdown(rec)
    checks = {k: {"value": compared[k], "limit": limits[k]} for k in limits}
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=err)
    err.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
