"""Readings that set a cell's limits: the program's on many seeds, the
control's, and each planted fault's, all in one process.

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--what program,control,half,altered,unchanged] [--seconds 2]

``program`` runs the cell as ``run.py`` does (a short window) and reads
its numbers compared; ``control`` puts the reference in the program's
place, computed one precision below the configuration's (float8 e4m3
operands, e5m2 gradients, for bf16), and reads the same numbers against
the float32 reference; ``bf16ref`` does so with the reference rounded to
bf16, a witness of what the configuration's own precision does; a fault
name (half, altered, unchanged) runs the cell with that fault planted in
the timed path. One JSON line a reading, on standard output.
"""
import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def control(workload: str, seed: int, device, files=BENCH, bench=None,
            rounding="fp8", dump=None):
    """The control's readings on the inputs a run of `seed` makes: the
    reference rounded to fp8 (or, as a witness, to bf16) in the program's
    place."""
    import torch

    from benchmark import run
    from benchmark.lib import checks, scans, weights
    from benchmark.reference import geometry as G, minkunet as R

    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic, _ = run.cell_files(bench, workload, files)
    pool = scans.Pool(cfg["scans"], seed, traffic["pool_scans"])
    try:
        batches = pool.batches(traffic["batch"])
    finally:
        pool.close()
    feed = scans.Feed(batches, traffic.get("augment"), seed, ahead=False)
    p0 = weights.for_cell(cfg, traffic, seed, device, batches)
    vs = cfg["DATA"]["VOXEL_SIZE"]

    def geo(b):
        return G.build(*(torch.as_tensor(b[k]).to(device) for k in
                         ("xyz", "feats", "labels", "valid")), voxel_size=vs)
    q = checks.fp8_quant() if rounding == "fp8" else checks.bf16_quant()
    if traffic["driver"] == "train":
        n, bsz = traffic["check_steps"], traffic["batch"]
        geos = [geo(feed.make(s)) for s in range(n)]
        ipe = cfg["train_scans"] // bsz
        ref = R.train_steps(p0, geos, cfg["MODEL"], cfg["OPTIM"], bsz, ipe)
        low = R.train_steps(p0, geos, cfg["MODEL"], cfg["OPTIM"], bsz, ipe,
                            quant=q)
        deltas = [{k: v - p0[k] for k, v in x[2].items()} for x in (low, ref)]
        read = checks.train_readings(low[0], ref[0], low[1], ref[1], *deltas)
        if dump:
            with open(dump, "a") as f:
                f.write(json.dumps(dict(seed=seed, fault=rounding,
                                        leaves=checks.leaf_table(
                                            low[1], ref[1], *deltas)))
                        + "\n")
        return {k: v for k, v in read.items() if k != "left_out"}
    gap = 0.0
    for i in range(traffic["check_requests"]):
        g = geo(feed.make(traffic["warmup"] + i))
        ref = R.eval_logits(p0, g, cfg["MODEL"])
        low = R.eval_logits(p0, g, cfg["MODEL"], quant=q)
        gap = max(gap, checks.label_gap(ref, low.argmax(dim=1)))
    return {"label_gap": gap}


def main(argv=None, *, bench=None, files=BENCH, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--dump", default=None,
                    help="a file the per-leaf norms of training go to")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != BENCH]
    import torch

    from benchmark import run
    dev = device or torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        for what in args.what.split(","):
            if what in ("control", "bf16ref"):
                read = control(args.workload, seed, dev, files, bench,
                               "fp8" if what == "control" else "bf16",
                               args.dump)
                rc = 0
            else:
                buf, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(err):
                    rc = run.main(
                        ["--workload", args.workload, "--seed", str(seed),
                         "--seconds", str(args.seconds), "--trace", "0"],
                        bench=bench, files=files, device=device,
                        fault=None if what == "program" else what,
                        dump=args.dump)
                lines = buf.getvalue().strip().splitlines()
                out = json.loads(lines[-1]) if rc == 0 and lines else {}
                read = {k: v["value"] for k, v in
                        out.get("checks", {}).items()}
                read["correct"] = out.get("correct")
                for line in err.getvalue().splitlines():
                    if line.startswith("readings: "):
                        read.update(json.loads(line[len("readings: "):]))
                if rc != 0:
                    sys.stderr.write(err.getvalue()[-4000:])
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  what=what, rc=rc, **read)), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
