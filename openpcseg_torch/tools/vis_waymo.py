"""Waymo point-cloud + prediction visualizer.

Counterpart of the reference viewer (reference: tools/scripts/
vis_waymo.py:38-223, open3d-based) and a copy of the JAX package's
``tools/visualizer/vis_waymo.py``: renders an unpacked frame (``.npy``
rows [range, intensity, elongation, x, y, z, label]) with its labels or a
prediction dump of ``cli/infer.py --save_pred``, in open3d's viewer where
open3d is installed, else as a matplotlib bird's-eye-view PNG.

    python -m openpcseg_torch.tools.vis_waymo --frame <npy> [--pred <npy>] \\
        [--out vis_waymo.png]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from openpcseg_torch.tools.vis_semantickitti import show


def waymo_colors(labels: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(4)
    lut = rng.random((23, 3)).astype(np.float32)
    lut[0] = 0.3
    return lut[np.clip(labels, 0, 22)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frame", required=True, help=".npy frame (first return)")
    ap.add_argument("--pred", default=None)
    ap.add_argument("--out", default="vis_waymo.png")
    args = ap.parse_args(argv)

    arr = np.load(args.frame)
    labels = (np.load(args.pred).reshape(-1) if args.pred
              else arr[:, -1].astype(np.int32))
    n = min(len(arr), len(labels))
    show(arr[:n, 3:6], waymo_colors(labels[:n]), args.out, lim=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
