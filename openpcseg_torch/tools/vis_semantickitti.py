"""SemanticKITTI point-cloud + segmentation visualizer.

Counterpart of the reference viewer (reference: tools/visualizer/
vis_SemanticKITTI.py:14-225, open3d-based) and a copy of the JAX
package's ``tools/visualizer/vis_semantickitti.py`` on the port's
metadata. With open3d it opens a viewer; without it, it saves a
matplotlib bird's-eye-view render to PNG.

    python -m openpcseg_torch.tools.vis_semantickitti --scan <bin> \\
        [--label <label> | --pred <npy>] [--out vis.png]

``--label`` takes a raw ``.label`` file (the dataset's, or a prediction
of ``cli/infer.py --save_pred --save_raw_ids``); ``--pred`` a ``.npy`` of
train ids (``cli/infer.py --save_pred``: one id per valid point of a
voxel model). Points past the end of the labels are not drawn.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from openpcseg_torch.data.semantickitti_meta import COLOR_MAP, remap_labels


def label_colors(labels: np.ndarray) -> np.ndarray:
    lut = np.zeros((max(COLOR_MAP) + 1, 3), np.float32)
    for k, bgr in COLOR_MAP.items():
        lut[k] = np.asarray(bgr[::-1], np.float32) / 255.0  # bgr -> rgb
    return lut[np.clip(labels, 0, len(lut) - 1)]


def bev_png(xyz: np.ndarray, colors: np.ndarray, out: str,
            lim: float | None) -> None:
    """Bird's-eye view of the points, coloured, to a PNG (x and y within
    +-lim metres where lim is set)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(12, 12), facecolor="black")
    ax.scatter(xyz[:, 0], xyz[:, 1], s=0.3, c=colors, linewidths=0)
    ax.set_aspect("equal")
    ax.set_facecolor("black")
    if lim is not None:
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
    ax.axis("off")
    fig.savefig(out, dpi=150, bbox_inches="tight", facecolor="black")
    plt.close(fig)


def show(xyz: np.ndarray, colors: np.ndarray, out: str,
         lim: float | None = 60.0) -> None:
    """open3d's viewer where open3d is installed, else bev_png."""
    try:
        import open3d as o3d
    except ImportError:
        bev_png(xyz, colors, out, lim)
        print(f"open3d unavailable; saved BEV render to {out}")
        return
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
    pc.colors = o3d.utility.Vector3dVector(colors.astype(np.float64))
    o3d.visualization.draw_geometries([pc])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", required=True)
    ap.add_argument("--label", default=None, help="raw .label file")
    ap.add_argument("--pred", default=None, help=".npy train-id predictions")
    ap.add_argument("--out", default="vis.png")
    args = ap.parse_args(argv)

    pts = np.fromfile(args.scan, dtype=np.float32).reshape(-1, 4)
    if args.pred:
        labels = np.load(args.pred).reshape(-1)
    elif args.label:
        labels = remap_labels(np.fromfile(args.label, dtype=np.uint32))
    else:
        labels = np.zeros(len(pts), np.int32)
    n = min(len(pts), len(labels))
    show(pts[:n, :3], label_colors(labels[:n]), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
