"""Waymo Open TFRecord -> per-frame .npy preprocessor.

Re-implementation of the reference preprocessor (reference:
pcseg/data/dataset/waymo/scripts/preprocess_waymo_data.py:104-150) and a
copy of the JAX package's ``tools/scripts/preprocess_waymo_data.py`` on
the port's modules: for each
frame and each of the two lidar returns, writes an [N, 7] array of
[range, intensity, elongation, x, y, z, label] rows to
<out>/first/<seq>_<frame>.npy and <out>/second/..., then emits split lists.

The proto parsing requires the optional `waymo-open-dataset` + tensorflow
packages, which the port does not depend on: without them ``main`` exits
with a message naming what is missing. The range-image -> point-cloud
GEOMETRY is self-contained (openpcseg_torch/data/waymo_conversion.py,
round-trip tested) and used when the waymo package's range_image_utils
fails. The runtime data path consumes the .npy layout directly
(openpcseg_torch/data/waymo.py).

    python -m openpcseg_torch.tools.preprocess_waymo_data \
        --tfrecord_dir <dir of .tfrecord> --out_dir <dir> [--split_name train]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def convert_range_image_to_points(frame, parsed):
    """Range image -> point list with labels, both returns.

    Thin wrapper over waymo_open_dataset.utils.range_image_utils, following
    the reference's extraction (reference preprocess_waymo_data.py:104-147
    and pcseg/utils/waymo_utils.py:31-296).
    """
    from waymo_open_dataset.utils import frame_utils  # noqa: F401

    (range_images, camera_projections, seg_labels, range_image_top_pose
     ) = frame_utils.parse_range_image_and_camera_projection(frame)
    out = []
    for ri_index in (0, 1):
        try:
            points, _cp = frame_utils.convert_range_image_to_point_cloud(
                frame, range_images, camera_projections,
                range_image_top_pose, ri_index=ri_index,
                keep_polar_features=True)
            # points[0] = TOP lidar: [range, int, elong, x, y, z]
            top = points[0]
        except Exception:
            # self-contained geometry fallback (same math, numpy):
            # openpcseg_torch/data/waymo_conversion.py
            import tensorflow as tf
            from openpcseg_torch.data.waymo_conversion import (
                compute_inclinations, range_image_to_points)
            c = sorted(frame.context.laser_calibrations,
                       key=lambda x: x.name)[0]  # TOP
            ri = range_images[1][ri_index]
            rit = tf.reshape(tf.convert_to_tensor(ri.data),
                             ri.shape.dims).numpy()
            if len(c.beam_inclinations):
                incl = np.asarray(c.beam_inclinations)[::-1]
            else:
                incl = compute_inclinations(
                    c.beam_inclination_min, c.beam_inclination_max,
                    rit.shape[0])[::-1]
            ext = np.reshape(np.asarray(c.extrinsic.transform), (4, 4))
            top, _ = range_image_to_points(rit, ext, incl)
        n = len(top)
        labels = np.zeros((n, 1), np.int32)
        if seg_labels:
            import tensorflow as tf
            sl = seg_labels[1][ri_index]  # TOP lidar
            sl_tensor = tf.reshape(
                tf.convert_to_tensor(sl.data), sl.shape.dims)
            ri = range_images[1][ri_index]
            ri_tensor = tf.reshape(tf.convert_to_tensor(ri.data),
                                   ri.shape.dims)
            mask = ri_tensor[..., 0] > 0
            labels = tf.gather_nd(
                sl_tensor[..., 1], tf.where(mask)).numpy().reshape(-1, 1)
        out.append(np.concatenate([top, labels], axis=1).astype(np.float32))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tfrecord_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--split_name", default="train")
    args = ap.parse_args(argv)

    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
    except ImportError as e:
        raise SystemExit(
            "waymo-open-dataset + tensorflow are required for preprocessing; "
            "install them in a separate environment (the training runtime "
            f"only reads the .npy output). Missing: {e}")

    out = Path(args.out_dir)
    (out / "first").mkdir(parents=True, exist_ok=True)
    (out / "second").mkdir(parents=True, exist_ok=True)
    names = []
    for rec in sorted(Path(args.tfrecord_dir).glob("*.tfrecord")):
        ds = tf.data.TFRecordDataset(str(rec), compression_type="")
        for fi, data in enumerate(ds):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            if not frame.lasers[0].ri_return1.segmentation_label_compressed:
                continue  # only frames with segmentation labels
            first, second = convert_range_image_to_points(frame, None)
            stem = f"{rec.stem}_{fi:04d}.npy"
            np.save(out / "first" / stem, first)
            np.save(out / "second" / stem, second)
            names.append(str(out / "first" / stem))
    with open(out / f"{args.split_name}.txt", "w") as f:
        f.write("\n".join(names))
    print(f"wrote {len(names)} frames")


if __name__ == "__main__":
    main()
