"""Waymo sequence unpacker for inference/visualization.

Counterpart of the reference tool (reference: tools/scripts/
unpack_wod_sequence.py:26-153) and a copy of the JAX package's
``tools/scripts/unpack_wod_sequence.py`` on the port's modules: extracts
every frame of one TFRecord sequence to the per-frame .npy layout consumed
by WaymoInferDataset. Requires waymo-open-dataset + tensorflow, which the
port does not depend on: without them ``main`` exits with a message
naming what is missing.

    python -m openpcseg_torch.tools.unpack_wod_sequence \
        --tfrecord <file> --out_dir <dir>
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from openpcseg_torch.tools.preprocess_waymo_data import (
    convert_range_image_to_points)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tfrecord", required=True)
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)

    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
    except ImportError as e:
        raise SystemExit(f"waymo-open-dataset + tensorflow required: {e}")

    out = Path(args.out_dir)
    (out / "first").mkdir(parents=True, exist_ok=True)
    (out / "second").mkdir(parents=True, exist_ok=True)
    ds = tf.data.TFRecordDataset(args.tfrecord, compression_type="")
    n = 0
    for fi, data in enumerate(ds):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        first, second = convert_range_image_to_points(frame, None)
        stem = f"{fi:06d}.npy"
        np.save(out / "first" / stem, first)
        np.save(out / "second" / stem, second)
        n += 1
    print(f"unpacked {n} frames to {out}")


if __name__ == "__main__":
    sys.exit(main())
