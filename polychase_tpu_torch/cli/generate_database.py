"""Headless optical-flow database generation from an image directory.

Port of ``polychase_tpu/cli/generate_database.py`` (reference:
cpp/examples/generate_database.cc:29-71)::

    python -m polychase_tpu_torch.cli.generate_database \
        --images-dir frames/ --database-path flow.db

Analyze runs on every visible card by default, its LK solves split over
them, and fails without one; ``--device`` names one device (``cuda:1``;
``cpu`` runs the kernels' plain torch versions).
Frames are read with Pillow.
"""

from __future__ import annotations

import argparse
import os
import sys


def list_images(images_dir: str):
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    files = sorted(
        f for f in os.listdir(images_dir)
        if os.path.splitext(f)[1].lower() in exts
    )
    return [os.path.join(images_dir, f) for f in files]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate a Polychase optical-flow database "
        "from a directory of frames."
    )
    parser.add_argument("--images-dir", required=True)
    parser.add_argument("--database-path", required=True)
    parser.add_argument("--first-frame", type=int, default=0)
    parser.add_argument("--num-frames", type=int, default=0,
                        help="0 = all frames in the directory")
    parser.add_argument("--quality-level", type=float, default=0.01)
    parser.add_argument("--min-distance", type=float, default=5.0)
    parser.add_argument("--max-corners", type=int, default=0)
    parser.add_argument("--write-images", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device of the run (default: every "
                        "visible card)")
    args = parser.parse_args(argv)
    from ..backend import surface_devices

    try:
        device = surface_devices(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    import numpy as np
    from PIL import Image

    from .. import api

    paths = list_images(args.images_dir)
    if not paths:
        print(f"no images found in {args.images_dir}", file=sys.stderr)
        return 1
    num = args.num_frames or len(paths)
    paths = paths[: num]

    first = Image.open(paths[0]).convert("RGB")
    w, h = first.size
    info = api.VideoInfo(
        width=w, height=h, first_frame=args.first_frame, num_frames=num
    )

    def accessor(frame_id: int):
        idx = frame_id - args.first_frame
        if not 0 <= idx < len(paths):
            return None
        return np.asarray(Image.open(paths[idx]).convert("RGB"))

    def progress(p: float, msg: str) -> bool:
        print(f"[{p * 100:5.1f}%] {msg}", flush=True)
        return True

    det = api.GFTTOptions()
    det.quality_level = args.quality_level
    det.min_distance = args.min_distance
    det.max_corners = args.max_corners

    api.generate_optical_flow_database(
        info, accessor, progress, args.database_path, det,
        api.OpticalFlowOptions(), args.write_images, device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
