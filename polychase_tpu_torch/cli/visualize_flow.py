"""Render keypoint/flow overlays from a flow database.

Port of ``polychase_tpu/cli/visualize_flow.py`` (reference:
cpp/examples/visualize_flow.cc:34-99)::

    python -m polychase_tpu_torch.cli.visualize_flow \
        --images-dir frames/ --database-path flow.db --output-dir viz/

It reads the DB and draws the overlays with Pillow on the host, so it
takes no device.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Visualize keypoints and pair flows as overlay images."
    )
    parser.add_argument("--images-dir", required=True)
    parser.add_argument("--database-path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--first-frame", type=int, default=0)
    parser.add_argument("--skip", type=int, default=1,
                        help="flow skip to visualize (1, 2, 4 or 8)")
    args = parser.parse_args(argv)

    import numpy as np
    from PIL import Image, ImageDraw

    from .. import api
    from .generate_database import list_images

    paths = list_images(args.images_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    db = api.Database(args.database_path)

    rng = np.random.default_rng(0)
    for i, path in enumerate(paths):
        fid = args.first_frame + i
        kps = db.read_keypoints(fid)
        if kps.shape[0] == 0:
            continue
        img = Image.open(path).convert("RGB")
        draw = ImageDraw.Draw(img)
        flow = db.read_image_pair_flow(fid, fid + args.skip)
        for x, y in kps:
            draw.line([(x - 4, y), (x + 4, y)], fill=(0, 255, 0))
            draw.line([(x, y - 4), (x, y + 4)], fill=(0, 255, 0))
        for j, src_idx in enumerate(flow.src_kps_indices):
            color = tuple(int(c) for c in rng.integers(64, 255, 3))
            x0, y0 = kps[src_idx]
            x1, y1 = flow.tgt_kps[j]
            draw.line([(x0, y0), (x1, y1)], fill=color, width=2)
        out = os.path.join(args.output_dir, f"flow_{fid:06d}.png")
        img.save(out)
        print(f"wrote {out} ({len(flow.src_kps_indices)} flows)", flush=True)
    db.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
