"""Optical-flow database generation (the "Analyze Video" pipeline).

Port of ``polychase_tpu/engine/opticalflow.py`` (reference:
cpp/opticalflow.cc:209-321).  For every frame: detect-or-load keypoints,
build the LK pyramid, and track into the frames of the ±{1, 2, 4, 8} skip
pattern, writing each pair's surviving flows to the SQLite database.

- Detection is ``engine.gftt``'s: frames of ``gftt.DEVICE_SUPPRESS_MIN``
  pixels and more take its device suppression route
  (``gftt.device_suppress_route``, K4 on a card), smaller ones its host
  route.
- All targets of a source frame are one multi-target solve on the device
  (the reference's per-pair thread pool becomes a batch axis); the solve's
  levels launch K2 and K3 on a CUDA device.  With ``POLYCHASE_LK_CHAIN=1``
  the fan is solved as chained phases (``engine.lk.chain_engages``): K2
  once per level, K3 once per level per phase.
- Given several devices, each solve is split over them by features or by
  targets (``engine.lk.split_route``, ``parallel.analyze``), as the
  reference shards only the LK solve.  GFTT, the pyramids, their LRUs and
  the DB writes stay on the first device and the host; each solve copies
  the source levels (and, split by features, every target's levels) to the
  other devices, and its results come back to the first.
- Prepared pyramids live in an LRU keyed by frame id (the analogue of the
  reference's 17-frame ring buffer), each frame uploaded once as uint8.
- A single Python thread keeps the device busy: GFTT for the next
  ``LOOKAHEAD`` frames is queued ahead, and the results of a solve are
  written to the DB only once ``LK_INFLIGHT`` later solves are queued
  behind it, so the host's suppression and SQLite writes overlap the
  device.
- Resumable like the reference: existing keypoints are reused and existing
  pair flows skipped (cpp/opticalflow.cc:168-178, :286).  The progress
  callback returns False to cancel (cpp/opticalflow.cc:238-247).
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict, deque
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..io.database import Database

from ..parallel import resolve_devices
from .gftt import GFTTOptions, gftt_dispatch, gftt_finish
from .lk import (
    LKOptions,
    calc_optical_flow_multi_async,
    calc_optical_flow_multi_finish,
    prepare_pyramid,
)

# Skip pattern (cpp/opticalflow.cc:76-78)
IMAGE_SKIPS = (-8, -4, -2, -1, 1, 2, 4, 8)

# Frames whose detection is queued ahead of the current one.
LOOKAHEAD = 4
# Solves queued on the device before the oldest one is written to the DB.
# Measured on the card (PERF.md): depths 1 to 3 tie within noise, 5 and 8
# ran slower; analyze is bound by the host, so the shallowest is kept.
LK_INFLIGHT = 1

# FrameAccessorFunction: frame_id -> (H, W, 3) uint8 RGB, (H, W) gray or None
FrameAccessor = Callable[[int], Optional[np.ndarray]]
# OpticalFlowProgressCallback: (progress, message) -> continue?
ProgressCallback = Callable[[float, str], bool]

OpticalFlowOptions = LKOptions  # same fields (cpp/opticalflow.h:27-33)

_log = logging.getLogger(__name__)


class VideoInfo(NamedTuple):
    """Clip geometry (cpp/opticalflow.h:20-25)."""

    width: int
    height: int
    first_frame: int
    num_frames: int


class FrameNotProvidedError(RuntimeError):
    pass


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """RGB→gray with OpenCV's fixed-point BT.601 weights
    (cv::COLOR_RGB2GRAY; used at cpp/opticalflow.cc:259)."""
    f = frame.astype(np.uint32)
    y = (f[..., 0] * 4899 + f[..., 1] * 9617 + f[..., 2] * 1868 + 8192) >> 14
    return y.astype(np.uint8)


class _PyramidLRU:
    """LRU keyed by frame id (pyramids, gray frames or device frames)."""

    def __init__(self, capacity: int = 17):
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()

    def get(self, frame_id: int):
        item = self._store.get(frame_id)
        if item is not None:
            self._store.move_to_end(frame_id)
        return item

    def put(self, frame_id: int, item) -> None:
        self._store[frame_id] = item
        self._store.move_to_end(frame_id)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)


def generate_optical_flow_database(
    video_info: VideoInfo,
    frame_accessor: FrameAccessor,
    callback: Optional[ProgressCallback],
    database_path: str,
    detector_options: GFTTOptions = GFTTOptions(),
    flow_options: OpticalFlowOptions = OpticalFlowOptions(),
    write_images: bool = False,
    *,
    device,
) -> None:
    """Generate keypoints + pairwise flows for a clip on ``device``, one
    device or a sequence of them (the module docstring)
    (cpp/opticalflow.cc:209-321).

    ``write_images`` dumps debug PNGs into a ``frames`` directory beside the
    database like the reference (cpp/opticalflow.cc:80-96); it is
    best-effort and needs OpenCV.
    """
    if frame_accessor is None:
        raise ValueError("frame_accessor is required")
    devices = resolve_devices(device)
    db = Database(database_path)
    try:
        _run(db, video_info, frame_accessor, callback, detector_options,
             flow_options, write_images, database_path, devices)
    finally:
        db.close()


def _get_gray(frame_accessor: FrameAccessor, video_info: VideoInfo,
              frame_id: int) -> np.ndarray:
    frame = frame_accessor(frame_id)
    if frame is None:
        raise FrameNotProvidedError(
            f"Requested frame #{frame_id} was not provided")
    frame = np.asarray(frame)
    if frame.ndim == 3 and frame.shape[2] == 3:
        if (frame.shape[0] != video_info.height
                or frame.shape[1] != video_info.width):
            raise ValueError(
                f"frame #{frame_id} has shape {frame.shape[:2]}, expected "
                f"({video_info.height}, {video_info.width})")
        return rgb_to_gray(frame)
    if frame.ndim == 2:
        return frame.astype(np.uint8, copy=False)
    raise ValueError("frames must be (H, W, 3) RGB or (H, W) gray")


def _run(db: Database, video_info: VideoInfo, frame_accessor: FrameAccessor,
         callback: Optional[ProgressCallback],
         detector_options: GFTTOptions, flow_options: OpticalFlowOptions,
         write_images: bool, database_path: str,
         devices: List[torch.device]) -> None:
    device = devices[0]
    first = video_info.first_frame
    last = video_info.first_frame + video_info.num_frames  # exclusive
    # Capacity covers the live window [i-8, i+8+LOOKAHEAD], so prefetched
    # entries are never evicted before use.
    cache = _PyramidLRU(25)
    gray_cache = _PyramidLRU(25)
    dev_cache = _PyramidLRU(25)   # uint8 frames on the device

    frames_dir = None
    if write_images:
        frames_dir = os.path.join(
            os.path.dirname(os.path.abspath(database_path)), "frames")
        os.makedirs(frames_dir, exist_ok=True)

    def gray_of(frame_id: int) -> np.ndarray:
        g = gray_cache.get(frame_id)
        if g is None:
            g = _get_gray(frame_accessor, video_info, frame_id)
            gray_cache.put(frame_id, g)
        return g

    def dev_gray_of(frame_id: int) -> torch.Tensor:
        """One uint8 upload per frame, shared by GFTT and the pyramid."""
        d = dev_cache.get(frame_id)
        if d is None:
            d = torch.from_numpy(np.ascontiguousarray(gray_of(frame_id))).to(
                device, non_blocking=True)
            dev_cache.put(frame_id, d)
        return d

    def get_pyramid(frame_id: int):
        pyr = cache.get(frame_id)
        if pyr is None:
            pyr = prepare_pyramid(dev_gray_of(frame_id), flow_options,
                                  device=device)
            cache.put(frame_id, pyr)
        return pyr

    gftt_pending: dict = {}
    gftt_skip: set = set()

    def ensure_gftt(fa: int) -> None:
        """Queue detection for ``fa`` if its keypoints don't exist yet."""
        if fa in gftt_pending or fa in gftt_skip:
            return
        if db.read_keypoints(fa).shape[0] > 0:
            gftt_skip.add(fa)
            return
        gftt_pending[fa] = gftt_dispatch(dev_gray_of(fa), None,
                                         detector_options, device=device)

    # Missing-flow targets per source frame (cpp/opticalflow.cc:286),
    # cached because the prefetch consults future frames repeatedly; nothing
    # writes a future source's pairs before it is processed.
    target_cache: dict = {}

    def missing_targets(fid: int):
        tg = target_cache.get(fid)
        if tg is None:
            tg = [fid + skip for skip in IMAGE_SKIPS
                  if first <= fid + skip < last
                  and not db.image_pair_flow_exists(fid, fid + skip)]
            target_cache[fid] = tg
        return tg

    pending_flows: deque = deque()

    def flush_one():
        frame_id1, targets, handle = pending_flows.popleft()
        tracked, status, err = calc_optical_flow_multi_finish(handle)
        # One sqlite commit for the frame: its new keypoints and its whole
        # skip fan land together.
        with db.deferred_commits():
            for i, frame_id2 in enumerate(targets):
                st = status[i]
                keep = np.nonzero(st)[0].astype(np.uint32)
                db.write_image_pair_flow(frame_id1, frame_id2, keep,
                                         tracked[i][st], err[i][st])

    cancelled = False
    for frame_id1 in range(first, last):
        if callback is not None:
            progress = (frame_id1 - first) / max(video_info.num_frames, 1)
            if not callback(progress, f"Processing frame {frame_id1}"):
                cancelled = True
                break

        ensure_gftt(frame_id1)
        # Read-or-generate keypoints (cpp/opticalflow.cc:154-178)
        features = db.read_keypoints(frame_id1)
        if features.shape[0] == 0 and frame_id1 in gftt_pending:
            features, _ = gftt_finish(gftt_pending.pop(frame_id1))
            db.write_keypoints(frame_id1, features)
            _log.debug("frame %d: detected %d keypoints", frame_id1,
                       features.shape[0])

        if frames_dir is not None:
            _save_debug_image(gray_of(frame_id1), frame_id1, frames_dir,
                              features)
        if features.shape[0] == 0:
            continue
        targets = missing_targets(frame_id1)
        if not targets:
            continue
        pyr1 = get_pyramid(frame_id1)
        pyrs2 = [get_pyramid(f2) for f2 in targets]
        _log.debug("frame %d: tracking %d features into %s", frame_id1,
                   features.shape[0], targets)
        handle = calc_optical_flow_multi_async(
            pyr1, pyrs2, features, flow_options,
            [f2 - frame_id1 for f2 in targets], devices=devices)
        pending_flows.append((frame_id1, targets, handle))

        # Queue the detection and pyramids of upcoming source frames and
        # their missing targets behind this solve.  A resumed run with every
        # flow present never touches the frame accessor.
        for fs in range(frame_id1 + 1, min(frame_id1 + LOOKAHEAD + 1, last)):
            tg = missing_targets(fs)
            if tg:
                ensure_gftt(fs)
                get_pyramid(fs)
                for f2 in tg:
                    get_pyramid(f2)

        while len(pending_flows) > LK_INFLIGHT:
            flush_one()

    while pending_flows:
        flush_one()
    if callback is not None:
        callback(1.0, "Cancelled" if cancelled else "Done")


def _save_debug_image(gray, frame_id, frames_dir, features):
    """Best-effort debug dump (cpp/opticalflow.cc:80-96)."""
    try:
        import cv2
    except ImportError:
        return
    try:
        cv2.imwrite(f"{frames_dir}/{frame_id:06d}.png", gray)
        vis = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        for x, y in features.astype(int):
            cv2.drawMarker(vis, (int(x), int(y)), (0, 255, 0),
                           cv2.MARKER_CROSS, 10)
        cv2.imwrite(f"{frames_dir}/keypoints_{frame_id:06d}.png", vis)
    except (cv2.error, OSError):
        pass
