"""Synthetic clips, without JAX: an orbit clip with its flow database, a
noisy trajectory and surface pins on it, a panning clip of blurred noise
for analyze, and the PnP scenes of the JAX package's kernel tests.

The scene is the tracking configuration of ``benchmarks/run_all.py``
(``make_scene`` / ``build_synth_db``): a UV sphere at the origin, an OpenCV
camera at distance 4 turning 0.01 rad per frame, random keypoints in the
central 40% of the frame that hit the sphere, and their flows along the
±{1, 2, 4, 8} skip fan with Gaussian pixel noise.  Keypoints are ray-cast
with the port's ``raycast_grouped`` on the given device; everything else is
numpy, seeded by the caller's generator.

Config 4 (``benchmarks/run_all.py:348-398``) is this clip at 250 frames,
128 keypoints per frame and 0.3 px noise over a 24×32 sphere (1,472
triangles), refined from ``noisy_trajectory``; config 2
(``run_all.py:219-265``) drags ``surface_pins`` seen from its first frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .io.database import Database

from .engine import camera as C
from .engine.geometry import Mesh
from .engine.pose import Pose, quat_to_mat_np
from .engine.raycast import raycast_grouped
from .engine.trajectory import CameraTrajectory

IMAGE_SKIPS = (-8, -4, -2, -1, 1, 2, 4, 8)


def uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """Vertices (f32) and outward-wound triangles (u32) of a UV sphere:
    ``n_lon · (2 n_lat − 2)`` triangles."""
    verts = []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.sin(th) * np.sin(ph),
                          radius * np.cos(th)])
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                tris.append([a, c, b])
            if i < n_lat - 1:
                tris.append([b, c, d])
    return np.asarray(verts, np.float32), np.asarray(tris, np.uint32)


def orbit_poses(n_frames: int):
    """World→camera (q, t) per frame, float32 numpy."""
    poses = []
    for f in range(n_frames):
        ang = 0.01 * f
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0], np.float32)
        t = np.array([0.05 * np.sin(0.05 * f), 0.02 * f / n_frames, 4.0],
                     np.float32)
        poses.append((q, t))
    return poses


def build_flow_db(db_path: str, mesh: Mesh, focal: float, width: int,
                  height: int, poses, rng: np.random.Generator,
                  kp_per_frame: int, noise_px: float) -> None:
    """Write keypoints and skip-fan flows of the clip into ``db_path``.

    ``mesh`` lives on the device that runs the ray cast."""
    n = len(poses)
    fx = fy = float(focal)
    cx, cy = width / 2.0, height / 2.0
    Rs = [quat_to_mat_np(q) for q, _ in poses]
    ts = [np.asarray(t, np.float64) for _, t in poses]

    pix = rng.uniform((width * 0.3, height * 0.3), (width * 0.7, height * 0.7),
                      (n, kp_per_frame, 2)).astype(np.float32)
    origins = np.stack([-(R.T @ t) for R, t in zip(Rs, ts)]).astype(np.float32)
    d_cam = np.stack(
        [(pix[..., 0] - cx) / fx, (pix[..., 1] - cy) / fy,
         np.ones(pix.shape[:2])], axis=-1,
    )
    dirs = np.stack([d_cam[i] @ Rs[i] for i in range(n)]).astype(np.float32)
    dev = mesh.vertices.device
    hits = raycast_grouped(
        mesh, torch.as_tensor(origins, device=dev),
        torch.as_tensor(dirs, device=dev), True,
    )
    valid = hits.valid.cpu().numpy()
    pos = hits.pos.cpu().numpy().astype(np.float64)

    db = Database(db_path)
    try:
        with db.deferred_commits():
            pts = []
            for i in range(n):
                db.write_keypoints(i, pix[i][valid[i]])
                pts.append(pos[i][valid[i]])
            for i in range(n):
                if pts[i].shape[0] == 0:
                    continue
                for skip in IMAGE_SKIPS:
                    j = i + skip
                    if not 0 <= j < n:
                        continue
                    Z = pts[i] @ Rs[j].T + ts[j]
                    proj = np.stack(
                        [fx * Z[:, 0] / Z[:, 2] + cx,
                         fy * Z[:, 1] / Z[:, 2] + cy], axis=-1,
                    ).astype(np.float32)
                    inb = ((proj[:, 0] > 0) & (proj[:, 0] < width)
                           & (proj[:, 1] > 0) & (proj[:, 1] < height))
                    idx = np.nonzero(inb)[0].astype(np.uint32)
                    jitter = rng.normal(0.0, noise_px, (idx.size, 2))
                    db.write_image_pair_flow(
                        i, j, idx, proj[inb] + jitter.astype(np.float32),
                        np.zeros(idx.size, np.float32),
                    )
    finally:
        db.close()


def noisy_trajectory(poses, intrinsics: C.Intrinsics, rng: np.random.Generator,
                     t_sigma: float = 0.005) -> CameraTrajectory:
    """The clip's cameras with N(0, ``t_sigma``) noise on the translation of
    every frame but the first and last (``run_all.py:364-373``), as CPU
    tensors."""
    n = len(poses)
    traj = CameraTrajectory(0, n)
    intr = intrinsics.to("cpu")
    for i, (q, t) in enumerate(poses):
        t = np.asarray(t, np.float32)
        if i not in (0, n - 1):
            t = t + rng.normal(0, t_sigma, 3).astype(np.float32)
        traj.set(i, C.CameraState(intr, Pose(torch.as_tensor(q.copy()),
                                             torch.as_tensor(t.copy()))))
    return traj


def surface_pins(mesh: Mesh, pose, focal: float, width: int, height: int,
                 rng: np.random.Generator, n: int = 8) -> np.ndarray:
    """Mesh-surface points under ``n`` random pixels of the central region
    ``(700, 400)–(1200, 700)`` seen from ``pose`` = (q, t), cast on the
    mesh's device (``run_all.py:231-240``); (≤ n, 3) float32, misses
    dropped."""
    q, t = pose
    R = quat_to_mat_np(q)
    pix = rng.uniform((700, 400), (1200, 700), (n, 2)).astype(np.float32)
    d_cam = np.stack([(pix[:, 0] - width / 2.0) / focal,
                      (pix[:, 1] - height / 2.0) / focal,
                      np.ones(n)], axis=-1)
    origin = -(R.T @ np.asarray(t, np.float64))
    dev = mesh.vertices.device
    hits = raycast_grouped(
        mesh, torch.as_tensor(origin[None].astype(np.float32), device=dev),
        torch.as_tensor((d_cam @ R)[None].astype(np.float32), device=dev),
        True,
    )
    return hits.pos[0][hits.valid[0]].cpu().numpy()


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflect-101 borders, as
    ``cv2.GaussianBlur(img, (0, 0), sigma)`` does it on float32 (kernel
    size ``round(8·sigma + 1) | 1``)."""
    r = int(round(sigma * 8 + 1)) | 1
    r //= 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    out = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for i, c in enumerate(k):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(i, i + n)
            acc += c * p[tuple(sl)]
        out = acc
    return out


def panning_clip(rng: np.random.Generator, n_frames: int, width: int,
                 height: int, step=(7, 4)):
    """Config 1b's clip (``benchmarks/run_all.py:183-216``) without cv2:
    uniform noise blurred with sigma 1.5, rescaled to uint8, and cropped
    with a pan of ``step`` = (x, y) px per frame.  The content of frame i
    appears in frame i + s shifted by -s·step.  Returns a list of
    (height, width) uint8 frames."""
    sx, sy = step
    big = rng.integers(0, 255, (height + sy * n_frames + 8,
                                width + sx * n_frames + 8)).astype(np.float32)
    big = _gaussian_blur(big, 1.5).astype(np.float32)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    return [np.ascontiguousarray(big[sy * t:sy * t + height,
                                     sx * t:sx * t + width])
            for t in range(n_frames)]


def pnp_scene(rng: np.random.Generator, n: int, *, opencv: bool = True,
              behind: int = 0, n_masked: int = 0, f_err: float = 1.0,
              pp_err=(0.0, 0.0), noise: float = 0.4, spread: float = 1.0):
    """One PnP solve's inputs (the scenes of tests/test_pnp_pallas.py): n
    random points, normal with ``spread`` about a point 6 units in front of
    a 1920×1080, f = 1800 camera (``behind`` of them moved behind it),
    their projections with ``noise``
    px of noise, the last ``n_masked`` masked out, and a perturbed warm
    start with the focal scaled by ``f_err`` and the principal point moved
    by ``pp_err``.  Returns (X, x, weights, mask, params) as numpy arrays in
    ``engine.pnp.solve_arrays``'s layout, without the batch axis."""
    focal, width, height = 1800.0, 1920, 1080
    sign = 1.0 if opencv else -1.0
    X = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    X[:, 2] += 6.0 * sign
    X[:behind, 2] -= 14.0 * sign
    q_gt = np.array([0.99, 0.05, -0.08, 0.03])
    q_gt /= np.linalg.norm(q_gt)
    t_gt = np.array([0.1, -0.2, 0.3])
    Z = X.astype(np.float64) @ quat_to_mat_np(q_gt).T + t_gt
    x = np.stack([focal * Z[:, 0] / Z[:, 2] + width / 2,
                  focal * Z[:, 1] / Z[:, 2] + height / 2], axis=-1)
    x = (x + rng.normal(scale=noise, size=(n, 2))).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - n_masked:] = False
    q0 = q_gt + np.array([0.01, -0.02, 0.015, 0.01])
    q0 /= np.linalg.norm(q0)
    params = np.array(
        [*q0, 0.15, -0.1, 0.2, focal * f_err, focal * f_err,
         width / 2 + pp_err[0], height / 2 + pp_err[1], 1.0, width, height,
         sign, 12.0], np.float32,
    )
    return X, x, mask.astype(np.float32), mask, params
