"""The benchmark's inputs, made from ``--seed`` in numpy alone.

A deployment (``configs/<name>.json``) names a clip, a mesh and the density
of its features.  From those and a seed this module makes:

- the mesh: a closed UV sphere (vertices float32, triangles uint32), the
  same vertex and triangle order as ``polychase_tpu_torch.synthetic.
  uv_sphere``, built without a Python loop;
- the clip's ground-truth cameras: the orbit of ``synthetic.orbit_poses``
  (world to camera, OpenCV, float32);
- each frame's keypoints: points sampled on the mesh itself (a triangle by
  area, then barycentric coordinates), kept where their triangle faces the
  camera by at least ``min_facing_cos`` and they project into the frame.
  The mesh is convex, so a point that faces the camera is visible;
- each frame's flows along the skip fan: the frame's points projected into
  the target frame, kept inside it, with Gaussian pixel noise;
- the flow database, written through the schema of the program's
  ``io/database.py`` with ``sqlite3``.

Nothing here imports the program: the inputs never pass through the code
under test.
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass

import numpy as np

# The schema and pragmas of the program's flow database (the reference
# store's: cpp/database.cc), written here so the benchmark makes its DB
# without the program.
_PRAGMAS = ("PRAGMA synchronous=OFF", "PRAGMA journal_mode=WAL",
            "PRAGMA temp_store=MEMORY", "PRAGMA foreign_keys=ON",
            "PRAGMA auto_vacuum=1")
_SCHEMA = (
    """CREATE TABLE IF NOT EXISTS keypoints(
    image_id   INTEGER  PRIMARY KEY  NOT NULL,
    rows       INTEGER               NOT NULL,
    keypoints  BLOB                  NOT NULL
);""",
    """CREATE TABLE IF NOT EXISTS optical_flow(
    image_id_from           INTEGER  NOT NULL,
    image_id_to             INTEGER  NOT NULL,
    rows                    INTEGER  NOT NULL,
    src_keypoints_indices   BLOB     NOT NULL,
    tgt_keypoints           BLOB     NOT NULL,
    flow_errors             BLOB     NOT NULL,
    PRIMARY KEY(image_id_from, image_id_to),
    FOREIGN KEY(image_id_from) REFERENCES keypoints(image_id) ON DELETE CASCADE
);""",
)


@dataclass
class Scene:
    """One seed's inputs.  ``kps[i]`` (N_i, 2) float32 pixels of frame i,
    ``flows[(i, j)]`` = (source keypoint indices uint32, target pixels
    (n, 2) float32); ``poses[i]`` = (q (4,), t (3,)) float32, world to
    camera."""

    vertices: np.ndarray
    triangles: np.ndarray
    poses: list
    focal: float
    width: int
    height: int
    kps: list
    flows: dict

    @property
    def n_frames(self) -> int:
        return len(self.poses)

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator for ``seed`` and a path of keys: every draw of a run
    comes from one of these, so a draw does not depend on how many others
    were made before it."""
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """Vertices (float32) and outward-wound triangles (uint32) of a UV
    sphere, ``n_lon · (2 n_lat − 2)`` triangles, in the order of the
    program's ``synthetic.uv_sphere``."""
    i = np.arange(n_lat + 1, dtype=np.float64)[:, None]
    j = np.arange(n_lon, dtype=np.float64)[None, :]
    th, ph = np.pi * i / n_lat, 2 * np.pi * j / n_lon
    shape = (n_lat + 1, n_lon)
    verts = np.stack([radius * np.sin(th) * np.cos(ph),
                      radius * np.sin(th) * np.sin(ph),
                      np.broadcast_to(radius * np.cos(th), shape)], axis=-1)
    verts = verts.reshape(-1, 3).astype(np.float32)
    ii = np.arange(n_lat)[:, None]
    jj = np.arange(n_lon)[None, :]
    a = ii * n_lon + jj
    b = ii * n_lon + (jj + 1) % n_lon
    c = (ii + 1) * n_lon + jj
    d = (ii + 1) * n_lon + (jj + 1) % n_lon
    upper = np.stack([a, c, b], -1)  # the row's first triangle, i > 0
    lower = np.stack([b, c, d], -1)  # its second, i < n_lat - 1
    pair = np.stack([upper, lower], axis=2)  # (n_lat, n_lon, 2, 3)
    keep = np.ones((n_lat, n_lon, 2), bool)
    keep[0, :, 0] = False
    keep[n_lat - 1, :, 1] = False
    tris = pair[keep].astype(np.uint32)
    return verts, tris


def orbit_poses(n_frames: int):
    """World→camera (q, t) per frame, float32: the camera turns 0.01 rad a
    frame about y at distance 4 (``synthetic.orbit_poses``)."""
    poses = []
    for f in range(n_frames):
        ang = 0.01 * f
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0], np.float32)
        t = np.array([0.05 * np.sin(0.05 * f), 0.02 * f / n_frames, 4.0],
                     np.float32)
        poses.append((q, t))
    return poses


def quat_to_mat(q) -> np.ndarray:
    """(4,) WXYZ quaternion → 3×3 rotation, float64."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def project(X, q, t, focal, cx, cy):
    """World points (n, 3) → pixels (n, 2) and camera depths (n,),
    float64."""
    Z = X @ quat_to_mat(q).T + np.asarray(t, np.float64)
    return np.stack([focal * Z[:, 0] / Z[:, 2] + cx,
                     focal * Z[:, 1] / Z[:, 2] + cy], -1), Z[:, 2]


class Surface:
    """A mesh's triangles as float64 corners, their normals and the
    cumulative area by which points are drawn."""

    def __init__(self, verts, tris):
        v = verts.astype(np.float64)
        self.a, self.b, self.c = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
        self.normal = np.cross(self.b - self.a, self.c - self.a)
        self.area = np.linalg.norm(self.normal, axis=1)
        self.cdf = np.cumsum(self.area)


def sample_keypoints(surf: Surface, q, t, focal, width, height, n, rng,
                     min_facing_cos):
    """``n`` points on the mesh seen from camera (q, t): (n, 3) float64
    world points and their (n, 2) float64 pixels."""
    a, b, c, normal, area, cdf = (surf.a, surf.b, surf.c, surf.normal,
                                  surf.area, surf.cdf)
    center = -(quat_to_mat(q).T @ np.asarray(t, np.float64))
    pts, pix = [], []
    got = 0
    while got < n:
        m = 4 * n
        tri = np.searchsorted(cdf, rng.uniform(0.0, cdf[-1], m), side="right")
        tri = np.minimum(tri, len(cdf) - 1)
        r1, r2 = rng.uniform(size=m), rng.uniform(size=m)
        s = np.sqrt(r1)
        X = ((1 - s)[:, None] * a[tri] + (s * (1 - r2))[:, None] * b[tri]
             + (s * r2)[:, None] * c[tri])
        view = center - X
        facing = (np.sum(normal[tri] * view, axis=1)
                  > min_facing_cos * area[tri] * np.linalg.norm(view, axis=1))
        p, z = project(X, q, t, focal, width / 2.0, height / 2.0)
        inside = ((z > 0) & (p[:, 0] > 0) & (p[:, 0] < width)
                  & (p[:, 1] > 0) & (p[:, 1] < height))
        keep = np.nonzero(facing & inside)[0][: n - got]
        pts.append(X[keep])
        pix.append(p[keep])
        got += keep.size
    return np.concatenate(pts), np.concatenate(pix)


def make_scene(config: dict, seed: int) -> Scene:
    """The inputs of ``config`` for ``seed``."""
    clip, mesh = config["clip"], config["mesh"]
    verts, tris = uv_sphere(*mesh["uv_sphere"], mesh.get("radius", 1.0))
    n = clip["frames"]
    focal, width, height = clip["focal_px"], clip["width"], clip["height"]
    poses = orbit_poses(n)
    surf = Surface(verts, tris)
    kps, pts = [], []
    for i, (q, t) in enumerate(poses):
        X, p = sample_keypoints(surf, q, t, focal, width, height,
                                config["keypoints_per_frame"],
                                rng_for(seed, 1, i), config["min_facing_cos"])
        kps.append(p.astype(np.float32))
        pts.append(X)
    flows = {}
    for i in range(n):
        rng = rng_for(seed, 2, i)
        for s in config["skips"]:
            j = i + s
            if not 0 <= j < n:
                continue
            p, z = project(pts[i], *poses[j], focal, width / 2.0,
                           height / 2.0)
            inb = ((z > 0) & (p[:, 0] > 0) & (p[:, 0] < width)
                   & (p[:, 1] > 0) & (p[:, 1] < height))
            idx = np.nonzero(inb)[0].astype(np.uint32)
            noise = rng.normal(0.0, config["flow_noise_px"], (idx.size, 2))
            flows[(i, j)] = (idx, (p[inb] + noise).astype(np.float32))
    return Scene(verts, tris, poses, float(focal), int(width), int(height),
                 kps, flows)


def write_db(scene: Scene, path: str) -> None:
    """Write the scene's keypoints and flows into a new flow DB at
    ``path``, in one transaction."""
    conn = sqlite3.connect(path)
    try:
        for p in _PRAGMAS:
            conn.execute(p)
        for s in _SCHEMA:
            conn.execute(s)
        conn.executemany(
            "INSERT INTO keypoints(image_id, rows, keypoints) VALUES(?, ?, ?)",
            [(i, k.shape[0], np.ascontiguousarray(k, np.float32).tobytes())
             for i, k in enumerate(scene.kps)])
        conn.executemany(
            "INSERT INTO optical_flow(image_id_from, image_id_to, rows,"
            " src_keypoints_indices, tgt_keypoints, flow_errors)"
            " VALUES(?, ?, ?, ?, ?, ?)",
            [(i, j, idx.shape[0], idx.astype(np.uint32).tobytes(),
              np.ascontiguousarray(tgt, np.float32).tobytes(),
              np.zeros(idx.shape[0], np.float32).tobytes())
             for (i, j), (idx, tgt) in scene.flows.items()])
        conn.commit()
    finally:
        conn.close()
