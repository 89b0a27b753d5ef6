"""The pin route scan behind ``pinmode.HOST_PIN_MAX`` of the port.

Config 2's scene (the 24×32 sphere from the orbit clip's first frame,
1920×1080, f = 1800), n surface pins, pin 2 dragged as config 2 drags it,
Camera type, the focal fixed and free, 4 seeds per size.  Each ≥ 3-pin drag
is solved by the JAX package's facade at its default (the float64 host
route up to 4096 points) and by three others, forced onto one route: the
JAX package's device route, the port's device route (its plain torch
solve, float32) and the port's host route (float64).  Prints, per size, the
largest view-matrix difference of each from the reference's default, and
the port's host route's median wall time on this machine.

Runs on the CPU, with both packages importable, from the repo root:

    JAX_PLATFORMS=cpu python tests/pin_route_scan.py [n ...]
"""

import os
import sys
import time

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import polychase_tpu.polychase_core as jpc  # noqa: E402
import polychase_tpu_torch.polychase_core as pc  # noqa: E402
from polychase_tpu_torch.engine import pinmode  # noqa: E402
from polychase_tpu_torch.engine.geometry import Mesh  # noqa: E402
from polychase_tpu_torch.engine.pose import quat_to_mat_np  # noqa: E402
from polychase_tpu_torch.synthetic import (  # noqa: E402
    orbit_poses, surface_pins, uv_sphere,
)

COUNTS = (3, 4, 5, 6, 7, 8, 12, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def main(counts):
    torch.set_num_threads(1)
    q, t = orbit_poses(1)[0]
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = quat_to_mat_np(q)
    view[:3, 3] = t
    mesh = Mesh.create(*uv_sphere(24, 32), device="cpu")

    def drag(mod, pins, opt_f, **kw):
        scene = mod.SceneTransformations(
            np.eye(4, dtype=np.float32), view,
            mod.CameraIntrinsics(1800, 1800, 960, 540, 1, 1920, 1080,
                                 mod.CameraConvention.OpenCV))
        return mod.find_transformation(
            pins, scene, scene,
            mod.PinUpdate(2, np.array([955.0, 542.0], np.float32)),
            mod.TransformationType.Camera, opt_f, False, **kw).view_matrix

    default = pinmode.HOST_PIN_MAX
    print(f"port's HOST_PIN_MAX = {default}; largest |view - reference "
          f"default| over 4 seeds")
    try:
        for opt_f in (False, True):
            for n in counts:
                worst = dict(ref_dev=0.0, port_dev=0.0, port_host=0.0)
                host_s = []
                for seed in range(4):
                    pins = surface_pins(mesh, (q, t), 1800.0, 1920, 1080,
                                        np.random.default_rng(100 * n + seed),
                                        n)
                    os.environ.pop("POLYCHASE_HOST_PIN_MAX", None)
                    ref = drag(jpc, pins, opt_f)
                    os.environ["POLYCHASE_HOST_PIN_MAX"] = "0"
                    got = {"ref_dev": drag(jpc, pins, opt_f)}
                    pinmode.HOST_PIN_MAX = 0
                    got["port_dev"] = drag(pc, pins, opt_f, device="cpu")
                    pinmode.HOST_PIN_MAX = 1 << 30
                    t0 = time.perf_counter()
                    got["port_host"] = drag(pc, pins, opt_f, device="cpu")
                    host_s.append(time.perf_counter() - t0)
                    for k, v in got.items():
                        worst[k] = max(worst[k], float(np.abs(v - ref).max()))
                print(f"  opt_f={opt_f!s:5} n={n:5d}: reference device "
                      f"{worst['ref_dev']:.3g}, port device "
                      f"{worst['port_dev']:.3g}, port host "
                      f"{worst['port_host']:.3g}; port host route "
                      f"{np.median(host_s) * 1e3:.2f} ms", flush=True)
    finally:
        os.environ.pop("POLYCHASE_HOST_PIN_MAX", None)
        pinmode.HOST_PIN_MAX = default


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or COUNTS)
