"""K1's time per solve in a checkout of this repository, on a CUDA card.

Usage, on a machine with a CUDA card, once per checkout to compare:

    python3 polychase_tpu_torch/k1_compare.py ROOT

ROOT is the root of a checkout (``.``, or a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists).  The script
imports ``polychase_tpu_torch`` from ROOT, so it builds and times that
checkout's K1 through its ``solve_arrays_lm``, on the same seeded scenes
(ROOT's ``synthetic.pnp_scene``, or the ``chip_smoke.pnp_scene`` it had
before) and with one harness: ``event_ms`` of the ``timing.py`` beside
this script, CUDA events around 50 calls queued behind a device sleep, so
that the time is the device's and not the wrapper's host side.  Prints the
card, then one line per case.  Run it for two checkouts in turns (A, B, B,
A) within one call to compare them.
"""

from __future__ import annotations

import runpy
import subprocess
import sys
from pathlib import Path

REPS = 50


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device; this runs only on a GPU")
    from polychase_tpu_torch.engine.levmarq import BundleOptions
    from polychase_tpu_torch.kernels.pnp_lm import solve_arrays_lm

    try:
        from polychase_tpu_torch.synthetic import pnp_scene
    except ImportError:
        from chip_smoke import pnp_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; checkout {root}")
    device = torch.device("cuda")
    # timing.py beside this script (it imports nothing of the port), so
    # that every checkout is timed by one harness.
    event_ms = runpy.run_path(Path(__file__).with_name("timing.py"))[
        "event_ms"]
    rng = np.random.default_rng(0)
    huber = BundleOptions(max_iterations=50, loss_type=1, function_tol=1e-5)
    for label, S, n, opt, opts in (
            ("N=8192, 6 params, Huber, ftol 1e-5", 1, 8192, False, huber),
            ("N=16384, 6 params, Huber, ftol 1e-5", 1, 16384, False, huber),
            ("N=16384, 9 params, Huber, ftol 1e-5", 1, 16384, True, huber),
            ("batch of 8, N=16384, 6 params, Huber", 8, 16384, False, huber),
            ("N=8, 9 params, Trivial (a pin drag)", 1, 8, True,
             BundleOptions(loss_type=0))):
        scenes = [pnp_scene(rng, n, f_err=0.95 if opt else 1.0)
                  for _ in range(S)]
        args = [torch.as_tensor(np.stack([s[i] for s in scenes]), device=device)
                for i in range(5)]
        kw = dict(opt_f=opt, opt_pp=False, opts=opts)
        out = solve_arrays_lm(*args, **kw).cpu().numpy()
        ms = event_ms(lambda: solve_arrays_lm(*args, **kw), REPS)
        print(f"  {label}: {ms:.4f} ms per solve, iterations "
              f"{out[:, 11].astype(int).tolist()}")


if __name__ == "__main__":
    main()
