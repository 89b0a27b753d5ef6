"""polychase_tpu_torch — the PyTorch + CUDA port of polychase_tpu.

The JAX package ``polychase_tpu`` is the reference; this package mirrors its
layout so each module has a counterpart of the same name:

- ``engine/``   plain torch math and solvers (pose, camera, geometry, LM,
                PnP, ray cast, the tracking chain, analyze, refine, pin
                mode)
- ``kernels/``  Python wrappers of the hand-written CUDA kernels
- ``csrc/``     the CUDA C++ sources, built with nvcc at first use
- ``io``        the SQLite flow DB (the reference's schema and API)
- ``native``    host C++ (BVH ray caster, GFTT suppression), built with g++
                at first use
- ``convert``   turns the JAX package's state (as numpy) into this one's
- ``synthetic`` seeded scenes without JAX (clips, flow DBs, pins)
- ``crossover`` measures refine's and pin mode's route crossovers on a card

The package imports neither jax nor any module of ``polychase_tpu``: it
keeps its own copies of what it needs (``io.database``, ``native``), and
shares nothing with the JAX package but the tests.

Every entry point takes an explicit ``device``.  The device of the tensors
chooses the arm: CPU tensors run the plain torch version of a kernel, CUDA
tensors launch the hand-written kernel (or raise).
"""

from . import backend  # noqa: F401  (sets the f32 matmul/conv precision)

__version__ = "0.1.0"
