"""Drop-in ``polychase_core`` module of the port.

Importing this module gives the surface of the reference's pybind11
extension (cpp/polychase_pybind.cc): all value/option classes, the three
worker threads with their message types and the five free functions, and
the reference's extensions (``device_count``, ``refine_segments``,
``track_segments``, ``RefineSegmentsThread``).  Each function and thread
takes a keyword-only ``device``, the card when left out (every card for the
segment-parallel ones).  The Blender addon can alias it::

    import polychase_tpu_torch.polychase_core as polychase_core
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all
from .runtime.threads import (  # noqa: F401
    OpticalFlowProgress,
    OpticalFlowRequest,
    OpticalFlowThread,
    RefinerThread,
    RefineSegmentsThread,
    TrackerThread,
)

__all__ = list(_api_all) + [
    "OpticalFlowProgress",
    "OpticalFlowRequest",
    "OpticalFlowThread",
    "RefinerThread",
    "RefineSegmentsThread",
    "TrackerThread",
]
