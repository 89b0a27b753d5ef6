"""The worker threads of the public surface (``threads``)."""

from .threads import (  # noqa: F401
    OpticalFlowProgress,
    OpticalFlowRequest,
    OpticalFlowThread,
    RefinerThread,
    TrackerThread,
)
