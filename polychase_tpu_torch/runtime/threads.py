"""Async worker threads with message queues: the reference's job layer.

Port of ``polychase_tpu/runtime/threads.py`` (cpp/{opticalflow,tracker,
refiner}_thread.h): each class spawns one worker thread in its
constructor, streams typed messages through a thread-safe queue
(``try_pop``/``empty``), supports cooperative cancellation
(``request_stop``) and joins on ``join``.

Message protocols (what ``try_pop`` yields) mirror the reference's
``std::variant`` alternatives:

- ``OpticalFlowThread``: OpticalFlowProgress | OpticalFlowRequest |
  bool (done) | Exception      (cpp/opticalflow_thread.h:30-33)
- ``TrackerThread``: FrameTrackingResult | bool | Exception
  (cpp/tracker_thread.h:16-17)
- ``RefinerThread``: RefineTrajectoryUpdate | bool | Exception
  (cpp/refiner_thread.h:15-16)
- ``RefineSegmentsThread`` (an extension): one RefineTrajectoryUpdate,
  then bool | Exception

A worker that fails puts its exception on the queue, then ``True``.

Each constructor takes a trailing keyword-only ``device``; ``None`` means
the card (every visible card for ``OpticalFlowThread``, ``RefinerThread``
and ``RefineSegmentsThread``, which split their work over a device list,
as the ``api`` functions they run do).  It is resolved on the caller's
thread, to an indexed device (a fresh thread's
current CUDA device is 0), and the worker runs with that device (the
first of them) current.  Without a card the worker's first message is the
:class:`~polychase_tpu_torch.api.CppException`, then ``True``.

``OpticalFlowThread`` requests frames from the UI thread: it pushes an
``OpticalFlowRequest`` and blocks on a condition variable (10 s timeout)
until ``provide_frame`` delivers the pixels; the frame is copied, so the
caller's buffer lifetime never matters (cpp/opticalflow_thread.h:120-164).
A 17-slot sequential ring (cpp/opticalflow_thread.h:34-79) sits in front
of the request; analyze's own frame caches cover its live window, so it
asks the ring for each frame once, in order.
"""

from __future__ import annotations

import queue
import threading
from typing import NamedTuple, Optional

import numpy as np

from .. import api
from ..backend import current, surface_device, surface_devices
from ..engine.opticalflow import FrameNotProvidedError as _FrameNotProvidedError


class OpticalFlowProgress(NamedTuple):
    progress: float
    progress_message: str


class OpticalFlowRequest(NamedTuple):
    frame_id: int


class _WorkerBase:
    """Common queue/thread plumbing shared by all four workers."""

    _resolve = staticmethod(surface_device)

    def __init__(self, device):
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._device_error: Optional[Exception] = None
        try:
            self._device = self._resolve(device)
        except RuntimeError as exc:
            self._device = None
            self._device_error = api.CppException(str(exc))

    def _start(self):
        self._thread.start()

    def _run(self):
        try:
            if self._device_error is not None:
                raise self._device_error
            first = (self._device[0] if isinstance(self._device, list)
                     else self._device)
            with current(first):
                self._work()
        except Exception as exc:  # marshalled like the C++ exception ptr
            self._queue.put(exc)
        self._queue.put(True)

    def request_stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        """True once a stop was requested (cooperative cancel)."""
        return self._stop.is_set()

    def join(self) -> None:
        if self._thread.is_alive():
            self._thread.join()

    def try_pop(self):
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def empty(self) -> bool:
        return self._queue.empty()

    def __del__(self):
        self._stop.set()


class _SequentialFrameCache:
    """17-slot ring cache over the frame accessor
    (cpp/opticalflow_thread.h:34-79)."""

    SIZE = 17

    def __init__(self, accessor):
        self._accessor = accessor
        self._frames = [None] * self.SIZE
        self._highest: Optional[int] = None
        self._invalid = False

    def __call__(self, frame_id: int):
        idx = frame_id % self.SIZE
        if self._highest is None:
            self._highest = frame_id
            self._frames[idx] = self._accessor(frame_id)
            return self._frames[idx]
        if frame_id <= self._highest:
            if self._highest - frame_id >= self.SIZE:
                raise RuntimeError("frame requested outside the ring cache")
            return self._frames[idx]
        if frame_id - self._highest >= self.SIZE:
            raise RuntimeError("non-sequential frame jump beyond cache size")
        for fid in range(self._highest + 1, frame_id + 1):
            if self._invalid:
                return None
            frame = self._accessor(fid)
            if frame is None:
                self._invalid = True
            self._frames[fid % self.SIZE] = frame
        self._highest = frame_id
        return self._frames[idx]


class OpticalFlowThread(_WorkerBase):
    """Analyze-video worker (cpp/opticalflow_thread.h:81-205)."""

    PROVIDE_TIMEOUT_S = 10.0
    _resolve = staticmethod(surface_devices)

    def __init__(
        self,
        video_info: "api.VideoInfo",
        database_path: str,
        detector_options: "api.GFTTOptions" = None,
        flow_options: "api.OpticalFlowOptions" = None,
        write_images: bool = False,
        *,
        device=None,
    ):
        super().__init__(device)
        self._video_info = video_info
        self._database_path = database_path
        self._detector_options = detector_options or api.GFTTOptions()
        self._flow_options = flow_options or api.OpticalFlowOptions()
        self._write_images = write_images

        self._provided_cv = threading.Condition(threading.Lock())
        self._provided: Optional[tuple] = None
        self._start()

    def provide_frame(self, frame_id: int, frame: np.ndarray) -> None:
        frame_copy = np.array(frame, copy=True)
        with self._provided_cv:
            self._provided = (int(frame_id), frame_copy)
            self._provided_cv.notify_all()

    def _request_frame(self, frame_id: int):
        self._queue.put(OpticalFlowRequest(frame_id=frame_id))
        with self._provided_cv:
            self._provided_cv.wait_for(
                lambda: self._provided is not None or self._stop.is_set(),
                timeout=self.PROVIDE_TIMEOUT_S,
            )
            if self._stop.is_set() or self._provided is None:
                return None  # stopped, or timed out
            fid, frame = self._provided
            self._provided = None
        if fid != frame_id:
            raise RuntimeError(f"Requested frame {frame_id} but got {fid}")
        return frame

    def _work(self):
        accessor = _SequentialFrameCache(self._request_frame)

        def progress(p: float, msg: str) -> bool:
            self._queue.put(
                OpticalFlowProgress(progress=p, progress_message=msg)
            )
            return not self._stop.is_set()

        try:
            api.generate_optical_flow_database(
                self._video_info,
                accessor,
                progress,
                self._database_path,
                self._detector_options,
                self._flow_options,
                self._write_images,
                device=self._device,
            )
        except Exception as exc:
            # A stop request unblocks a pending frame wait with no frame;
            # that is a clean cancel, not a failure (the reference's
            # cancel path, cpp/opticalflow.cc:238-247).  The API boundary
            # wraps engine errors in CppException, so check the chain.
            unprovided = isinstance(exc, _FrameNotProvidedError) or (
                isinstance(exc.__cause__, _FrameNotProvidedError)
            )
            if not (unprovided and self._stop.is_set()):
                raise


class TrackerThread(_WorkerBase):
    """Track-sequence worker (cpp/tracker_thread.h:19-101).

    Results arrive in runs of ``engine.tracker.FLUSH_FRAMES`` (32) frames,
    the granularity at which the device's results come to the host, and a
    stop request takes effect at the end of the current run."""

    def __init__(
        self,
        database_path: str,
        frame_from: int,
        frame_to_inclusive: int,
        scene_transform: "api.SceneTransformations",
        accel_mesh: "api.AcceleratedMesh",
        optimize_focal_length: bool,
        optimize_principal_point: bool,
        bundle_opts: "api.BundleOptions",
        *,
        device=None,
    ):
        super().__init__(device)
        self._args = (
            database_path, frame_from, frame_to_inclusive, scene_transform,
            accel_mesh, optimize_focal_length, optimize_principal_point,
            bundle_opts,
        )
        self._start()

    def _work(self):
        def cb(result: "api.FrameTrackingResult") -> bool:
            self._queue.put(result)
            return not self._stop.is_set()

        (database_path, frame_from, frame_to, scene, mesh, opt_f, opt_pp,
         bundle_opts) = self._args
        api.track_sequence(
            database_path, frame_from, frame_to, scene, mesh, cb,
            opt_f, opt_pp, bundle_opts, device=self._device,
        )


class RefinerThread(_WorkerBase):
    """Refine-trajectory worker (cpp/refiner_thread.h:18-96).

    The trajectory object is refined **in place**; read it after the
    ``True`` done message (matching the reference's shared_ptr).
    """

    _resolve = staticmethod(surface_devices)

    def __init__(
        self,
        database_path: str,
        camera_trajectory: "api.CameraTrajectory",
        model_matrix,
        mesh: "api.AcceleratedMesh",
        optimize_focal_length: bool,
        optimize_principal_point: bool,
        bundle_opts: "api.BundleOptions",
        *,
        device=None,
    ):
        super().__init__(device)
        self._args = (
            database_path, camera_trajectory, model_matrix, mesh,
            optimize_focal_length, optimize_principal_point, bundle_opts,
        )
        self._start()

    def _work(self):
        def cb(update: "api.RefineTrajectoryUpdate") -> bool:
            self._queue.put(update)
            return not self._stop.is_set()

        (database_path, traj, model_matrix, mesh, opt_f, opt_pp,
         bundle_opts) = self._args
        api.refine_trajectory(
            database_path, traj, model_matrix, mesh, opt_f, opt_pp, cb,
            bundle_opts, device=self._device,
        )


class RefineSegmentsThread(_WorkerBase):
    """Extension worker: refine many independent segments together
    (``api.refine_segments``), the segments split over the devices.

    Messages: one ``RefineTrajectoryUpdate`` (progress 0) then ``True``.
    Every trajectory is refined in place; read them after the done
    message.  A stop is coarse: the run goes to its end regardless, and a
    caller checks ``stopped`` on the done message and skips the results
    (the addon's refine-all does).
    """

    _resolve = staticmethod(surface_devices)

    def __init__(
        self,
        database_path: str,
        camera_trajectories,
        model_matrix,
        mesh: "api.AcceleratedMesh",
        optimize_focal_length: bool,
        optimize_principal_point: bool,
        bundle_opts: "api.BundleOptions",
        *,
        device=None,
    ):
        super().__init__(device)
        self._args = (
            database_path, camera_trajectories, model_matrix, mesh,
            optimize_focal_length, optimize_principal_point, bundle_opts,
        )
        self._start()

    def _work(self):
        (database_path, trajs, model_matrix, mesh, opt_f, opt_pp,
         bundle_opts) = self._args
        self._queue.put(
            api.RefineTrajectoryUpdate(
                progress=0.0,
                message=f"Refining {len(trajs)} segments in parallel",
            )
        )
        api.refine_segments(
            database_path, trajs, model_matrix, mesh, opt_f, opt_pp,
            bundle_opts, device=self._device,
        )
