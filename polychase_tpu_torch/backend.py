"""Device and precision rules shared by the whole port.

TF32 is turned off for matmuls and cuDNN convolutions.  The reference runs
every small contraction at ``Precision.HIGHEST`` (true f32,
``polychase_tpu/engine/raycast.py:325``): pose Jacobians, ray transforms and
the normal equations lose about three decimal digits in TF32, which moves
PnP solves and ray-cast hits by more than the parity tolerances allow.
PyTorch leaves cuDNN convolutions in TF32 by default, so both flags are set
here, once, when the package is imported.
"""

from __future__ import annotations

import contextlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def as_device(device) -> torch.device:
    """Normalise a user-supplied device.  There is no default: callers
    always say where the work runs."""
    if device is None:
        raise ValueError("an explicit device is required")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" means the current card; tensors always carry an index.
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def require_cuda() -> torch.device:
    """The CUDA device, or an error when this process has no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to this process")
    return torch.device("cuda", torch.cuda.current_device())


def surface_device(device=None) -> torch.device:
    """The device of a public entry point (``api``, its worker threads, the
    CLI): ``None`` means the card, and without one this raises
    ``RuntimeError``; nothing falls back to the CPU.  A CUDA device comes
    back with its index, so a worker thread, whose current device is 0,
    runs where its caller asked."""
    if device is None or torch.device(device).type == "cuda":
        require_cuda()
    return as_device(torch.device("cuda") if device is None else device)


def surface_devices(device=None):
    """The devices of an entry point that splits its work over several
    (analyze, refine, the segment-parallel calls): ``None`` means every
    visible card (one card is a list of one), and without one this raises
    ``RuntimeError``; else one device or a sequence of them, each as
    :func:`surface_device` gives it.  Returns one device or a list."""
    if device is None:
        require_cuda()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(device, (list, tuple)):
        return [surface_device(d) for d in device]
    return surface_device(device)


def current(device: torch.device):
    """``device`` made the current CUDA device for the block (a kernel
    launches on the current device, whatever its tensors' device); nothing
    for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class HostCopy:
    """Device tensors on their way to the host.

    On a CUDA device the copies go into pinned buffers with
    ``non_blocking=True`` and one event is recorded behind them, so the
    host runs on until :meth:`numpy` waits on that event alone.  CPU
    tensors are already on the host.
    """

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            bufs = []
            for t in tensors:
                b = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                b.copy_(t, non_blocking=True)
                bufs.append(b)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
            tensors = tuple(bufs)
        self._tensors = tensors

    def numpy(self):
        """The tensors as numpy arrays, once their copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy() for t in self._tensors)

