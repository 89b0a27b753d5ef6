"""Polling a ``polychase_core`` worker thread in a test, for either package.

It imports neither jax nor torch, so the card tests, which run without
jax, share it with the CPU tests.
"""

import time

import pytest

DEADLINE_S = 60.0


def drain(thread, frames=None, on_request=None, errors=None):
    """Poll ``thread`` until its done message (``True``), join it, and
    return its other messages.  An exception message is raised unless
    ``errors`` collects it.  A frame request (``OpticalFlowRequest``) goes
    to ``on_request``, or else is served from ``frames``.  Past
    ``DEADLINE_S`` the thread is asked to stop and the test fails."""
    msgs = []
    deadline = time.monotonic() + DEADLINE_S
    while True:
        msg = thread.try_pop()
        if msg is None:
            if time.monotonic() > deadline:
                thread.request_stop()
                pytest.fail(f"no done message within {DEADLINE_S} s")
            time.sleep(0.005)
        elif isinstance(msg, bool):
            break
        elif isinstance(msg, Exception):
            if errors is None:
                raise msg
            errors.append(msg)
        elif type(msg).__name__ == "OpticalFlowRequest":
            if on_request is not None:
                on_request(msg)
            else:
                thread.provide_frame(msg.frame_id, frames[msg.frame_id])
        else:
            msgs.append(msg)
    thread.join()
    assert thread.empty()
    return msgs
