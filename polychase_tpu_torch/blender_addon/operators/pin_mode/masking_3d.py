"""3D mask painting via an offscreen triangle-ID pass
(rebuild of blender_addon/operators/pin_mode/masking_3d.py).

Renders ``gl_PrimitiveID`` as RGBA8 into an offscreen buffer at the
viewport resolution, reads it back once per stroke, and maps
mouse+radius → triangle ids → whole polygons (contiguous triangle runs).
"""

from __future__ import annotations

import numpy as np

import gpu
from gpu_extras.batch import batch_for_shader


_ID_VERT = """
uniform mat4 mvp;
in vec3 position;
void main() { gl_Position = mvp * vec4(position, 1.0); }
"""

_ID_FRAG = """
out vec4 fragColor;
void main() {
    int id = gl_PrimitiveID + 1;  // 0 = background
    fragColor = vec4(
        float(id & 0xFF) / 255.0,
        float((id >> 8) & 0xFF) / 255.0,
        float((id >> 16) & 0xFF) / 255.0,
        float((id >> 24) & 0xFF) / 255.0);
}
"""


class Masking3DSelector:
    """Triangle picking buffer for one viewport size."""

    def __init__(self):
        self._shader = gpu.types.GPUShader(_ID_VERT, _ID_FRAG)
        self._offscreen = None
        self._size = (0, 0)
        self._id_buffer = None

    def free(self):
        if self._offscreen is not None:
            self._offscreen.free()
            self._offscreen = None
        self._id_buffer = None

    def _ensure_offscreen(self, width, height):
        if self._offscreen is None or self._size != (width, height):
            self.free()
            self._offscreen = gpu.types.GPUOffScreen(width, height)
            self._size = (width, height)

    def render_ids(self, engine_tracker, tracker_props, region, rv3d) -> None:
        """Rasterize triangle ids for the current view."""
        mesh = engine_tracker.accel_mesh.inner()
        width, height = region.width, region.height
        self._ensure_offscreen(width, height)

        model = tracker_props.geometry.matrix_world
        mvp = rv3d.perspective_matrix @ model
        batch = batch_for_shader(
            self._shader, "TRIS",
            {"position": mesh.vertices},
            indices=mesh.triangles.astype(np.int32),
        )
        with self._offscreen.bind():
            fb = gpu.state.active_framebuffer_get()
            fb.clear(color=(0.0, 0.0, 0.0, 0.0), depth=1.0)
            gpu.state.depth_test_set("LESS")
            gpu.state.depth_mask_set(True)
            self._shader.bind()
            self._shader.uniform_float("mvp", mvp)
            batch.draw(self._shader)
            gpu.state.depth_test_set("NONE")

            buf = fb.read_color(0, 0, width, height, 4, 0, "UBYTE")
        data = np.frombuffer(
            np.asarray(buf.to_list(), np.uint8).tobytes(), np.uint8
        ).reshape(height, width, 4)
        ids = (
            data[:, :, 0].astype(np.uint32)
            | (data[:, :, 1].astype(np.uint32) << 8)
            | (data[:, :, 2].astype(np.uint32) << 16)
            | (data[:, :, 3].astype(np.uint32) << 24)
        )
        self._id_buffer = ids  # 0 = background, else triangle_id + 1

    def triangles_under_brush(self, x, y, radius) -> np.ndarray:
        """Triangle ids within ``radius`` px of (x, y) (region coords)."""
        if self._id_buffer is None:
            return np.empty(0, np.int64)
        h, w = self._id_buffer.shape
        xi, yi = int(round(x)), int(round(y))
        r = int(np.ceil(radius))
        x0, x1 = max(0, xi - r), min(w, xi + r + 1)
        y0, y1 = max(0, yi - r), min(h, yi + r + 1)
        if x0 >= x1 or y0 >= y1:
            return np.empty(0, np.int64)
        window = self._id_buffer[y0:y1, x0:x1]
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = (xx - x) ** 2 + (yy - y) ** 2 <= radius * radius
        ids = np.unique(window[inside])
        ids = ids[ids != 0] - 1
        return ids.astype(np.int64)
