"""GPU overlay rendering for pin mode
(rebuild of blender_addon/operators/pin_mode/rendering.py).

Matches the reference renderer's visual semantics
(reference rendering.py:63-107, 280-330):

- a **depth prepass** draws the mesh solid (color alpha 0, depth writes
  on) so the wireframe is occluded by the mesh's own front surfaces, and
  masked triangles are tinted in the same pass via a **UBO bitmask
  indexed by gl_PrimitiveID**;
- the wireframe then draws with a small negative depth bias under
  LESS_EQUAL depth testing (no Z-fighting, correct self-occlusion);
- pins are round anti-aliased point sprites drawn with depth testing
  off (always visible, like the reference);
- the mask brush paints a screen-space selection circle.
"""

from __future__ import annotations

import functools

import numpy as np

import bpy
import gpu
from gpu_extras.batch import batch_for_shader

# uvec4[1024] = 4096 u32 words = 131072 triangle bits (reference
# rendering.py:96 typedef MaskData)
_MASK_WORDS = 4096


@functools.cache
def _wireframe_shader() -> gpu.types.GPUShader:
    """Wireframe/prepass shader with per-primitive mask tint
    (reference rendering.py:63-107)."""
    info = gpu.types.GPUShaderCreateInfo()
    info.vertex_source(
        """
    void main()
    {
        vec4 clip = mvp * vec4(position, 1.0);
        clip.z += bias * clip.w;   /* wireframe depth bias */
        gl_Position = clip;
    }
    """
    )
    info.fragment_source(
        """
    void main()
    {
        /* One bit per triangle, little-endian within each u32, u32s
           packed 4-per-uvec4 (the engine's geometry.py bitmask layout):
           u32 index = prim >> 5, then row = index >> 2, lane = index & 3. */
        bool masked = false;
        if (useMask) {
            uint prim = uint(gl_PrimitiveID);
            uint word = prim >> 5u;
            uint bits = u_maskData.data[word >> 2u][word & 3u];
            masked = ((bits >> (prim & 31u)) & 1u) != 0u;
        }
        fragColor = masked ? mask_color : color;
    }
    """
    )
    info.typedef_source("struct MaskData { uvec4 data[1024]; };")
    info.vertex_in(0, "VEC3", "position")
    info.fragment_out(0, "VEC4", "fragColor")
    info.push_constant("MAT4", "mvp")
    info.push_constant("VEC4", "color")
    info.push_constant("VEC4", "mask_color")
    info.push_constant("FLOAT", "bias")
    info.push_constant("BOOL", "useMask")
    info.uniform_buf(0, "MaskData", "u_maskData")
    return gpu.shader.create_from_info(info)


@functools.cache
def _pin_shader() -> gpu.types.GPUShader:
    info = gpu.types.GPUShaderCreateInfo()
    info.vertex_source(
        """
    void main()
    {
        gl_PointSize = point_size;
        gl_Position = mvp * vec4(position, 1.0);
    }
    """
    )
    info.fragment_source(
        """
    void main()
    {
        vec2 d = gl_PointCoord - vec2(0.5);
        float r = length(d) * 2.0;
        float alpha = 1.0 - smoothstep(0.85, 1.0, r);
        if (alpha <= 0.0) { discard; }
        fragColor = vec4(color.rgb, color.a * alpha);
    }
    """
    )
    info.vertex_in(0, "VEC3", "position")
    info.fragment_out(0, "VEC4", "fragColor")
    info.push_constant("MAT4", "mvp")
    info.push_constant("FLOAT", "point_size")
    info.push_constant("VEC4", "color")
    return gpu.shader.create_from_info(info)


@functools.cache
def _circle_shader() -> gpu.types.GPUShader:
    """Screen-space selection circle (reference rendering.py:110-139)."""
    info = gpu.types.GPUShaderCreateInfo()
    info.vertex_source(
        """
    void main()
    {
        gl_Position = vec4(position.xy, 0.0, 1.0);
    }
    """
    )
    info.fragment_source(
        """
    void main()
    {
        const float kRing = 1.5f;
        float r = distance(gl_FragCoord.xy, center);
        float t = abs(r - radius);
        if (t >= kRing) { discard; }
        fragColor = vec4(vec3(1.0), 1.0 - t / kRing);
    }
    """
    )
    info.vertex_in(0, "VEC2", "position")
    info.push_constant("VEC2", "center")
    info.push_constant("FLOAT", "radius")
    info.fragment_out(0, "VEC4", "fragColor")
    return gpu.shader.create_from_info(info)


class PinModeRenderer:
    """Owns GPU resources + the draw handler for one pin-mode session."""

    def __init__(self, tracker_props, engine_tracker):
        self._handler = None
        self._pins_batch = None
        self._sel_batch = None
        self._wire_batch = None
        self._depth_batch = None
        self._mask_ubo = None
        self._mask_circle = None  # (x, y, radius) while mask-painting
        self.update_geometry(engine_tracker)
        self._tracker_id = tracker_props.id

    # -- geometry upload ----------------------------------------------------

    def update_geometry(self, engine_tracker) -> None:
        mesh = (
            engine_tracker.accel_mesh.inner()
            if engine_tracker and engine_tracker.accel_mesh else None
        )
        if mesh is None:
            self._wire_batch = None
            self._depth_batch = None
            return
        shader = _wireframe_shader()
        verts = mesh.vertices
        tris = mesh.triangles.astype(np.int32)
        edges = np.concatenate(
            [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]
        )
        self._wire_batch = batch_for_shader(
            shader, "LINES", {"position": verts}, indices=edges,
        )
        # Solid prepass batch: fills the Z-buffer and tints masked tris
        self._depth_batch = batch_for_shader(
            shader, "TRIS", {"position": verts}, indices=tris,
        )
        self.update_mask(mesh)

    def update_mask(self, mesh) -> None:
        """(Re)upload the packed triangle mask into the UBO."""
        bits = np.zeros(_MASK_WORDS, np.uint32)
        src = np.asarray(mesh.masked_triangles, np.uint32).reshape(-1)
        n = min(src.size, _MASK_WORDS)
        bits[:n] = src[:n]
        self._mask_ubo = gpu.types.GPUUniformBuf(bits.tobytes())

    def update_pins(self, points: np.ndarray) -> None:
        self._pin_points = points
        if points is None or len(points) == 0:
            self._pins_batch = None
            return
        self._pins_batch = batch_for_shader(
            _pin_shader(), "POINTS", {"position": points}
        )

    def set_mask_circle(self, circle) -> None:
        self._mask_circle = circle

    # -- draw handler -------------------------------------------------------

    def install(self, tracker_props) -> None:
        self._props_name = tracker_props.name
        self._handler = bpy.types.SpaceView3D.draw_handler_add(
            self._draw, (tracker_props,), "WINDOW", "POST_PIXEL"
        )

    def uninstall(self) -> None:
        if self._handler is not None:
            bpy.types.SpaceView3D.draw_handler_remove(
                self._handler, "WINDOW"
            )
            self._handler = None

    def _draw(self, tracker_props) -> None:
        context = bpy.context
        rv3d = context.region_data
        if rv3d is None or tracker_props.geometry is None:
            return
        model = tracker_props.geometry.matrix_world
        mvp = rv3d.perspective_matrix @ model

        self._draw_wireframe(mvp, tracker_props)
        self._draw_pins(mvp, tracker_props)
        if self._mask_circle is not None:
            self._draw_circle(*self._mask_circle)
        gpu.state.blend_set("NONE")
        gpu.state.depth_mask_set(False)
        gpu.state.depth_test_set("NONE")

    def _draw_wireframe(self, mvp, tracker_props) -> None:
        """Depth prepass with mask tint, then the biased wireframe
        (reference rendering.py:295-323)."""
        if self._depth_batch is None or self._mask_ubo is None:
            return
        shader = _wireframe_shader()

        gpu.state.depth_mask_set(True)
        gpu.state.depth_test_set("LESS_EQUAL")
        gpu.state.blend_set("ALPHA")

        shader.bind()
        shader.uniform_float("mvp", mvp)
        shader.uniform_float("bias", 0.0)
        shader.uniform_float("color", (0.0, 0.0, 0.0, 0.0))
        shader.uniform_float(
            "mask_color", tuple(tracker_props.masked_color)
        )
        shader.uniform_bool("useMask", True)
        shader.uniform_block("u_maskData", self._mask_ubo)
        self._depth_batch.draw(shader)

        if self._wire_batch is not None:
            gpu.state.depth_mask_set(False)
            gpu.state.line_width_set(1.0)
            shader.uniform_float("bias", -1e-4)
            shader.uniform_float(
                "color", tuple(tracker_props.wireframe_color)
            )
            shader.uniform_bool("useMask", False)
            self._wire_batch.draw(shader)

    def _draw_pins(self, mvp, tracker_props) -> None:
        if self._pins_batch is None:
            return
        shader = _pin_shader()
        gpu.state.depth_test_set("NONE")
        gpu.state.depth_mask_set(False)
        gpu.state.blend_set("ALPHA")
        gpu.state.program_point_size_set(True)
        shader.bind()
        shader.uniform_float("mvp", mvp)
        shader.uniform_float(
            "point_size", float(tracker_props.pin_radius) * 2.0
        )
        shader.uniform_float("color", tuple(tracker_props.pin_color))
        self._pins_batch.draw(shader)

        # Selected pin redrawn on top in its own color (reference
        # rendering.py: per-pin default/selected colors).  The batch is
        # cached: this runs on every viewport redraw.
        sel = int(getattr(tracker_props, "selected_pin", -1))
        pts = getattr(self, "_pin_points", None)
        if pts is not None and 0 <= sel < len(pts):
            key = (sel, id(pts))
            if getattr(self, "_sel_key", None) != key:
                self._sel_key = key
                self._sel_batch = batch_for_shader(
                    shader, "POINTS", {"position": [tuple(pts[sel])]}
                )
            shader.uniform_float(
                "color", tuple(tracker_props.selected_pin_color)
            )
            self._sel_batch.draw(shader)

    def draw_selected_pin(self, tracker_props, point) -> None:
        shader = _pin_shader()
        batch = batch_for_shader(
            shader, "POINTS", {"position": [tuple(point)]}
        )
        shader.bind()
        shader.uniform_float(
            "color", tuple(tracker_props.selected_pin_color)
        )
        batch.draw(shader)

    def _draw_circle(self, x, y, radius) -> None:
        shader = _circle_shader()
        # Full-screen quad in clip space; the fragment shader cuts the ring
        quad = np.array(
            [[-1, -1], [1, -1], [1, 1], [-1, -1], [1, 1], [-1, 1]],
            np.float32,
        )
        batch = batch_for_shader(shader, "TRIS", {"position": quad})
        gpu.state.blend_set("ALPHA")
        shader.bind()
        shader.uniform_float("center", (float(x), float(y)))
        shader.uniform_float("radius", float(radius))
        batch.draw(shader)
