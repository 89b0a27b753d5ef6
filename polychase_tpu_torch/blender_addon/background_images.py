"""Camera background images backed by the movie clip
(rebuild of blender_addon/background_images.py).

Two kinds of backgrounds are used:

- a MOVIE_CLIP background as the user-facing preview;
- an IMAGE background whose Image datablock points at the clip's file —
  this is the pixel source the analyze operator samples per frame (an
  Image exposes ``pixels`` per frame via its image_user; a MovieClip
  does not).
"""

from __future__ import annotations

import os
import re

import bpy


def guess_frame_offset(clip) -> int:
    """For image sequences, the number embedded in the first filename
    (reference background_images.py:12-18)."""
    if clip.source != "SEQUENCE":
        return 0
    name = os.path.basename(clip.filepath)
    m = re.search(r"(\d+)(?=\.[^.]+$)", name)
    return int(m.group(1)) - 1 if m else 0


def find_background_image_for_clip(camera_data, clip):
    """Any background (clip or image) that displays this clip."""
    for bg in camera_data.background_images:
        if bg.source == "MOVIE_CLIP" and bg.clip == clip:
            return bg
        if (
            bg.source == "IMAGE"
            and bg.image is not None
            and bg.image.filepath == clip.filepath
        ):
            return bg
    return None


def create_background_image_for_clip(camera_data, clip, alpha=1.0):
    """Create an IMAGE background backed by the clip's file
    (reference background_images.py:33-60).  Returns (background, image)."""
    image_source = bpy.data.images.new(
        f"polychase_source_{clip.name}",
        width=clip.size[0],
        height=clip.size[1],
        alpha=False,
    )
    image_source.source = clip.source  # MOVIE or SEQUENCE
    image_source.filepath = clip.filepath
    image_source.use_view_as_render = True

    bg = camera_data.background_images.new()
    bg.source = "IMAGE"
    bg.image = image_source
    bg.alpha = alpha
    bg.frame_method = "STRETCH"

    user = bg.image_user
    user.frame_start = clip.frame_start
    user.frame_duration = clip.frame_duration
    user.frame_offset = guess_frame_offset(clip)
    user.use_auto_refresh = True

    camera_data.show_background_images = True
    return bg, image_source


def get_image_user_for_image(camera_data, image):
    for bg in camera_data.background_images:
        if bg.source == "IMAGE" and bg.image == image:
            return bg.image_user
    return None


def setup_background_for_clip(camera_obj, clip):
    """Ensure the camera previews the clip (MOVIE_CLIP background)."""
    data = camera_obj.data
    for bg in data.background_images:
        if bg.source == "MOVIE_CLIP" and bg.clip == clip:
            break
    else:
        bg = data.background_images.new()
        bg.source = "MOVIE_CLIP"
        bg.clip = clip
    bg.alpha = 1.0
    bg.frame_method = "STRETCH"
    data.show_background_images = True
    return bg
