"""Preset scenes. Mirrors pbrs_tpu/scene/presets.py; only the Cornell box
is ported so far (the CLI refuses every other name as not yet ported).
"""

from __future__ import annotations

from ..geometry import camera as cam_mod
from ..geometry import transform as tf
from .buffers import Scene, SceneBuilder


def cornell_box() -> Scene:
    """The 555-box with a quad light and two rotated cuboids."""
    b = SceneBuilder()
    red = b.materials.add_lambertian((0.65, 0.05, 0.05))
    white = b.materials.add_lambertian((0.73, 0.73, 0.73))
    green = b.materials.add_lambertian((0.12, 0.45, 0.15))
    light = b.materials.add_diffuse_light((15.0, 15.0, 15.0))

    g = b.geometry
    g.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    g.add_quad((0, 0, 0), (0, 0, 555), (0, 555, 0), red)
    g.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    g.add_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)  # floor
    g.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)  # ceiling
    g.add_quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)  # back

    t_short = tf.compose(tf.translate((265, 0, 105)), tf.rotate_y(15.0))
    g.add_cuboid((0, 0, 0), (165, 165, 165), white, transform=t_short)
    t_tall = tf.compose(tf.translate((130, 0, 225)), tf.rotate_y(-18.0))
    g.add_cuboid((0, 0, 0), (165, 330, 165), white, transform=t_tall)

    b.lights.add_area_quad((15.0, 15.0, 15.0), (213, 554, 227), (130, 0, 0),
                           (0, 0, 105))

    cam = cam_mod.make_camera((600, 600), 40.0)
    b.camera = cam_mod.looking_at(cam, (278, 278, -800), (278, 278, 0),
                                  (0, 1, 0))
    return b.build()


PRESETS = {"cornell_box": cornell_box}
