"""Preset scenes. Mirrors pbrs_tpu/scene/presets.py: cornell_box, quad,
quad_light, two_perlin_spheres, earth, mixed_spheres, plates, env_mapped,
the mesh scenes everything and mesh_ball, and fourier_plastic (measured
BSDFs). Presets whose upstream image or .bsdf assets are absent use
procedural stand-ins, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np

from ..geometry import camera as cam_mod
from ..geometry import transform as tf
from ..lights import lights as lt
from .buffers import Scene, SceneBuilder

WIDTH, HEIGHT = 800, 800

# Metal (eta, k) per RGB channel.
SILVER = ((0.155184, 0.116681, 0.138360), (4.828131, 3.122411, 2.147082))
ALUMINIUM = ((1.656937, 0.880173, 0.521201), (9.224230, 6.269670, 4.836996))
GOLD = ((0.143176, 0.373096, 1.443834), (3.982675, 2.387439, 1.602465))
COPPER = ((0.195470, 0.925682, 1.102186), (3.910869, 2.451263, 2.142653))

BLUE_SKY = lt.make_env_gradient(top=(0.5, 0.7, 1.0), bottom=(1.0, 1.0, 1.0))
DARK_ROOM = lt.make_env_gradient(top=(0.1, 0.1, 0.1), bottom=(0.1, 0.1, 0.1))


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


def quad() -> Scene:
    """One blue quad under a blue sky."""
    b = SceneBuilder()
    m = b.materials.add_lambertian((0.2, 0.3, 0.7))
    b.geometry.add_quad((-0.5, -0.3, 2.5), (1.0, 0, 0), (0, 0.9, 0), m)
    b.lights.env = BLUE_SKY
    b.camera = cam_mod.make_camera((WIDTH, HEIGHT), 45.0)
    return b.build()


def quad_light() -> Scene:
    """Perlin spheres under a quad + sphere light pair."""
    b = SceneBuilder()
    perlin = b.textures.add_perlin(4.0)
    m = b.materials.add_lambertian(tex_id=perlin)
    light_power = (4.0, 4.0, 4.0)
    light = b.materials.add_diffuse_light(light_power)

    g = b.geometry
    g.add_sphere((0, -1000, 0), 1000.0, m)
    g.add_sphere((0, 2, 0), 2.0, m)
    # new_xy((3,5),(1,3),2.1): origin (3,1,2.1), u=(2,0,0), v=(0,2,0)
    g.add_quad((3, 1, 2.1), (2, 0, 0), (0, 2, 0), light)
    g.add_sphere((0, 7, 0), 2.0, light)

    b.lights.add_area_quad(light_power, (3, 1, 2.1), (2, 0, 0), (0, 2, 0))
    b.lights.add_area_sphere(light_power, (0, 7, 0), 2.0)
    b.lights.env = DARK_ROOM

    cam = cam_mod.make_camera((WIDTH, HEIGHT), 20.0)
    b.camera = cam_mod.looking_at(cam, (26, 3, -6), (0, 2, 0), (0, 1, 0))
    return b.build()


def two_perlin_spheres() -> Scene:
    """Two Perlin-marble spheres under a blue sky."""
    b = SceneBuilder()
    perlin = b.textures.add_perlin(4.0)
    m = b.materials.add_lambertian(tex_id=perlin)
    b.geometry.add_sphere((0, -1000, 0), 1000.0, m)
    b.geometry.add_sphere((0, 2, 0), 2.0, m)
    b.lights.env = BLUE_SKY
    cam = cam_mod.make_camera((WIDTH, HEIGHT), 20.0)
    b.camera = cam_mod.looking_at(cam, (13, 2, -3), (0, 0, 0), (0, 1, 0))
    return b.build()


def earth() -> Scene:
    """A checkered globe (stand-in for the absent earth map)."""
    b = SceneBuilder()
    checker = b.textures.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    m = b.materials.add_lambertian(tex_id=checker)
    b.geometry.add_sphere((0, 0, 0), 2.0, m)
    b.lights.env = BLUE_SKY
    cam = cam_mod.make_camera((WIDTH, HEIGHT), 20.0)
    b.camera = cam_mod.looking_at(cam, (13, 2, -3), (0, 0, 0), (0, 1, 0))
    return b.build()


def mixed_spheres(seed: int = 42) -> Scene:
    """RTweekend 100+ sphere field."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    g = b.geometry

    g.add_sphere((0, -1000, 1), 1000.0, b.materials.add_lambertian((0.5, 0.5, 0.5)))
    g.add_sphere((0, 1, 0), 1.0, b.materials.add_dielectric(1.5))
    g.add_sphere((-4, 1, 0), 1.0, b.materials.add_lambertian((0.4, 0.2, 0.1)))
    gold_m = b.materials.add_metal(GOLD[0], GOLD[1], 0.0)
    g.add_sphere((4, 1, 0), 1.0, gold_m)

    metals = [GOLD, SILVER, COPPER, ALUMINIUM]
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(),
                 0.2 + rng.random() ** 3 * 0.1,
                 bb + 0.9 * rng.random()]
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                m = b.materials.add_lambertian(tuple(rng.random(3)))
            elif choose < 0.95:
                eta, k = metals[rng.integers(0, 4)]
                m = b.materials.add_metal(eta, k, rng.random() * 0.5)
            else:
                m = b.materials.add_dielectric(1.4)
            g.add_sphere(center, 0.2, m)

    b.lights.env = BLUE_SKY
    cam = cam_mod.make_camera((WIDTH, HEIGHT), 25.0)
    b.camera = cam_mod.looking_at(cam, (13, 2, 3), (0, 0, 0), (0, 1, 0))
    return b.build()


def plates() -> Scene:
    """Four glossy plates under four colored sphere lights."""
    b = SceneBuilder()
    r = 20.0
    matte = b.materials.add_lambertian((0.4, 0.4, 0.4))
    g = b.geometry
    g.add_quad((-r, 0, 0), (2 * r, 0, 0), (0, r, 0), matte)  # wall xy
    g.add_quad((-r, 0, -r), (2 * r, 0, 0), (0, 0, r), matte)  # floor xz

    lights_pos = np.array([0.0, r, -0.4 * r])
    camera_pos = np.array([0.0, 0.4 * r, -2.8 * r])
    left, right = -r * 0.7, r * 0.7
    plates_yz = [(0.6 * r, -0.2 * r), (0.45 * r, -0.3 * r),
                 (0.3 * r, -0.45 * r), (0.2 * r, -0.6 * r)]
    roughs = [8e-5, 3e-4, 8e-4, 3e-3]
    plate_width = 0.16 * r
    for (py, pz), rough in zip(plates_yz, roughs):
        pl = np.array([0.0, lights_pos[1] - py, lights_pos[2] - pz])
        pc = np.array([0.0, camera_pos[1] - py, camera_pos[2] - pz])
        normal = pl / np.linalg.norm(pl) + pc / np.linalg.norm(pc)
        normal /= np.linalg.norm(normal)
        tangent = np.array([0.0, normal[2], -normal[1]])
        tangent = tangent / np.linalg.norm(tangent) * (plate_width * 0.5)
        m = b.materials.add_glossy((0.9, 0.9, 0.9), rough)
        t00 = np.array([left, py, pz]) + tangent
        t10 = np.array([right, py, pz]) + tangent
        # quad spanning the two rails
        g.add_quad(t00, t10 - t00, -2.0 * tangent, m)

    light_x = np.linspace(left * 0.9, right * 0.9, 4)
    sizes = [0.1 * r, 0.06 * r, 0.03 * r, 0.01 * r]
    colors = [(1.0, 0.8, 0.8), (1.0, 1.0, 0.8), (0.8, 1.0, 0.8), (0.8, 0.8, 1.0)]
    for x, s, c in zip(light_x, sizes, colors):
        center = (x, lights_pos[1], lights_pos[2])
        g.add_sphere(center, s, b.materials.add_diffuse_light(c))
        b.lights.add_area_sphere(c, center, s)

    cam = cam_mod.make_camera((1000, 800), np.degrees(np.pi * 0.19))
    b.camera = cam_mod.looking_at(cam, camera_pos, camera_pos + np.array([0, 0, 1]),
                                  (0, 1, 0))
    return b.build()


def everything(seed: int = 7) -> Scene:
    """RTweekend-2 final scene: 400 ground cuboids, a quad light, glass,
    metal and textured spheres and a 1000-ball cluster (the earth texture
    is a checker stand-in)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    g = b.geometry
    ground = b.materials.add_lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0 = -1000.0 + i * 100.0
            z0 = -1000.0 + j * 100.0
            y1 = rng.random() * 100.0 + 1.0
            g.add_cuboid((x0, 0, z0), (x0 + 100, y1, z0 + 100), ground)

    light = b.materials.add_diffuse_light((7.0, 7.0, 7.0))
    g.add_quad((123, 554, 147), (300, 0, 0), (0, 0, 265), light)
    b.lights.add_area_quad((7.0, 7.0, 7.0), (123, 554, 147), (300, 0, 0),
                           (0, 0, 265))

    g.add_sphere((260, 150, 45), 50.0, b.materials.add_dielectric(1.5))
    g.add_sphere((0, 150, 145), 50.0,
                 b.materials.add_metal(SILVER[0], SILVER[1], 1.0))
    g.add_sphere((360, 150, 145), 70.0, b.materials.add_dielectric(1.5))

    checker = b.textures.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    g.add_sphere((400, 200, 400), 100.0, b.materials.add_lambertian(tex_id=checker))
    perlin = b.textures.add_perlin(10.0)
    g.add_sphere((220, 280, 300), 80.0, b.materials.add_lambertian(tex_id=perlin))

    white = b.materials.add_lambertian((0.73, 0.73, 0.73))
    t_pp = tf.compose(tf.translate((-100, 270, 395)), tf.rotate_y(15.0))
    for _ in range(1000):
        c = rng.random(3) * 165.0
        g.add_sphere(c, 10.0, white, transform=t_pp)

    b.lights.env = DARK_ROOM
    cam = cam_mod.make_camera((800, 800), 40.0)
    b.camera = cam_mod.looking_at(cam, (478, 278, -600), (278, 278, 0), (0, 1, 0))
    return b.build()


def env_mapped() -> Scene:
    """Mirror + metal spheres under an environment."""
    b = SceneBuilder()
    g = b.geometry
    g.add_sphere((0, 0, 0), 2.0, b.materials.add_mirror((1, 1, 1)))
    for i, rough in enumerate([0.001, 0.003, 0.01, 0.03]):
        m = b.materials.add_metal(GOLD[0], GOLD[1], rough)
        g.add_sphere((i * 6.0 - 9.0, 6.0, 0.0), 2.0, m)
    b.lights.env = lt.make_env_dusk()
    cam = cam_mod.make_camera((1280, 800), 60.0)
    b.camera = cam_mod.looking_at(cam, (0, 0, -24), (0, 0, 0), (0, 1, 0))
    return b.build()


def _icosphere(levels=3):
    """Procedural test mesh: Loop-subdivided octahedron, projected to the
    unit sphere (mesh asset stand-in; reference PLY assets are absent)."""
    from . import subdivision

    pos = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    idx = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64
    )
    pos, idx = subdivision.loop_subdivide(pos, idx, levels)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    return pos, idx


def mesh_ball(levels: int = 4) -> Scene:
    """Triangle-mesh scene: a smooth-shaded mesh ball (matte) and a glass
    mesh ball, 8 * 4^levels triangles each, over a checkered floor under a
    quad light."""
    from .ply import compute_vertex_normals

    b = SceneBuilder()
    checker = b.textures.add_checker((0.8, 0.8, 0.8), (0.2, 0.25, 0.3))
    floor = b.materials.add_lambertian(tex_id=checker)
    matte = b.materials.add_lambertian((0.7, 0.3, 0.25))
    glass = b.materials.add_dielectric(1.5)
    light_c = (12.0, 12.0, 12.0)
    light = b.materials.add_diffuse_light(light_c)

    g = b.geometry
    g.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), floor)
    pos, idx = _icosphere(levels)
    nrm = compute_vertex_normals(pos, idx)
    t1 = tf.compose(tf.translate((-1.3, 1.0, 0.0)))
    g.add_mesh(pos, idx, matte, normals=nrm, transform=t1)
    t2 = tf.compose(tf.translate((1.3, 1.0, 0.0)))
    g.add_mesh(pos, idx, glass, normals=nrm, transform=t2)
    g.add_quad((-1.5, 6.0, -1.5), (3.0, 0, 0), (0, 0, 3.0), light)
    b.lights.add_area_quad(light_c, (-1.5, 6.0, -1.5), (3.0, 0, 0), (0, 0, 3.0))
    b.lights.env = DARK_ROOM

    cam = cam_mod.make_camera((800, 600), 35.0)
    b.camera = cam_mod.looking_at(cam, (0, 2.2, -7.5), (0, 1.0, 0), (0, 1, 0))
    return b.build()


def fourier_plastic() -> Scene:
    """Measured-BSDF (Fourier) scene: spheres with Fourier tables of
    different albedos next to a microfacet plastic, over a Fourier floor
    under a quad light. The .bsdf assets are absent, so the tables are
    synthetic Lambert expansions (``fourier.make_lambert_table``) that take
    the same path: Catmull-Rom mu interpolation, the cosine series, zenith
    and azimuth CDF inversion."""
    from ..bxdf import fourier as fb

    b = SceneBuilder()
    floor_f = b.materials.add_fourier(fb.make_lambert_table(0.55, n_mu=32))
    m_lo = b.materials.add_fourier(fb.make_lambert_table(0.25, n_mu=32))
    m_hi = b.materials.add_fourier(fb.make_lambert_table(0.8, n_mu=32))
    plastic = b.materials.add_plastic((0.25, 0.3, 0.5), (0.6, 0.6, 0.6),
                                      0.08)
    light_c = (10.0, 10.0, 10.0)
    light = b.materials.add_diffuse_light(light_c)

    g = b.geometry
    g.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), floor_f)
    g.add_sphere((-2.4, 1.0, 0.0), 1.0, m_lo)
    g.add_sphere((0.0, 1.0, 0.0), 1.0, m_hi)
    g.add_sphere((2.4, 1.0, 0.0), 1.0, plastic)
    g.add_quad((-1.5, 6.0, -1.5), (3.0, 0, 0), (0, 0, 3.0), light)
    b.lights.add_area_quad(light_c, (-1.5, 6.0, -1.5), (3.0, 0, 0),
                           (0, 0, 3.0))
    b.lights.env = DARK_ROOM

    cam = cam_mod.make_camera((800, 600), 40.0)
    b.camera = cam_mod.looking_at(cam, (0, 2.4, -8.0), (0, 1.0, 0),
                                  (0, 1, 0))
    return b.build()


PRESETS = {
    "cornell_box": cornell_box,
    "quad": quad,
    "quad_light": quad_light,
    "two_perlin_spheres": two_perlin_spheres,
    "earth": earth,
    "mixed_spheres": mixed_spheres,
    "plates": plates,
    "everything": everything,
    "env_mapped": env_mapped,
    "mesh_ball": mesh_ball,
    "fourier_plastic": fourier_plastic,
}
