"""PBRT AST interpreter -> Scene buffers. A copy of
pbrs_tpu/scene/pbrt/loader.py that builds the port's SceneBuilder; both
image reads (environment map, image textures) go through
``io/image.py:read_png_rgb`` instead of PIL, and Fourier materials with a
table raise NotImplementedError until the Fourier BSDF is ported.

[ref: scene/src/loader.rs:22-855]

State machine: CTM stack, reverse-orientation stack, current material,
current area-light luminance, named textures/materials, object definitions.
Notable parity decisions:
* pbrt-v3 Rotate compatibility: the reference negates the rotation angle to
  replicate pbrt-v3's transposed rotation matrix (loader.rs:786-802) — kept.
* Object instancing implemented for real (reference `unimplemented!`,
  loader.rs:768-782).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ... import radiometry
from ...geometry import camera as cam_mod
from ...geometry import transform as tf
from ...io import image as io_image
from ...lights import lights as lt
from .. import ply as ply_mod
from ..buffers import Scene, SceneBuilder
from . import parser as parser_mod
from . import tokenizer

log = logging.getLogger(__name__)


def _spectrum_to_rgb(loader, stype, value):
    """[ref: scene/src/loader.rs:758-766 + spd file support loader.rs:846-855]"""
    if isinstance(value, str):
        # SPD file path (metal eta/k).
        return _color_from_spd_file(loader.resolve(value))
    nums = [float(v) for v in (value if isinstance(value, list) else [value])]
    if len(nums) == 1:
        return np.array([nums[0]] * 3, np.float32)
    if stype in ("rgb", "color", "float"):
        return np.asarray(nums[:3], np.float32)
    if stype == "xyz":
        return np.maximum(
            radiometry.XYZ_TO_RGB @ np.asarray(nums[:3]), 0.0
        ).astype(np.float32)
    if stype == "blackbody":
        scale = nums[1] if len(nums) > 1 else 1.0
        return radiometry.temperature_to_rgb(nums[0]) * scale
    if stype == "spectrum":
        # inline sampled spectrum: wavelength/value pairs
        lam = nums[0::2]
        val = nums[1::2]
        return radiometry.sampled_spectrum_to_rgb(lam, val)
    raise ValueError(f"unrecognized spectrum type {stype!r}")


def _color_from_spd_file(path):
    """Wavelength/value pairs, one per line. [ref: src/main.rs:399-443 usage]"""
    lam, val = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            lam.append(float(parts[0]))
            val.append(float(parts[1]))
    return radiometry.sampled_spectrum_to_rgb(lam, val)


# Metal defaults: copper. [ref: loader.rs:549-551, preset.rs:488-493]
_COPPER_ETA = (0.195470, 0.925682, 1.102186)
_COPPER_K = (3.910869, 2.451263, 2.142653)


class PbrtLoader:
    def __init__(self, root_dir="."):
        self.root_dir = root_dir
        self.b = SceneBuilder()
        self.ctm = [np.eye(4, dtype=np.float32)]
        self.reverse_orientation = [False]
        self.current_mtl: int | None = None
        self.current_arealight = None  # rgb luminance or None
        self.named_textures: dict[str, int] = {}
        self.named_materials: dict[str, int] = {}
        self.objects: dict[str, tuple] = {}  # name -> (def_ctm, items)
        # name -> [master GeometryBuilder, [4x4 instance transforms]];
        # materialized as trace-time instance groups at end of load.
        self.object_masters: dict[str, list] = {}
        self.default_light_mtls: dict[tuple, int] = {}
        self._mtl_cache: dict = {}
        self.film_res = None
        self.fov = None
        self.camera_pose = None
        self.integrator = None
        self.sampler_spec = None
        self.filter_spec = None
        self.world_transform = np.eye(4, dtype=np.float32)

    # ------------------------------------------------------------------
    def resolve(self, rel):
        return os.path.join(self.root_dir, rel)

    def transform_matrix(self, t):
        """AST transform -> 4x4. pbrt-v3 Rotate bug compatibility: negate
        the angle. [ref: loader.rs:786-802]"""
        tag = t[0]
        if tag == "translate":
            return tf.translate(t[1])
        if tag == "scale":
            return tf.scale(t[1])
        if tag == "rotate":
            return tf.rotate_axis_angle(t[2], -t[1])
        if tag == "identity":
            return np.eye(4, dtype=np.float32)
        if tag == "set_matrix":
            # PBRT matrices are column-major.
            return ("set", np.asarray(t[1], np.float32).reshape(4, 4).T)
        if tag == "concat_matrix":
            return np.asarray(t[1], np.float32).reshape(4, 4).T
        if tag == "lookat":
            return ("lookat", t[1], t[2], t[3])
        if tag == "coordsys":
            log.warning("CoordinateSystem unsupported; ignored")
            return np.eye(4, dtype=np.float32)
        raise ValueError(f"unknown transform {t}")

    def apply_transform(self, t):
        m = self.transform_matrix(t)
        if isinstance(m, tuple):
            if m[0] == "set":
                self.ctm[-1] = m[1]
            else:
                log.error("LookAt inside the world block is unsupported")
            return
        self.ctm[-1] = self.ctm[-1] @ m

    # ------------------------------------------------------------------
    def load(self, path) -> Scene:
        self.root_dir = os.path.dirname(path) or "."
        tokens = tokenizer.tokenize_file(path)
        options, items = parser_mod.parse_tokens(tokens)
        self.consume_options(options)
        for item in items:
            self.world_item(item)
        # Apply scene-wide world transform to every primitive post-hoc by
        # construction: reference applies it to instances (loader.rs:139-162);
        # here non-identity world transforms are folded into the CTM root
        # before traversal, so nothing to do.
        self.finish_camera()
        for master, tfs in self.object_masters.values():
            if tfs:
                self.b.add_instance_group(master, tfs)
        return self.b.build()

    def consume_options(self, options):
        """[ref: loader.rs:91-162]"""
        for opt in options:
            tag = opt[0]
            if tag == "camera":
                _, impl, params = opt
                if impl != "perspective":
                    log.error("non-perspective camera %s unsupported", impl)
                self.fov = params.number("fov", 60.0)
            elif tag == "film":
                _, _impl, params = opt
                w = params.number("xresolution", 640)
                h = params.number("yresolution", 480)
                self.film_res = (int(w), int(h))
            elif tag == "transform":
                t = opt[1]
                if t[0] == "lookat":
                    self.camera_pose = (t[1], t[2], t[3])
                else:
                    m = self.transform_matrix(t)
                    if isinstance(m, tuple):
                        m = m[1]
                    self.world_transform = self.world_transform @ m
            elif tag == "pixelfilter":
                self.filter_spec = (opt[1], opt[2])
            elif tag in ("integrator", "sampler", "accelerator"):
                # Parsed but ignored, like the reference (loader.rs:151).
                setattr(self, tag if tag != "accelerator" else "sampler_spec",
                        (opt[1], opt[2]))
            else:
                log.error("unhandled scene-wide option %r", tag)
        # Seed the root CTM with the world transform.
        self.ctm[0] = self.world_transform.copy()

    def finish_camera(self):
        res = self.film_res or (640, 480)
        cam = cam_mod.make_camera(res, self.fov or 60.0)
        if self.camera_pose:
            eye, target, up = self.camera_pose
            cam = cam_mod.looking_at(cam, eye, target, up)
        self.b.camera = cam

    # ------------------------------------------------------------------
    def world_item(self, item):
        tag = item[0]
        if tag == "transform":
            self.apply_transform(item[1])
        elif tag == "shape":
            self.shape(item[1], item[2])
        elif tag == "material":
            self.current_mtl = self.material(item[1], item[2])
        elif tag == "make_material":
            _, name, params = item
            impl = params.string("type")
            self.named_materials[name] = self.material(impl, params)
        elif tag == "named_material":
            self.current_mtl = self.named_materials.get(item[1])
            if self.current_mtl is None:
                log.error("unknown named material %r", item[1])
        elif tag == "texture":
            _, name, tex_type, impl, params = item
            if tex_type in ("color", "spectrum", "float"):
                self.named_textures[name] = self.texture(impl, params)
            else:
                log.error("texture of type %s unsupported", tex_type)
        elif tag == "attribute":
            # [ref: loader.rs:208-223]
            # PBRT-correct graphics-state save/restore: the current material
            # and area light are INHERITED into the block and restored after.
            # (The reference clears them on entry, loader.rs:214-215, with a
            # TODO admitting the choice is unstudied — see COMPAT.md.)
            self.ctm.append(self.ctm[-1].copy())
            self.reverse_orientation.append(self.reverse_orientation[-1])
            saved_mtl = self.current_mtl
            saved_light = self.current_arealight
            for child in item[1]:
                self.world_item(child)
            self.ctm.pop()
            self.reverse_orientation.pop()
            self.current_mtl = saved_mtl
            self.current_arealight = saved_light
        elif tag == "transform_block":
            self.ctm.append(self.ctm[-1].copy())
            for child in item[1]:
                self.world_item(child)
            self.ctm.pop()
        elif tag == "object":
            _, name, children = item
            self.objects[name] = (self.ctm[-1].copy(), children)
        elif tag == "object_instance":
            self.object_instance(item[1])
        elif tag == "reverse_orientation":
            self.reverse_orientation[-1] = not self.reverse_orientation[-1]
        elif tag == "light":
            self.light(item[1], item[2])
        elif tag == "arealight":
            _, impl, params = item
            if impl == "diffuse":
                spec = params.spectrum("L")
                lum = (
                    _spectrum_to_rgb(self, *spec) if spec
                    else np.ones(3, np.float32)
                )
                scale = params.number("scale", 1.0)
                self.current_arealight = lum * scale
            else:
                log.error("unhandled area light %s", impl)
        else:
            log.error("unhandled world item %r", tag)

    @staticmethod
    def _children_have_arealight(children):
        for item in children:
            tag = item[0]
            if tag == "arealight":
                return True
            if tag in ("attribute_block", "transform_block", "object"):
                kids = item[-1]
                if isinstance(kids, (list, tuple)) and (
                        PbrtLoader._children_have_arealight(kids)):
                    return True
        return False

    def object_instance(self, name):
        """Instance a recorded object as a trace-time instance group:
        the object's geometry is replayed ONCE into an object-space master
        `GeometryBuilder` (stored once on device), and each ObjectInstance
        appends only a 4x4 transform — O(1) geometry per instance, exact
        under any affine, like the reference's transform-at-intersect
        Instance (tlas/src/instance.rs:50-67; the reference's own
        ObjectBlock loader is unimplemented!, loader.rs:768-782).

        Emissive objects (an AreaLightSource inside the block) fall back to
        geometry replay so the light sampling records land in world space.
        """
        if name not in self.objects:
            log.error("unknown object %r", name)
            return
        def_ctm, children = self.objects[name]
        inst_ctm = self.ctm[-1].copy()
        if self._children_have_arealight(children):
            # Replay path: re-root the block's CTM prefix at the instance
            # CTM (duplicates geometry; only used for emissive objects).
            replay = inst_ctm @ np.linalg.inv(
                def_ctm.astype(np.float64)).astype(np.float32)
            self.ctm.append(replay @ def_ctm)
            saved_mtl, saved_light = self.current_mtl, self.current_arealight
            for child in children:
                self.world_item(child)
            self.ctm.pop()
            self.current_mtl, self.current_arealight = saved_mtl, saved_light
            return
        if name not in self.object_masters:
            # Build the object-space master once: replay children with an
            # identity CTM base, redirecting geometry into a fresh builder.
            from ...shapes.tables import GeometryBuilder

            master = GeometryBuilder()
            self.object_masters[name] = [master, []]
            saved_geo = self.b.geometry
            self.b.geometry = master
            self.ctm.append(np.eye(4, dtype=np.float32))
            saved_mtl, saved_light = self.current_mtl, self.current_arealight
            try:
                for child in children:
                    self.world_item(child)
            finally:
                self.ctm.pop()
                self.b.geometry = saved_geo
                self.current_mtl = saved_mtl
                self.current_arealight = saved_light
        self.object_masters[name][1].append(inst_ctm)

    # ------------------------------------------------------------------
    def _light_material(self, lum):
        key = tuple(np.asarray(lum, np.float32).round(6))
        if key not in self.default_light_mtls:
            self.default_light_mtls[key] = self.b.materials.add_diffuse_light(lum)
        return self.default_light_mtls[key]

    def shape(self, impl, params):
        """[ref: loader.rs:172-203 (area-light pairing), 307-389]"""
        ctm = self.ctm[-1]
        if self.current_arealight is not None:
            lum = self.current_arealight
            mat = self._light_material(lum)
            self._emit_shape_with_arealight(impl, params, ctm, mat, lum)
            return
        mat = self.current_mtl
        if mat is None:
            log.error("shape with neither material nor area light; skipped")
            return
        self._emit_shape(impl, params, ctm, mat)

    def _emit_shape(self, impl, params, ctm, mat):
        g = self.b.geometry
        if impl == "sphere":
            radius = params.number("radius", 1.0)
            if self._route_nonuniform(impl, radius, 0.0, ctm, mat):
                return
            g.add_sphere((0, 0, 0), radius, mat, transform=ctm)
        elif impl == "disk":
            radius = params.number("radius", 1.0)
            height = params.number("height", 0.0)
            if self._route_nonuniform(impl, radius, height, ctm, mat):
                return
            g.add_disk((0, 0, height), (0, 0, 1.0), (radius, 0, 0), mat,
                       transform=ctm)
        elif impl in ("trianglemesh", "loopsubdiv", "plymesh"):
            pos, nrm, uv, idx = self._mesh_data(impl, params)
            g.add_mesh(pos, idx, mat, normals=nrm, uvs=uv, transform=ctm)
        else:
            log.error("unsupported shape %s", impl)

    def _route_nonuniform(self, impl, radius, height, ctm, mat) -> bool:
        """Spheres/disks under a non-similarity CTM (shear / non-uniform
        scale) can't live in the baked world-space tables — route them
        through a single-instance trace-time group so the ellipsoid is
        exact (fixes the round-1 cbrt(|det|) approximation, ADVICE #2).
        Skipped while replaying into an object-space master (the OUTER
        instance transform handles world placement there)."""
        from ...shapes.tables import GeometryBuilder, _is_similarity

        if _is_similarity(np.asarray(ctm, np.float64)[:3, :3]):
            return False
        if any(self.b.geometry is m for m, _ in self.object_masters.values()):
            return False  # inside a master replay: keep baked behavior
        master = GeometryBuilder()
        if impl == "sphere":
            master.add_sphere((0, 0, 0), radius, mat)
        else:
            master.add_disk((0, 0, height), (0, 0, 1.0), (radius, 0, 0), mat)
        self.b.add_instance_group(master, [np.asarray(ctm, np.float64)])
        return True

    def _mesh_data(self, impl, params):
        if impl == "plymesh":
            fname = params.string("filename")
            return ply_mod.load_ply(self.resolve(fname))
        pts = np.asarray(params.numbers("P"), np.float32).reshape(-1, 3)
        idx = np.asarray(params.numbers("indices"), np.int64).reshape(-1, 3)
        uv_raw = params.numbers("uv") or params.numbers("st")
        uv = (
            np.asarray(uv_raw, np.float32).reshape(-1, 2)
            if uv_raw else None
        )
        n_raw = params.numbers("N")
        nrm = np.asarray(n_raw, np.float32).reshape(-1, 3) if n_raw else None
        if impl == "loopsubdiv":
            from .. import subdivision

            levels = int(params.number("levels", params.number("nlevels", 1)))
            pts, idx = subdivision.loop_subdivide(pts, idx, levels)
            nrm, uv = None, None
        if nrm is None:
            nrm = ply_mod.compute_vertex_normals(pts, idx)
        return pts, nrm, uv, idx

    def _emit_shape_with_arealight(self, impl, params, ctm, mat, lum):
        """Shapes under an active AreaLightSource become paired emissive
        instances + sampling records. [ref: loader.rs:175-194, 396-434]"""
        lights = self.b.lights
        g = self.b.geometry
        if impl == "sphere":
            radius = params.number("radius", 1.0)
            scale = float(np.cbrt(abs(np.linalg.det(ctm[:3, :3].astype(np.float64)))))
            center = ctm[:3, 3]
            g.add_sphere((0, 0, 0), radius, mat, transform=ctm)
            lights.add_area_sphere(lum, center, radius * scale)
        elif impl in ("trianglemesh", "plymesh", "loopsubdiv"):
            pos, nrm, uv, idx = self._mesh_data(impl, params)
            g.add_mesh(pos, idx, mat, normals=nrm, uvs=uv, transform=ctm)
            world = (pos @ ctm[:3, :3].T) + ctm[:3, 3]
            for (i, j, k) in idx:
                lights.add_area_triangle(lum, world[i], world[j], world[k])
        elif impl == "disk":
            radius = params.number("radius", 1.0)
            height = params.number("height", 0.0)
            g.add_disk((0, 0, height), (0, 0, 1.0), (radius, 0, 0), mat,
                       transform=ctm)
            scale = float(np.cbrt(abs(np.linalg.det(ctm[:3, :3].astype(np.float64)))))
            rot = ctm[:3, :3] / max(scale, 1e-20)
            lights.add_area_disk(
                lum, ctm[:3, :3] @ np.array([0, 0, height], np.float32) + ctm[:3, 3],
                rot @ np.array([0, 0, 1.0], np.float32),
                ctm[:3, :3] @ np.array([radius, 0, 0], np.float32),
            )
        else:
            log.error("unsupported area-light shape %s", impl)

    # ------------------------------------------------------------------
    def light(self, impl, params):
        """[ref: loader.rs:257-281 (infinite), 436-481 (delta)]"""
        if impl == "infinite":
            spec = params.spectrum("L")
            mult = _spectrum_to_rgb(self, *spec) if spec else None
            mapname = params.string("mapname")
            if mapname:
                img = io_image.read_png_rgb(self.resolve(mapname))
                self.b.lights.env = lt.make_env_image(
                    img, mult if mult is not None else (1, 1, 1)
                )
            elif mult is not None:
                self.b.lights.env = lt.make_env_const(mult)
            else:
                self.b.lights.env = lt.make_env_const((1.0, 1.0, 1.0))
        elif impl == "distant":
            frm = np.asarray(params.numbers("from") or [0, 0, 0], np.float32)
            to = np.asarray(params.numbers("to") or [0, 0, 1], np.float32)
            spec = params.spectrum("L")
            col = _spectrum_to_rgb(self, *spec) if spec else np.ones(3, np.float32)
            self.b.lights.add_distant(to - frm, col)
        elif impl == "point":
            frm = np.asarray(params.numbers("from") or [0, 0, 0], np.float32)
            spec = params.spectrum("I") or params.spectrum("L")
            col = _spectrum_to_rgb(self, *spec) if spec else np.ones(3, np.float32)
            # Position through the CTM.
            p = self.ctm[-1][:3, :3] @ frm + self.ctm[-1][:3, 3]
            self.b.lights.add_point(p, col)
        else:
            log.error("unsupported light %s", impl)

    # ------------------------------------------------------------------
    def texture(self, impl, params) -> int:
        """[ref: loader.rs:716-733]"""
        if impl == "imagemap":
            fname = params.string("filename")
            return self.b.textures.add_image_file(self.resolve(fname))
        if impl == "constant":
            spec = params.spectrum("value")
            col = _spectrum_to_rgb(self, *spec) if spec else np.ones(3, np.float32)
            return self.b.textures.add_solid(col)
        if impl == "checkerboard":
            t1 = params.spectrum("tex1")
            t2 = params.spectrum("tex2")
            c1 = _spectrum_to_rgb(self, *t1) if t1 else np.ones(3, np.float32)
            c2 = _spectrum_to_rgb(self, *t2) if t2 else np.zeros(3, np.float32)
            return self.b.textures.add_checker(c1, c2)
        log.error("unsupported texture %s; substituting mid-gray", impl)
        return self.b.textures.add_solid((0.5, 0.5, 0.5))

    def _tex_or_color(self, params, name, default_gray):
        """Returns (color or None, tex_id). [ref: loader.rs:735-756]"""
        hit = params.extract_by_name(name)
        if hit is None:
            return (default_gray,) * 3, -1
        key, value = hit
        stype = key.split()[0] if " " in key else "rgb"
        if isinstance(value, list) and value and isinstance(value[0], str):
            value = value[0]  # bracketed string value: ["texname"]
        if stype == "texture" or (isinstance(value, str)
                                  and value in self.named_textures):
            return (0, 0, 0), self.named_textures.get(value, -1)
        return tuple(_spectrum_to_rgb(self, stype, value)), -1

    def material(self, impl, params) -> int:
        """[ref: loader.rs:483-714]"""
        m = self.b.materials
        if impl == "glass":
            kr_s = params.spectrum("Kr")
            kr = _spectrum_to_rgb(self, *kr_s) if kr_s else np.ones(3, np.float32)
            params.spectrum("Kt")  # transmit tint unused by the lobe model
            eta = params.number("eta", params.number("index", 1.5))
            return m.add_dielectric(eta, reflect=tuple(kr))
        if impl == "mirror":
            kr_s = params.spectrum("Kr")
            kr = (
                _spectrum_to_rgb(self, *kr_s) if kr_s
                else np.full(3, 0.9, np.float32)
            )
            return m.add_mirror(tuple(kr))
        if impl in ("matte", "none", None):
            kd, tex = self._tex_or_color(params, "Kd", 0.5)
            sigma = params.number("sigma", 0.0)
            return m.add_matte(kd, sigma_deg=sigma, tex_id=tex)
        if impl == "metal":
            rough = params.number("roughness", 0.01)
            eta_s = params.spectrum("eta")
            eta = _spectrum_to_rgb(self, *eta_s) if eta_s else _COPPER_ETA
            k_s = params.spectrum("k")
            k = _spectrum_to_rgb(self, *k_s) if k_s else _COPPER_K
            return m.add_metal(tuple(eta), tuple(k), rough)
        if impl == "plastic":
            kd, kd_tex = self._tex_or_color(params, "Kd", 0.25)
            ks, ks_tex = self._tex_or_color(params, "Ks", 0.25)
            rough = params.number("roughness", 0.1)
            remap = params.boolean("remaproughness", True)
            return m.add_plastic(kd, ks, rough, remap_roughness=remap,
                                 kd_tex=kd_tex, ks_tex=ks_tex)
        if impl == "uber":
            kd, kd_tex = self._tex_or_color(params, "Kd", 0.25)
            ks, ks_tex = self._tex_or_color(params, "Ks", 0.25)
            kr_s = params.spectrum("Kr")
            kr = tuple(_spectrum_to_rgb(self, *kr_s)) if kr_s else None
            kt_s = params.spectrum("Kt")
            kt = tuple(_spectrum_to_rgb(self, *kt_s)) if kt_s else None
            rough = params.number("roughness", 0.0)
            eta = params.number("eta", 1.5)
            opacity = params.number("opacity", 1.0)
            remap = params.boolean("remaproughness", True)
            return m.add_uber(kd, ks, kr=kr, kt=kt, roughness=rough, eta=eta,
                              opacity=opacity, remap_roughness=remap,
                              kd_tex=kd_tex, ks_tex=ks_tex)
        if impl == "substrate":
            kd, kd_tex = self._tex_or_color(params, "Kd", 0.5)
            ks, _ks_tex = self._tex_or_color(params, "Ks", 0.5)
            rough = params.number("uroughness", params.number("roughness", 0.1))
            remap = params.boolean("remaproughness", True)
            return m.add_substrate(kd, ks, rough, remap_roughness=remap,
                                   kd_tex=kd_tex)
        if impl == "fourier":
            bsdffile = params.string("bsdffile")
            if bsdffile:
                raise NotImplementedError(
                    "pbrs_tpu.bxdf.fourier (the fourier material's table) is "
                    "not ported to pbrs_tpu_torch yet")
            log.error("fourier material without bsdffile; substituting matte")
            return m.add_matte((0.5, 0.5, 0.5))
        log.error("unrecognized material %r; substituting matte", impl)
        return m.add_matte((0.5, 0.5, 0.5))


def build_scene(path: str) -> Scene:
    """[ref: scene/src/loader.rs:41-58]"""
    return PbrtLoader().load(path)
