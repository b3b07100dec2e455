"""The program's scene for a configuration, built through pbrs_tpu_torch's
own presets and PBRT loader from the same description the reference
reads (``reference/render.py:build_scene``)."""

from __future__ import annotations

from pathlib import Path


def build(config: dict, root: Path):
    from pbrs_tpu_torch.geometry import camera as cam_mod
    from pbrs_tpu_torch.scene import presets
    from pbrs_tpu_torch.scene.pbrt import loader

    desc = config["scene"]
    width, height = config["width"], config["height"]
    if "preset" in desc:
        c = desc["camera"]
        cam = cam_mod.looking_at(cam_mod.make_camera((width, height),
                                                     float(c["fov"])),
                                 c["eye"], c["target"], c["up"])
        return presets.PRESETS[desc["preset"]]().replace(camera=cam)
    scene = loader.build_scene(str(Path(root) / desc["pbrt"]))
    got = (scene.camera.width, scene.camera.height)
    if got != (width, height):
        raise ValueError(f"{desc['pbrt']} renders {got}, the configuration "
                         f"says {(width, height)}")
    return scene


def reference_scene(config: dict, root: Path):
    from portbench.reference import render as ref

    return ref.build_scene(config["scene"], root, config["width"],
                           config["height"])
