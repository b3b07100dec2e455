"""scene_load_s: harness clock from the start of the scene build (preset
or PBRT parse, meshes, textures, tables) to the scene on the card."""


def read(rec, cell):
    return rec.scene_load_s
