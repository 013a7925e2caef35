"""Host seconds of the program's scene load (scene.load_scene through
the geometry disk cache) and bridge.to_torch, in set-up."""


def read(rec):
    return rec.spans.get("scene_load_s")
