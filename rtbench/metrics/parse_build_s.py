"""Seconds from the scene's inputs to the program's scene on the card:
the host clock around the configuration's ``port_scene`` (YAML and OBJ
parsing, or the specs, and ``build_scene``)."""


def read(layer):
    return layer.get("parse_build_s")
