"""Seconds the program spent warming up, capturing and instantiating its
CUDA graphs during set-up: the tile program's or the train programs'
own ``stats["capture_s"]``."""


def read(layer):
    return layer.get("capture_s")
