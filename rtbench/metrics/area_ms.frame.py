"""Device milliseconds of the area-light stage a frame: the kernels
launched inside the program's ``area_light`` mark (around
``core/render._area_light_contrib``: the R x S shadow query, the CSG
filter on it, and the sampled Phong) in the traced run's marked
``graphs=False`` frame (``metrics/_marks.py``). Nothing where the program
has no such mark."""

from rtbench.metrics._marks import mark_ms


def read(layer):
    return mark_ms(layer, "area_light")
