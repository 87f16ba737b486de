"""Device milliseconds of the CSG filter a frame: the kernels launched
inside the program's ``csg_filter`` mark (``core/csg.apply_csg``'s body),
on the shading path and on the shadow path together, in the traced run's
marked ``graphs=False`` frame (``metrics/_marks.py``). The shadow path's
filter runs inside the area-light stage, so this overlaps
``area_ms.frame``: the two are not to be added. Nothing where the
program has no such mark."""

from rtbench.metrics._marks import mark_ms


def read(layer):
    return mark_ms(layer, "csg_filter")
