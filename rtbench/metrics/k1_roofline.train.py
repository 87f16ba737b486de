"""K1's walk's share of its f32 bound in the profiled steps, in %
(``_spans.k1_roofline``: the gated tests counted on the card)."""

from rtbench.metrics import _spans


def read(layer):
    if layer["kind"] != "train":
        return None
    return _spans.k1_roofline(layer.get("profile"))
