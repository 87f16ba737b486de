"""The share of the window's frames (%) whose latency is more than a tenth
above the window's fastest frame: the frames that the card ran in its
slow state (about 17% more device time a frame, the same kernels) or that
the host held back."""


def read(layer):
    lat = layer.get("unit_lats")
    if layer["kind"] != "frame" or not lat:
        return None
    fastest = min(lat)
    return 100.0 * sum(x > 1.1 * fastest for x in lat) / len(lat)
