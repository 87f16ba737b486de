"""K1's behind mode's share of K1's gated tests in the profiled frames, in
% (the nearest-behind query of transparent meshes, counted on the card by
mode: ``k1_tests_behind`` over ``k1_tests``). Nothing where the program
counts no tests by mode, or no test at all."""


def read(layer):
    if layer["kind"] != "frame" or not layer.get("profile"):
        return None
    counters = layer["profile"]["counters"]
    behind, tests = counters.get("k1_tests_behind"), counters.get("k1_tests")
    if behind is None or not tests:
        return None
    return 100.0 * behind / tests
