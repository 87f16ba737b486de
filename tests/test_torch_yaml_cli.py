"""The CLI path of raytracer_tpu_torch against the JAX package and PyYAML.

* ``scene.yaml_lite`` reads every scene text in the repo (and generated
  documents of its subset) exactly as ``yaml.safe_load`` does, and raises
  ValueError on each construct outside the subset;
* the OBJ readers (native and pure-Python) give the JAX parser's arrays,
  and ``scenes.write_obj`` round-trips the generated mesh exactly;
* ``parse_scene`` gives the JAX package's scene tables exactly;
* ``python -m raytracer_tpu_torch --device cpu`` gives the JAX CLI's
  frame: at most 0.5% of pixels more than one u8 step apart (the
  CPU<->TPU fuzz budget of the JAX package).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from raytracer_tpu.__main__ import main as jax_main
from raytracer_tpu.obj import parse_obj as jax_parse_obj
from raytracer_tpu.scene.yaml_scene import parse_scene as jax_parse_scene
from raytracer_tpu_torch import native, scenes
from raytracer_tpu_torch.__main__ import main as port_main
from raytracer_tpu_torch.canvas import from_ppm_bytes
from raytracer_tpu_torch.obj import _parse_obj_python, parse_obj
from raytracer_tpu_torch.scene import yaml_lite
from raytracer_tpu_torch.scene.yaml_scene import parse_scene
from torch_port_helpers import assert_same_tables

TESTS = Path(__file__).resolve().parent
DRAGONS_YAML = TESTS.parent / "benchmarks" / "dragons_equiv.yaml"


def _inline_scenes():
    """The YAML scenes written inline in the JAX package's CLI tests
    (test_obj_yaml's f-string takes s = 0.01)."""
    out = {}
    for name in ("test_cli.py", "test_obj_yaml.py", "test_texture_scenes.py"):
        src = (TESTS / name).read_text()
        for i, m in enumerate(re.finditer(r'"""\n(- add:.*?)"""', src, re.S)):
            out[f"{name}:{i}"] = m.group(1).replace("{s}", "0.01")
    return out


INLINE = _inline_scenes()
DRAGONS_48x20 = (DRAGONS_YAML.read_text().replace("width: 1200", "width: 48")
                 .replace("height: 480", "height: 20"))
TEXTS = dict(INLINE, dragons_equiv=DRAGONS_YAML.read_text(),
             csg_area=scenes.CSG_AREA_YAML, soft_glass=scenes.SOFT_GLASS_YAML)


def test_inline_scenes_found():
    assert len(INLINE) == 5


# --------------------------------------------------------------- yaml_lite

@pytest.mark.parametrize("name", sorted(TEXTS))
def test_yaml_lite_reads_scene_files_as_pyyaml(name):
    assert yaml_lite.load(TEXTS[name]) == yaml.safe_load(TEXTS[name])


SCALARS = ["true", "False", "YES", "no", "On", "off", "~", "null", "NULL",
           "0", "-3", "+7", "1.5", "01.5", "-0.25", "3.", "1.0e+5", "1e3",
           "1.5e3", ".5", "-.5", ".inf", "-.Inf", "PI/3", "-PI/2", "foo",
           "field-of-view", "teapot.obj", "a#b", "it's", "y", "n", "-0"]
# forms PyYAML reads as numbers or timestamps that yaml_lite refuses
OTHER_FORMS = ["012", "0x1F", "0b101", "1_000", "1:20", "1:20.5",
               "2001-12-14", "1_0.5"]


@pytest.mark.parametrize("token", SCALARS)
def test_yaml_lite_scalars_resolve_as_pyyaml(token):
    doc = f"a: {token}\nb: [{token}, x]\nc: {{k: {token}}}\n"
    assert yaml_lite.load(doc) == yaml.safe_load(doc)
    assert yaml_lite.load(f"- {token}\n") == yaml.safe_load(f"- {token}\n")


@pytest.mark.parametrize("token", OTHER_FORMS)
def test_yaml_lite_refuses_other_number_forms(token):
    assert not isinstance(yaml.safe_load(f"a: {token}\n")["a"], str)
    for doc in (f"a: {token}\n", f"- [{token}]\n", f"{token}: 1\n"):
        with pytest.raises(ValueError, match=r"yaml_lite: line 1: unsupported"):
            yaml_lite.load(doc)


_plain = st.one_of(
    st.sampled_from(SCALARS),
    st.integers(-10**6, 10**6).map(str),
    st.floats(-1e6, 1e6, allow_nan=False, width=32).map(repr),
    st.from_regex(r"[a-z][a-z0-9_./-]{0,8}", fullmatch=True),
)
_quoted = st.one_of(
    st.from_regex(r"[a-z #:,\[\]{}']{0,8}", fullmatch=True).map(
        lambda s: "'" + s.replace("'", "''") + "'"),
    st.from_regex(r'[a-z #:,\[\]{}]{0,8}', fullmatch=True).map(
        lambda s: '"' + s + '\\t"'),
)
_scalar = st.one_of(_plain, _quoted).map(lambda s: ("s", s))
_flow = st.recursive(
    st.one_of(_plain, _quoted),
    lambda inner: st.one_of(
        st.lists(inner, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]"),
        st.lists(st.tuples(st.from_regex(r"[a-z][a-z-]{0,6}", fullmatch=True),
                           inner), max_size=3).map(
            lambda kv: "{" + ", ".join(f"{k}: {v}" for k, v in kv) + "}")),
    max_leaves=8,
).filter(lambda s: s[0] in "[{").map(lambda s: ("s", s))
_keys = st.from_regex(r"[a-z][a-z0-9-]{0,7}", fullmatch=True)
_node = st.recursive(
    st.one_of(_scalar, _flow),
    lambda inner: st.one_of(
        st.lists(inner, min_size=1, max_size=4).map(lambda xs: ("seq", xs)),
        st.dictionaries(_keys, inner, min_size=1, max_size=4).map(
            lambda d: ("map", list(d.items()))),
    ),
    max_leaves=12,
)


def _emit(node, ind, draw_bool):
    """Block-style YAML lines of a generated node at indentation ``ind``."""
    pad = " " * ind
    lines = []
    if node[0] == "seq":
        for child in node[1]:
            if child[0] == "s":
                lines.append(f"{pad}- {child[1]}")
            elif child[0] == "map":
                sub = _emit(child, ind + 2, draw_bool)
                lines += [f"{pad}- {sub[0][ind + 2:]}"] + sub[1:]
            else:
                lines += [f"{pad}-"] + _emit(child, ind + 2, draw_bool)
    else:
        for key, child in node[1]:
            if child[0] == "s":
                comment = "  # note: x" if draw_bool() else ""
                lines.append(f"{pad}{key}: {child[1]}{comment}")
            else:
                # a sequence may sit at its key's indentation
                same = child[0] == "seq" and draw_bool()
                lines += [f"{pad}{key}:"] + _emit(
                    child, ind if same else ind + 2, draw_bool)
                if draw_bool():
                    lines.append("")
    return lines


@settings(max_examples=200, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(node=_node.filter(lambda n: n[0] != "s"), data=st.data())
def test_yaml_lite_matches_pyyaml_on_generated_documents(node, data):
    text = "\n".join(_emit(node, 0, lambda: data.draw(st.booleans()))) + "\n"
    assert yaml_lite.load(text) == yaml.safe_load(text), text


UNSUPPORTED = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "literal block": "a: |\n  x\n",
    "folded block": "a: >\n  x\n",
    "multi-line flow": "a: [1,\n  2]\n",
    "document marker": "---\na: 1\n",
    "document end": "a: 1\n...\n",
    "directive": "%YAML 1.1\na: 1\n",
    "multi-line quoted": "a: 'x\n  y'\n",
    "multi-line plain": "a: b\n  c\n",
    "complex key": "? a\n: b\n",
    "timestamp": "a: 2001-12-14\n",
    "merge key": "<<: {a: 1}\n",
    "hex escape": 'a: "\\x41"\n',
    "unicode escape": 'a: "\\u00e9"\n',
    "nested mapping on one line": "a: b: c\n",
    "tab indentation": "a:\n\tb: 1\n",
    "flow key": "[a, b]: 1\n",
    "trailing content": "- a\nb: 1\n",
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_yaml_lite_raises_outside_its_subset(name):
    with pytest.raises(ValueError, match=r"yaml_lite: line \d+"):
        yaml_lite.load(UNSUPPORTED[name])


# --------------------------------------------------------------------- OBJ

OBJS = {
    "triangles": "v -1 1 0\nv -1 0 0\nv 1 0 0\nv 1 1 0\n\nf 1 2 3\nf 1 3 4\n",
    "fan": "v -1 1 0\nv -1 0 0\nv 1 0 0\nv 1 1 0\nv 0 2 0\n\nf 1 2 3 4 5\n",
    "groups_normals": ("v 0 1 0\nv -1 0 0\nv 1 0 0\n\nvn -1 0 0\nvn 1 0 0\n"
                       "vn 0 1 0\n\ng FirstGroup\nf 1 2 3\ng SecondGroup\n"
                       "f 1//3 2//1 3//2\n"),
    "mixed_groups": ("v 0 1 0\nv -1 0 0\nv 1 0 0\nv 2 2 0\nvn 0 0 1\ng A\n"
                     "f 1 2 3\nf 1 3 4\ng B\nf 1//1 2//1 3//1\n"),
    # relative normal indices other than -1: the native parser reads
    # "-1" as "no normal" (ROADMAP.md, F6)
    "negative_indices": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvn 0 0 -1\n"
                         "vn 0 1 0\nf -3//-2 -2//-2 -1//-3\nv 1 1 0\n"
                         "f -4/1/-2 -2/1/-3 -1/1/-2\n"),
    "huge_polygon": "\n".join(
        [f"v {math.cos(2 * math.pi * i / 70)} {math.sin(2 * math.pi * i / 70)}"
         " 0" for i in range(70)]
        + ["f " + " ".join(str(i + 1) for i in range(70))]) + "\n",
}


def _meshes(group):
    return [(m.p, m.n, m.smooth) for m in group.children]


@pytest.mark.parametrize("name", sorted(OBJS))
def test_obj_parsers_match_jax(name):
    text = OBJS[name]
    py = _parse_obj_python(text)
    assert native.available()
    for a, b in zip(py, native.parse_obj_arrays(text)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    want, got = _meshes(jax_parse_obj(text)), _meshes(parse_obj(text))
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    if name == "huge_polygon":
        assert py[2].shape == (68, 3)


def test_write_obj_round_trips_the_generated_mesh(tmp_path):
    p, n, smooth = scenes.revolved_mesh()
    path = tmp_path / "teapot.obj"
    scenes.write_obj(path, p, n)
    text = path.read_text()
    for group in (parse_obj(text), jax_parse_obj(text)):
        (gp, gn, gs), = _meshes(group)
        np.testing.assert_array_equal(gp, p)
        np.testing.assert_array_equal(gn, n)
        np.testing.assert_array_equal(gs, smooth)
    verts, norms, *_ = _parse_obj_python(text)
    np.testing.assert_array_equal(verts, p.reshape(-1, 3))
    np.testing.assert_array_equal(norms, n.reshape(-1, 3))


# -------------------------------------------------------------- parse_scene

CAMERA = ("- add: camera\n  width: 24\n  height: 16\n  field-of-view: PI/3\n"
          "  from: [0, 1.5, -5]\n  to: [0, 1, 0]\n  up: [0, 1, 0]\n")
DEFINES = CAMERA + """
- add: point-light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- define: standard-transform
  transform:
    - [translate, 1, -1, 1]
    - [scale, 0.5, 0.5, 0.5]
- define: large-object
  extend: [standard-transform]
  transform:
    - [scale, 3.5, 3.5, 3.5]
- define: white-material
  material: {color: [1, 1, 1], diffuse: 0.7, ambient: 0.1, specular: 0.0, reflective: 0.1}
- define: blue-material
  extend: [white-material]
  material:
    color: [0.537, 0.831, 0.914]
- add: cube
  extend: [large-object, blue-material]
  shadow: false
- add: cone
  min: -1
  max: 0
  closed: yes
  material:
    pattern:
      kind: stripes
      colors: [[1, 0, 0], [0, 0, 1]]
      transform:
        - [rotate-z, PI/2]
- add: plane
  material:
    pattern:
      kind: texture-map
      uv-mapping: planar
      uv-pattern: {kind: checker, width: 2, height: 2, colors: [[0, 0, 0], [1, 1, 1]]}
- add: group
  transform:
    - [shear, 0.1, 0, 0, 0, 0, 0]
  shapes:
    - add: smooth-triangle
      p1: [0, 1, 0]
      p2: [-1, 0, 0]
      p3: [1, 0, 0]
      n1: [0, 1, 0]
      n2: [-1, 0, 0]
      n3: [1, 0, 0]
    - add: group
      shapes:
        - add: triangle
          p1: [0, 2, 0]
          p2: [-1, 1, 0]
          p3: [1, 1, 0]
          material:
            pattern:
              kind: xyz-rgb
"""
AREA = CAMERA + """
- add: area-light
  corner: [-1, 2, -4]
  uvec: [2, 0, 0]
  vvec: [0, 2, 0]
  usteps: 3
  vsteps: 2
  intensity: [1.5, 1.5, 1.5]
- add: plane
- add: sphere
  transform:
    - [translate, 0, 1, 0]
  material:
    reflective: 0.3
"""
GROUP_OBJ = CAMERA + """
- add: point-light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- add: group
  obj: shapes.obj
  transform:
    - [scale, 0.5, 0.5, 0.5]
    - [rotate-y, PI/6]
  material:
    color: [1, 0.5, 0.2]
  shapes:
    - add: sphere
      transform:
        - [translate, 0, 3, 0]
    - add: group
      obj: shapes.obj
      transform:
        - [translate, 2, 0, 0]
"""
PARSE_CASES = {
    "define_extend": (DEFINES, {}),
    "csg": (INLINE["test_obj_yaml.py:0"], {}),
    "area_light": (AREA, {"jitter": (0.3, 0.7)}),
    "earth": (INLINE["test_texture_scenes.py:0"], {}),
    "skybox": (INLINE["test_texture_scenes.py:1"], {}),
    "group_obj": (GROUP_OBJ, {}),
    "dragons_equiv_48x20": (DRAGONS_48x20, {}),
}
SKY = ("posx", "negx", "posy", "negy", "posz", "negz")


def write_ppm(path, rgb_u8):
    h, w, _ = rgb_u8.shape
    body = " ".join(str(int(v)) for v in rgb_u8.reshape(-1))
    path.write_text(f"P3\n{w} {h}\n255\n{body}\n")


def _assets(tmp_path):
    """The files the scenes name: textures, a small OBJ and an 8-triangle
    teapot.obj (the first triangles of the generated mesh)."""
    rng = np.random.default_rng(0)
    ppms = []
    for name, (h, w) in [("earthmap", (16, 32))] + [(s, (8, 8)) for s in SKY]:
        ppms.append(tmp_path / f"{name}.ppm")
        write_ppm(ppms[-1], rng.integers(0, 256, (h, w, 3)))
    (tmp_path / "shapes.obj").write_text(OBJS["mixed_groups"])
    p, n, _ = scenes.revolved_mesh()
    scenes.write_obj(tmp_path / "teapot.obj", p[:8], n[:8])
    objs = [tmp_path / "shapes.obj", tmp_path / "teapot.obj"]
    return [str(o) for o in objs], [str(p) for p in ppms]


@pytest.mark.parametrize("name", sorted(PARSE_CASES))
def test_parse_scene_tables_match_jax(name, tmp_path):
    text, kw = PARSE_CASES[name]
    objs, ppms = _assets(tmp_path)
    jcam, js = jax_parse_scene(text, obj_files=objs, ppm_files=ppms, **kw)
    cam, ps = parse_scene(text, obj_files=objs, ppm_files=ppms,
                          device="cpu", **kw)
    assert (cam.hsize, cam.vsize, cam.field_of_view) == (
        jcam.hsize, jcam.vsize, jcam.field_of_view)
    np.testing.assert_array_equal(cam.transform, jcam.transform)
    assert_same_tables(js, ps)


# --------------------------------------------------------------------- CLI

CLI_CASES = {
    "point_light": ("test_cli.py:0", []),
    "point_light_bayer2": ("test_cli.py:0", ["--dithering", "bayer2"]),
    "point_light_bayer_color": ("test_cli.py:0",
                                ["--dithering", "bayer-color"]),
    "earth": ("test_texture_scenes.py:0", []),
    "skybox": ("test_texture_scenes.py:1", []),
    "dragons_equiv_48x20": ("dragons", []),
}


def _u8(path):
    return np.floor(from_ppm_bytes(path.read_bytes()) * 255.0
                    + 0.5).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_matches_jax_cli(name, tmp_path):
    key, extra = CLI_CASES[name]
    objs, ppms = _assets(tmp_path)
    scene = tmp_path / "scene.yaml"
    scene.write_text(DRAGONS_48x20 if key == "dragons" else INLINE[key])
    args = ["--scene", str(scene)] + extra
    for o in objs:
        args += ["--obj", o]
    for p in ppms:
        args += ["--ppm", p]
    assert jax_main(args + ["--out", str(tmp_path / "jax.ppm")]) == 0
    assert port_main(args + ["--out", str(tmp_path / "port.ppm"),
                             "--device", "cpu"]) == 0
    want, got = _u8(tmp_path / "jax.ppm"), _u8(tmp_path / "port.ppm")
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    print(f"{name}: {int((diff > 0).sum())} of {diff.size} pixels differ, "
          f"{int((diff > 1).sum())} by more than 1 step")
    assert (diff > 1).mean() <= 0.005
    assert got.max() > 0


def test_cli_defaults_to_cuda(tmp_path):
    """No --device means the card; without one the CLI fails rather than
    rendering on the CPU."""
    import torch

    scene = tmp_path / "scene.yaml"
    scene.write_text(INLINE["test_cli.py:0"])
    args = ["--scene", str(scene), "--out", str(tmp_path / "o.ppm")]
    if torch.cuda.is_available():
        assert port_main(args) == 0
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port_main(args)
