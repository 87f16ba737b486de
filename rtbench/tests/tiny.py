"""A copy of the benchmark cut to sizes that the CPU runs in seconds, for
the tests: every cell of BENCHMARK.json, each at a tiny frame or batch."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

FRAME = {"dragons": (48, 20), "flagship": (48, 27)}
RAYS = [32, 16]
MESH = (15, 24)    # the dragon's rings and segments: 768 triangles


def cut_mesh(cfg, mesh=MESH):
    """Cuts the dragon's mesh of ``cfg`` (a configuration's JSON), if it
    has one, to ``mesh`` rings and segments."""
    if "mesh" in cfg:
        cfg["mesh"]["rings"], cfg["mesh"]["segments"] = mesh


def edit_json(path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def tiny_tree(tmp):
    """``tmp`` holds BENCHMARK.json and rtbench/ with the configurations'
    frames, the dragon's mesh and the batches cut down. Returns its
    root."""
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, (h, v) in FRAME.items():
        def cut(cfg, h=h, v=v):
            cfg["camera"]["hsize"], cfg["camera"]["vsize"] = h, v
            cut_mesh(cfg)
        edit_json(root / "rtbench" / "configs" / f"{name}.json", cut)
    for name in ("train", "pose"):
        def cut(tr):
            tr["rays"] = RAYS
            tr["profile_units"] = 1
        edit_json(root / "rtbench" / "traffic" / f"{name}.json", cut)

    def frames(tr):
        tr["warmup"] = 1
        tr["profile_units"] = 1
    edit_json(root / "rtbench" / "traffic" / "frame.json", frames)
    return root
