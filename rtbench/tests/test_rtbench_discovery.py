"""The harness finds a cell's files by the names in BENCHMARK.json: in a
copy of the benchmark, a new configuration, a new traffic mix, a new
per-layer metric and the new cell's limits, each a file of its own with
its entries, run at a CPU size without an edit to any file that was
there."""

import hashlib
import json
import shutil

import torch

from rtbench.harness import cell
from rtbench.tests.tiny import tiny_tree


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_traffic_and_metric_are_found(tmp_path):
    root = tiny_tree(tmp_path)
    bench_file = root / "BENCHMARK.json"
    before = digests(root / "rtbench")
    b = root / "rtbench"
    for ext in (".json", ".py"):
        shutil.copy(b / "configs" / f"flagship{ext}",
                    b / "configs" / f"spheres{ext}")
    cfg = json.loads((b / "configs" / "spheres.json").read_text())
    cfg["name"] = "spheres"
    cfg["camera"]["hsize"], cfg["camera"]["vsize"] = 40, 20
    (b / "configs" / "spheres.json").write_text(json.dumps(cfg))
    (b / "traffic" / "two_frames.json").write_text(json.dumps(
        {"loop": "frame", "warmup": 1, "profile_units": 2}))
    (b / "metrics" / "frames_traced.py").write_text(
        "def read(layer):\n    return float(layer['profile']['units'])\n")
    (b / "checks" / "spheres.two_frames.json").write_text(
        json.dumps({"px_off": 0.02}))
    bench = json.loads(bench_file.read_text())
    bench["configs"].append(dict(
        name="spheres", source="https://example.org/spheres",
        file="rtbench/configs/spheres.json", reduced=[], why="a test"))
    bench["workloads"].append(dict(
        name="spheres.two_frames", config="spheres", traffic="two_frames",
        chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="frames_traced", unit="frames", better="higher",
        source="program_counter", layer="device", moves="frame_s",
        workloads=["spheres.two_frames"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and "flagship.frame" in m["workloads"]:
            m["workloads"].append("spheres.two_frames")
    bench_file.write_text(json.dumps(bench))

    out = json.loads(cell.execute(
        "spheres.two_frames", 3, 0.2, True, t0=0.0, root=root,
        device=torch.device("cpu")))
    assert out["correct"]
    assert out["metrics"]["frames_traced"] == dict(value=2.0, unit="frames")
    assert out["metrics"]["parse_build_s"]["unit"] == "s"
    out = json.loads(cell.execute(
        "spheres.two_frames", 3, 0.2, False, t0=0.0, root=root,
        device=torch.device("cpu")))
    assert set(out["metrics"]) == {"frame_s", "peak_mem_GiB", "setup_s"}
    after = digests(root / "rtbench")
    assert {k: v for k, v in after.items() if k in before} == before
