"""On the card: one short run of a cell through the command the driver
runs, in a process of its own, gives a result line that meets the
contract's keys. Skips itself without a card (decided in the test)."""

import json
import subprocess
import sys

import pytest

from rtbench.harness import common


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA GPU: the benchmark runs only on the card")
    res = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "flagship.frame",
         "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", str(trace)],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    want = {"frame_s", "peak_mem_GiB", "setup_s"} if not trace \
        else {"parse_build_s", "capture_s", "idle_share.frame",
              "slow_frames.frame", "device_ops.frame", "torch_ops_ms.frame",
              "gather_ms.frame"}
    assert set(line["metrics"]) == want
    assert res.stderr.strip().splitlines()[-1].startswith("check px_off")
