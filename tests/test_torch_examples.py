"""The port's inverse-render example as a real subprocess on the CPU
(the counterpart of tests/test_examples.py:38). The example checks its own
recovery (colour within 0.05, pose error under 0.05, a falling loss) and
exits non-zero when it fails; rc 0 and its OK line are the contract."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("mode,ok", [([], b"OK ("), (["--pose"], b"OK pose")],
                         ids=["colour", "pose"])
def test_inverse_render_recovers(mode, ok):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.examples.inverse_render",
         "--device", "cpu", *mode],
        capture_output=True, timeout=600, env=env, cwd=str(REPO))
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
    assert ok in out.stdout
