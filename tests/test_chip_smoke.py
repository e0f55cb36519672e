"""chip_smoke.py refuses to run without a GPU and without the repo."""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_on_cpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    if where == "repo":
        assert "needs an NVIDIA GPU" in r.stderr
    # no result line
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
