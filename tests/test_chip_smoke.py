"""chip_smoke.py refuses to run, and prints no result, without a GPU."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four"]) == 2


def test_chip_smoke_cli_exits_nonzero_without_card(tmp_path):
    """As a process on a CPU backend, both in the checkout and alone in a
    directory without the package: non-zero exit, no JSON result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
