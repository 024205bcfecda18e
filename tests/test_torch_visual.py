"""The port's ``test --dump_dir`` output renders through the root
``visual.py`` (PNG and HTML), which imports neither the JAX package nor
the port: ``visual.py`` needs no port of its own."""

import os
import subprocess
import sys

import numpy as np

from pvraft_tpu_torch import test as test_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = """
import runpy, sys
sys.argv = ["visual.py"] + sys.argv[1:]
runpy.run_path("visual.py", run_name="__main__")
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("pvraft_tpu", "pvraft_tpu_torch", "jax")]
assert not loaded, loaded
"""


def test_dump_dir_renders_through_visual(tmp_path, capsys):
    dump = tmp_path / "result"
    test_cli.main(["--dataset", "synthetic", "--device", "cpu",
                   "--max_points", "64", "--synthetic_size", "2",
                   "--num_workers", "0", "--truncate_k", "16",
                   "--corr_knn", "8", "--eval_iters", "2",
                   "--exp_path", str(tmp_path / "exp"),
                   "--dump_dir", str(dump)])
    capsys.readouterr()
    scene = dump / "synthetic" / "1"
    assert np.load(scene / "flow.npy").shape == (64, 3)
    for flags, out in (([], "render.png"), (["--html"], "render.html")):
        done = subprocess.run(
            [sys.executable, "-c", RENDER, "--result_root", str(dump),
             "--dataset", "synthetic", "--index", "1", *flags],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr
        assert done.stdout.strip() == str(scene / out)
        assert (scene / out).stat().st_size > 1000
