"""The port's CLI on a mesh: ``--dp 2`` under torchrun (two gloo ranks on
the CPU) for one epoch of LightGCN on ``--dataset synthetic`` against the
same run in one process, within JAX's tolerances for its own mesh run
(tests/test_cli_mesh.py): the metrics rtol 2e-3 and atol 1e-5, AUC rtol
5e-3, the same best epoch.  torchrun runs in its own process group, killed
whole past its deadline."""

import glob
import json
import os
import signal
import subprocess
import sys

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401

from tagrec_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
        "--test_interval", "1", "--train_batch", "128", "--group_k", "2"]
DEADLINE_S = 150


def _results(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, "**", "results.json"),
                        recursive=True)
    with open(path) as f:
        return json.load(f)


def test_dp2_under_torchrun_matches_one_process(tmp_path):
    single = tmp_path / "single"
    cli.main(ARGS + ["--out_dir", str(single)])
    meshed = tmp_path / "mesh"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "tagrec_tpu_torch.cli", "--dp", "2",
           *ARGS, "--out_dir", str(meshed)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun passed {DEADLINE_S} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    assert out.count("mesh: data=2 model=1 on cpu") == 1, out[-2000:]
    assert out.count("test result:") == 1  # rank 0 prints, rank 1 does not
    want, got = _results(str(single)), _results(str(meshed))
    for metric in ("recall", "precision", "hr", "ndcg"):
        np.testing.assert_allclose(got["test"][metric], want["test"][metric],
                                   rtol=2e-3, atol=1e-5, err_msg=metric)
    np.testing.assert_allclose(got["test"]["auc"], want["test"]["auc"],
                               rtol=5e-3)
    assert got["best_epoch"] == want["best_epoch"]
    assert got["group"].keys() == want["group"].keys()
