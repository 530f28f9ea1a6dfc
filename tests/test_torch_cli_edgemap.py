"""The training CLI on the EdgeMap tier: ``--model dgcf --adj_mode ell
--device cpu`` on ``--dataset synthetic`` for one epoch trains, evaluates,
runs the final test and group pass and exports, on the EdgeMap tier.
"""

import contextlib
import glob
import io
import json
import math
import os

import numpy as np
from torch_threads import one_torch_thread  # noqa: F401

from tagrec_tpu_torch import cli, serving

METRICS = ("recall", "precision", "hr", "ndcg", "auc")


def test_dgcf_adj_mode_ell(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", "--model", "dgcf", "--adj_mode", "ell",
                  "--dataset", "synthetic", "--epochs", "1", "--group_k",
                  "2", "--train_batch", "1024", "--out_dir",
                  str(tmp_path / "run"), "--export", str(tmp_path / "art")])
    (path,) = glob.glob(os.path.join(tmp_path / "run", "**", "results.json"),
                        recursive=True)
    with open(path) as f:
        res = json.load(f)
    for block in [res["test"], *res["group"].values()]:
        assert all(math.isfinite(v) for m in METRICS for v in block[m])
    assert 0.0 < res["test"]["auc"][0] < 1.0
    text = out.getvalue()
    assert "best result" in text and "serving artifact:" in text
    data, meta = serving.load_export(str(tmp_path / "art"))
    assert meta["model"] == "dgcf" and np.isfinite(data["user_table"]).all()
