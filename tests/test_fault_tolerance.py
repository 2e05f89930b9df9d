"""Fault injection: a worker process is SIGKILLed mid-training and a
replacement resumes from the latest checkpoint and the surviving
WorkQueue claim state (the reference's fault story: PS/worker recovery =
full ckpt + incremental replay + WorkQueue reassignment, SURVEY.md §5;
it ships no kill-harness — this goes one further)."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, {repo!r})
from deeprec_tpu.data.criteo import CAT_NAMES

# Criteo-format training files (written once by the test)
from modelzoo.DCN.train import build
from deeprec_tpu.train import cli

args = cli.base_parser("t").parse_args([
    "--steps", "100000",  # run "forever": the queue draining ends the run
    "--batch_size", "32", "--eval_steps", "1", "--capacity", "1024",
    "--emb_dim", "4", "--log_steps", "5",
    "--data_location", {files!r},
    "--workqueue", {wq!r},
    "--checkpoint", {ckpt!r}, "--save_secs", "2",
    "--prefetch_depth", "1", "--prefetch_workers", "1",
])
out = cli.run(build(args), args)
with open({out!r}, "w") as f:
    json.dump(out, f)
"""


def _write_files(tmp_path, n_files=6, rows_per_file=64):
    rng = np.random.default_rng(0)
    paths = []
    for fi in range(n_files):
        p = tmp_path / f"part-{fi:02d}.tsv"
        with open(p, "w") as f:
            for _ in range(rows_per_file):
                tok = int(rng.integers(0, 50))
                dense = [str(int(rng.integers(0, 100))) for _ in range(13)]
                cats = [f"t{tok:04d}"] + [
                    f"{rng.integers(0, 1 << 16):04x}" for _ in range(25)]
                f.write("\t".join([str(tok % 2)] + dense + cats) + "\n")
        paths.append(str(p))
    return paths


@pytest.mark.slow
def test_worker_killed_mid_training_resumes(tmp_path):
    files = _write_files(tmp_path)
    wq = str(tmp_path / "wq")
    ckpt = str(tmp_path / "ckpt")
    out_json = str(tmp_path / "out.json")
    script = WORKER.format(repo=REPO, files=",".join(files), wq=wq,
                           ckpt=ckpt, out=out_json)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO

    # worker 1: SIGKILL once it has saved at least one checkpoint and
    # claimed some work
    p1 = subprocess.Popen([sys.executable, "-c", script], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, cwd=REPO)
    deadline = time.time() + 300
    killed = False
    while time.time() < deadline:
        claims = (os.listdir(os.path.join(wq, "claims"))
                  if os.path.isdir(os.path.join(wq, "claims")) else [])
        saves = ([d for d in os.listdir(ckpt) if d.startswith("full-")]
                 if os.path.isdir(ckpt) else [])
        if len(claims) >= 2 and saves:
            p1.kill()  # SIGKILL: no cleanup, claims + ckpt survive on disk
            killed = True
            break
        if p1.poll() is not None:
            break
        time.sleep(1.0)
    if not killed:
        out, _ = p1.communicate(timeout=10)
        pytest.fail(f"worker 1 never reached kill point:\n{out[-3000:]}")
    p1.wait()

    claims_before = set(os.listdir(os.path.join(wq, "claims")))
    assert claims_before  # claim state survived the kill

    # worker 2 (the replacement): must restore the checkpoint, take only
    # UNCLAIMED items, and finish the epoch-bounded queue
    p2 = subprocess.Popen([sys.executable, "-c", script], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, cwd=REPO)
    out, _ = p2.communicate(timeout=600)
    assert p2.returncode == 0, out[-3000:]
    res = json.load(open(out_json))
    # it restored (step continued past the kill point, not from zero)
    assert res["steps"] > 0
    assert os.path.isdir(ckpt)
    # the queue progressed beyond worker 1's claims
    claims_after = set(os.listdir(os.path.join(wq, "claims")))
    assert claims_before < claims_after
    assert np.isfinite(res["train_loss"])
