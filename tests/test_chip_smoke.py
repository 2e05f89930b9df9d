"""chip_smoke.py: its phases run here on the CPU at small sizes (the same
code the card runs at full size), and the script refuses to run without a
GPU or outside the repository. The ``gpu`` tests run the phases at full
size and skip without a card."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_train_phase_then_serve_phase(tmp_path):
    ckpt = chip_smoke.phase_train("host", str(tmp_path), steps=4, batch=64,
                                  capacity=1 << 12, timed_steps=2)
    assert os.path.isdir(ckpt)
    chip_smoke.phase_serve(ckpt, n=4)


def test_train_phase_device_engine(tmp_path):
    chip_smoke.phase_train("device", str(tmp_path), steps=4, batch=64,
                           capacity=1 << 12, timed_steps=2)


def test_parity_phase():
    chip_smoke.phase_parity(batch=64, steps=2, capacity=1 << 12)


def test_gather_phase():
    chip_smoke.phase_gather(rows=1 << 10, n=256, n_big=1024, batch=32,
                            width=4, dim_pool=16, iters=3)


def test_four_cards_phase(tmp_path):
    chip_smoke.phase_four_cards(str(tmp_path), batch=64, steps=2,
                                capacity=1 << 12)


def test_parity_check_rejects_a_gap():
    with pytest.raises(AssertionError):
        chip_smoke._check("t", (0.0, chip_smoke.PARAM_ATOL * 2, 0.0))
    chip_smoke._check("t", (chip_smoke.LOSS_RTOL, 0.0, chip_smoke.ROW_ATOL))


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(tmp_path, alone):
    """No accelerator (or no repository beside the script): non-zero exit
    and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_gpu_parity(gpu):
    chip_smoke.phase_parity()


@pytest.mark.gpu
def test_gpu_gather(gpu):
    chip_smoke.phase_gather()
