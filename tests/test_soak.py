"""The soak harness's full operational cycle, in CI.

benchmarks/soak.py is the month-long-training story (growth + tiered
demotion + timed incremental/full saves + mid-run failover + health
watchdog, all live at once — the reference's incremental-checkpoint +
AdagradDecay deployment pattern, docs/Incremental-Checkpoint.md). The
long run happens on the chip; this smoke asserts the HARNESS itself
keeps working: every subsystem fires and the run survives its own
failover. A regression in any one subsystem (growth, demote, saver
timers, restore, watchdog) breaks this test before it breaks a 45-min
chip run.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_soak_smoke(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = tmp_path / "traj.json"
    proc = subprocess.run(
        [sys.executable, "benchmarks/soak.py", "--smoke",
         "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])

    # every operational subsystem fired
    assert summary["steps"] > 10
    # at least one TIMED save fired (the forced pre-failover incremental
    # and the final full save are unconditional and not counted here)
    assert summary["saves"]["full"] + summary["saves"]["incr"] >= 1
    assert summary["growth_events"] >= 1, "capacity growth never fired"
    assert summary["tier_rows_final"] > 0, "demotion never populated the tier"
    # failover happened and the restore lost nothing relative to the
    # pre-kill save (maybe_save runs right before the simulated failure)
    assert summary["failover_steps_lost"] is not None
    assert summary["failover_steps_lost"] == 0
    # the trajectory file records the failover event
    traj = json.loads(out.read_text())["trajectory"]
    assert any(r.get("event") == "failover_restore" for r in traj)
    # losses stayed finite through the whole run
    assert all(r["loss"] == r["loss"] for r in traj if "loss" in r)


def test_soak_smoke_host_index(tmp_path):
    """The same operational cycle on the host-index fast path (growth,
    filter/evict, timed saves, failover restore — no host tier)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = tmp_path / "traj.json"
    proc = subprocess.run(
        [sys.executable, "benchmarks/soak.py", "--smoke", "--host_index",
         "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["steps"] > 10
    assert summary["growth_events"] >= 1, "capacity growth never fired"
    assert summary["saves"]["full"] + summary["saves"]["incr"] >= 1
    assert summary["failover_steps_lost"] == 0
    traj = json.loads(out.read_text())["trajectory"]
    assert any(r.get("event") == "failover_restore" for r in traj)
