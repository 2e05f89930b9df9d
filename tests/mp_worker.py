"""Multi-process worker for the distributed-runtime tests (the analog of
the reference's grpc_testlib_server, core/distributed_runtime/rpc/
grpc_testlib.h:43: a subprocess cluster member driven by the test).

Invoked as:
    python mp_worker.py <process_id> <num_processes> <port> <devices_per_proc>
                        <ckpt_dir> <out_json> [--tiered]

Each process owns <devices_per_proc> virtual CPU devices, joins the
jax.distributed cluster, trains a ShardedTrainer over the GLOBAL mesh on
per-process batch shards (multihost.globalize), saves a multi-part
checkpoint, and dumps its view of the run to <out_json>.
"""
import json
import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    dev_per = int(sys.argv[4])
    ckpt_dir = sys.argv[5]
    out_json = sys.argv[6]
    tiered = "--tiered" in sys.argv
    host_index = "--host_index" in sys.argv

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per}")
    os.environ["COORDINATOR_ADDRESS"] = f"localhost:{port}"
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)

    import jax
    from deeprec_tpu.utils import compile_cache
    compile_cache.enable()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

    from deeprec_tpu.parallel import multihost
    multihost.initialize()  # env-var driven (the TF_CONFIG analog)
    assert jax.process_count() == nproc

    import numpy as np
    import optax

    from deeprec_tpu.checkpoint import CheckpointManager
    from deeprec_tpu.parallel.trainer import ShardedTrainer, make_mesh
    from deeprec_tpu.train import metrics as M
    from mp_model import GLOBAL_BATCH, STEPS, global_batch, make_common

    if tiered:
        from deeprec_tpu.parallel.tiered import TieredShardedTrainer as TC
    else:
        TC = ShardedTrainer
    tr = TC(mesh=make_mesh(), **make_common(tiered=tiered,
                                            host_index=host_index))

    # every process slices ITS rows of the deterministic global stream —
    # the per-worker input pipeline of the reference
    lo = pid * (GLOBAL_BATCH // nproc)
    hi = lo + GLOBAL_BATCH // nproc

    def local(b):
        return {k: v[lo:hi] for k, v in b.items()}

    state = tr.init(jax.random.key(0), local(global_batch(0)))
    for i in range(STEPS):
        state = tr.train_step(state, local(global_batch(i)))
        if tiered and i == STEPS - 2:
            state = tr.maybe_demote(state)

    m = M.summarize(state.metrics)
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(tr, state, evict=False)
    multihost.barrier("saved")

    out = {"pid": pid, "step": int(state.step), "loss": float(m["loss"]),
           "auc": float(m["auc"]), "count": int(m["examples"]),
           "health": tr.table_health(state)["emb"]}
    with open(out_json, "w") as f:
        json.dump(out, f)
    print(f"worker {pid}: OK {out}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
