"""Criteo input-pipeline throughput: native C parser vs python reader.

The reference's published CPU numbers are input-bound (tf.data CSV at
31-120 steps/s on 8-32 vCPUs, modelzoo READMEs); this pins what OUR
input path sustains per host core, the denominator of any
datagen-bound training number. Both readers produce IDENTICAL batches
(shared FNV token hash, fuzzed in tests/test_criteo_fidelity.py) — this
measures speed only.

Writes a synthetic Criteo-format TSV (reproducible), then times:
  * read_criteo_native — mmap-friendly chunked C parser
    (native/deeprec_native.cc criteo_parse)
  * read_criteo        — pure-python line reader

Run: python benchmarks/io_bench.py [--rows N] [--batch B]
Prints one JSON line per reader.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


def write_file(path: str, rows: int, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            label = int(rng.random() < 0.25)
            dense = [str(int(x)) if x >= 0 else ""
                     for x in rng.integers(-1, 1000, 13)]
            cats = [format(int(x), "08x") if x >= 0 else ""
                    for x in rng.integers(-1, 1 << 31, 26)]
            f.write("\t".join([str(label)] + dense + cats) + "\n")


def time_reader(fn, path: str, batch: int) -> dict:
    t0 = time.perf_counter()
    n = 0
    for b in fn(path, batch):
        n += b["label"].shape[0]
    dt = time.perf_counter() - t0
    return {"examples": n, "seconds": round(dt, 3),
            "examples_per_sec": round(n / dt, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()

    from deeprec_tpu.data.criteo import read_criteo, read_criteo_native

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "criteo.tsv")
        write_file(path, args.rows)
        size_mb = os.path.getsize(path) / 1e6
        for name, fn in (("native", read_criteo_native),
                         ("python", read_criteo)):
            r = time_reader(fn, path, args.batch)
            r.update(reader=name, file_mb=round(size_mb, 1),
                     mb_per_sec=round(size_mb / r["seconds"], 1))
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
