"""HTTP model server over a :class:`Predictor`.

The reference ships serving as a *process*, not just a library: the
Triton backend shim (triton/tensorflow_backend_tf.cc) exposes model
load / run / output extraction as a C API that a serving daemon drives.
This is the analog — a small stdlib HTTP front end over any
of the three predictors (:class:`Predictor`, :class:`ShardedPredictor`,
:class:`TieredPredictor`), with the incremental-refresh loop
(KvResourceIncrImport/IncrRestore serving ops) running live on a timer.

Endpoints (TF-Serving-style JSON):

  POST /v1/predict    {"instances": [{col: value, ...}, ...]}
                      or {"inputs": {col: [values...], ...}}
                      -> {"predictions": [p, ...], "step": N}
  GET  /healthz       -> {"status": "ok", "step": N,
                          "tables": {name: device_rows},
                          "host_tier_rows": {name: rows}}   (tiered only)
  POST /refresh       -> {"changed": bool, "step": N}  (pick up new saves)

Batches are padded to power-of-two buckets before the jitted predict so
a steady request stream compiles O(log max_batch) programs, not one per
distinct request size. One lock serializes predict/refresh — the jitted
call releases the GIL on device, and serving-state swaps (refresh) must
not interleave with a half-prepared batch.

``--dynamic_batch_ms M`` enables Triton-style dynamic batching
(the capability the reference gets from serving through Triton's
dynamic_batching): concurrent requests with the same column signature
are concatenated into one device call (up to --max_batch rows, waiting
at most M ms for co-arrivals), and each caller receives exactly its own
rows. Off by default — lone-request latency pays up to M extra ms.

Run a modelzoo model directly:

  python -m deeprec_tpu.serving.server --model DLRM --ckpt_dir /ckpts \
      --port 8500 --refresh_secs 30 [--mesh 4 | --device_row_budget 1000000] \
      -- --emb_dim 16 --capacity 1048576   # model-spec flags after --
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


def _as_column(name: str, values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype == object:
        raise ValueError(
            f"column {name!r}: ragged values — sequence features must be "
            "fixed-length lists (pad with -1)")
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64)
    if arr.dtype.kind == "f":
        return arr.astype(np.float32)
    raise ValueError(f"column {name!r}: unsupported dtype {arr.dtype}")


def batch_from_json(payload: dict) -> Dict[str, np.ndarray]:
    """Decode a predict request body into a feature batch."""
    if "instances" in payload:
        rows = payload["instances"]
        if not rows:
            raise ValueError("empty instances")
        cols = {}
        for k in rows[0]:
            cols[k] = _as_column(k, [r[k] for r in rows])
        return cols
    if "inputs" in payload:
        cols = {k: _as_column(k, v) for k, v in payload["inputs"].items()}
        if not cols or any(len(v) == 0 for v in cols.values()):
            raise ValueError("empty inputs")
        return cols
    raise ValueError("body must contain 'instances' or 'inputs'")


def pad_pow2(batch: Dict[str, np.ndarray]):
    """Pad every column to the next power-of-two batch size by repeating
    the last row (shape-stable jit programs; padding is sliced off)."""
    n = len(next(iter(batch.values())))
    m = 1 << max(n - 1, 0).bit_length()
    if m == n:
        return batch, n
    pad = m - n
    out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
           for k, v in batch.items()}
    return out, n


class _PendingRequest:
    __slots__ = ("cols", "n", "sig", "event", "out", "err")

    def __init__(self, cols, n, sig):
        self.cols, self.n, self.sig = cols, n, sig
        self.event = threading.Event()
        self.out = None
        self.err = None


def _batch_signature(cols: Dict[str, np.ndarray]):
    """Requests are coalescible iff they share columns, dtypes and
    trailing (per-row) shapes — then axis-0 concatenation is exact."""
    return tuple(sorted((k, v.dtype.str, v.shape[1:])
                        for k, v in cols.items()))


class DynamicBatcher:
    """Triton-style dynamic batching (the reference serves through
    Triton, whose ``dynamic_batching`` coalesces concurrent requests
    into one model execution — model_config dynamic_batching semantics).

    Concurrent predict requests with the same column signature are
    concatenated and run as ONE jitted device call: up to ``max_batch``
    rows, waiting at most ``max_delay_ms`` for co-arrivals. Each caller
    gets exactly its own rows back. Device dispatch has a large constant
    cost relative to marginal per-row cost, so K concurrent small requests approach 1/K of their serial cost.
    Requests issued while a batch is on-device accumulate for the next
    one — the natural two-deep pipeline.
    """

    def __init__(self, run_padded, max_batch: int = 4096,
                 max_delay_ms: float = 2.0):
        self._run = run_padded            # padded batch -> probs
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._cv = threading.Condition()
        self._pending = []
        self._stopped = False
        self.batches = 0                  # device calls issued
        threading.Thread(target=self._loop, daemon=True,
                         name="dynamic-batcher").start()

    def submit(self, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
        req = _PendingRequest(cols, n, _batch_signature(cols))
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            self._pending.append(req)
            self._cv.notify()
        req.event.wait()
        if req.err is not None:
            raise req.err
        return req.out

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def _take_batch(self):
        """Block for the first request, then gather same-signature
        co-arrivals until max_batch rows or the delay window closes."""
        with self._cv:
            while not self._pending and not self._stopped:
                self._cv.wait()
            if self._stopped and not self._pending:
                return None
            sig = self._pending[0].sig
            deadline = time.monotonic() + self.max_delay

            def ready():
                return sum(r.n for r in self._pending
                           if r.sig == sig) >= self.max_batch
            while not ready():
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    break
                self._cv.wait(timeout=left)
            taken, rest, rows = [], [], 0
            for r in self._pending:
                if r.sig == sig and rows < self.max_batch:
                    taken.append(r)
                    rows += r.n
                else:
                    rest.append(r)
            self._pending = rest
            return taken

    def _loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            try:
                cols = {k: np.concatenate([r.cols[k] for r in taken])
                        for k in taken[0].cols}
                padded, n = pad_pow2(cols)
                probs = np.asarray(self._run(padded))[:n]
                self.batches += 1
                off = 0
                for r in taken:
                    r.out = probs[off:off + r.n]
                    off += r.n
            except Exception as e:  # propagate to every caller in the batch
                for r in taken:
                    r.err = e
            finally:
                for r in taken:
                    r.event.set()


class PredictService:
    """Thread-safe predict/refresh/health over one predictor.

    ``dynamic_batch_ms`` > 0 turns on request coalescing (DynamicBatcher):
    concurrent small requests share one device call instead of
    serializing on the predict lock."""

    def __init__(self, predictor, dynamic_batch_ms: float = 0.0,
                 max_batch: int = 4096):
        self.predictor = predictor
        self._lock = threading.Lock()
        self.requests = 0
        self.batcher = None
        if dynamic_batch_ms > 0:
            self.batcher = DynamicBatcher(self._run_locked,
                                          max_batch=max_batch,
                                          max_delay_ms=dynamic_batch_ms)

    def _run_locked(self, padded):
        with self._lock:
            return self.predictor.predict(padded)

    def predict(self, payload: dict):
        batch = batch_from_json(payload)
        sizes = {len(v) for v in batch.values()}
        if len(sizes) != 1:
            raise ValueError(f"column batch sizes differ: {sorted(sizes)}")
        if self.batcher is not None:
            probs = self.batcher.submit(batch, len(next(iter(batch.values()))))
            with self._lock:
                self.requests += 1
                step = self._step()
            return {"predictions": np.asarray(probs).tolist(), "step": step}
        padded, n = pad_pow2(batch)
        with self._lock:
            probs = self.predictor.predict(padded)
            self.requests += 1
            step = self._step()
        return {"predictions": np.asarray(probs)[:n].tolist(), "step": step}

    def refresh(self):
        with self._lock:
            changed = self.predictor.refresh()
            return {"changed": bool(changed), "step": self._step()}

    def health(self):
        with self._lock:
            out = {"status": "ok", "step": self._step(),
                   "requests": self.requests,
                   **({"device_batches": self.batcher.batches}
                      if self.batcher else {}),
                   "tables": {n: int(np.sum(np.asarray(st.index.size)))
                              for n, st in self.predictor.tables.items()}}
            host = getattr(self.predictor, "host_store", None)
            if host:
                out["host_tier_rows"] = {n: len(kv) for n, kv in host.items()}
            return out

    def _step(self) -> Optional[int]:
        s = getattr(self.predictor, "step", None)
        return int(s) if s is not None else None


class _Handler(BaseHTTPRequestHandler):
    service: PredictService = None  # set by make_server

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            self._reply(200, self.service.health())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            if self.path in ("/v1/predict", "/predict"):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, self.service.predict(payload))
            elif self.path == "/refresh":
                self._reply(200, self.service.refresh())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # surface, don't kill the worker thread
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, *a):  # quiet by default
        pass


def make_server(predictor, host: str = "127.0.0.1", port: int = 8500,
                refresh_secs: float = 0.0, dynamic_batch_ms: float = 0.0,
                max_batch: int = 4096):
    """Build a ThreadingHTTPServer (call ``.serve_forever()``); if
    ``refresh_secs`` > 0 a daemon thread applies new checkpoint saves on
    that cadence (the reference's incremental-serving loop);
    ``dynamic_batch_ms`` > 0 coalesces concurrent requests into shared
    device calls (Triton dynamic_batching)."""
    service = PredictService(predictor, dynamic_batch_ms=dynamic_batch_ms,
                             max_batch=max_batch)
    handler = type("Handler", (_Handler,), {"service": service})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.service = service
    if refresh_secs > 0:
        def loop():
            while not getattr(srv, "_BaseServer__shutdown_request", False):
                time.sleep(refresh_secs)
                try:
                    service.refresh()
                except Exception:
                    pass  # transient partial save; retried next tick
        threading.Thread(target=loop, daemon=True).start()
    return srv


def main(argv=None):
    import argparse
    import importlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True,
                    help="modelzoo name (DLRM, WDL, ...) or module path")
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--refresh_secs", type=float, default=0.0)
    ap.add_argument("--dynamic_batch_ms", type=float, default=0.0,
                    help="coalesce concurrent predict requests for up to "
                         "this many ms into one device call (Triton "
                         "dynamic_batching; 0 = off)")
    ap.add_argument("--max_batch", type=int, default=4096,
                    help="row cap per coalesced device call")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve row-sharded over an N-device mesh")
    ap.add_argument("--device_row_budget", type=int, default=0,
                    help="serve with the cold tail in host DRAM")
    args, rest = ap.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]

    from ..train import cli as tcli
    name = args.model if "." in args.model else f"modelzoo.{args.model}.train"
    spec = importlib.import_module(name).build(
        tcli.base_parser("serving").parse_args(rest))

    from . import Predictor, ShardedPredictor, TieredPredictor
    if args.mesh:
        pred = ShardedPredictor(spec.model, spec.numeric_columns,
                                spec.collections, args.ckpt_dir,
                                mesh=tcli.make_mesh(args.mesh),
                                forward=spec.forward)
    elif args.device_row_budget:
        pred = TieredPredictor(spec.model, spec.numeric_columns,
                               spec.collections, args.ckpt_dir,
                               device_row_budget=args.device_row_budget,
                               forward=spec.forward)
    else:
        pred = Predictor(spec.model, spec.numeric_columns, spec.collections,
                         args.ckpt_dir, forward=spec.forward)
    srv = make_server(pred, args.host, args.port, args.refresh_secs,
                      dynamic_batch_ms=args.dynamic_batch_ms,
                      max_batch=args.max_batch)
    print(f"serving {args.model} from {args.ckpt_dir} "
          f"on {args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
