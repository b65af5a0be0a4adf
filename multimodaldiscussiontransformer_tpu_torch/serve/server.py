"""Serving: dynamic micro-batching and a minimal HTTP endpoint.

- ``BatchingScorer``: a thread-safe facade that coalesces concurrent score
  requests into one device batch (up to ``max_batch`` discussions or
  ``max_wait_ms``), so many small requests share one forward;
- ``ScoreServer``: a stdlib ThreadingHTTPServer exposing the scorer as
  ``POST /v1/score`` (JSON in/out) and ``GET /healthz``.

Request schema (POST /v1/score):
    {"discussions": [
        {"parents": [-1, 0, 0, 2],          # -1 = root
         "input_ids": [[...], ...],          # (N, S) token ids
         "attention_mask": [[...], ...],     # optional, default ids != 0
         "token_type_ids": [[...], ...],     # optional, default zeros
         "images": {"3": [[[...]]]}}         # optional node -> (3, H, W)
    ]}
Response: {"probs": [[[p_norm, p_hate], ...], ...]}: per discussion, per
node, class probabilities in node order.

Serve a training checkpoint directory (``main``):

    python -m multimodaldiscussiontransformer_tpu_torch.serve.server \\
        --checkpoint ckpts/run0 --port 8000 [--device cpu]
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np

from multimodaldiscussiontransformer_tpu_torch.serve.incremental import (
    Discussion,
    DiscussionScorer,
)


@dataclass
class _Pending:
    items: Sequence  # GraphItems of one request
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[np.ndarray]] = None
    error: Optional[BaseException] = None


class BatchingScorer:
    """Coalesces concurrent ``score_items`` calls into shared device
    batches. Thread-safe; callers block until their slice is ready."""

    def __init__(self, scorer: DiscussionScorer, max_batch: int = 16, max_wait_ms: float = 5.0):
        self.scorer = scorer
        self.max_batch = int(max_batch)
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def score_items(self, items: Sequence) -> List[np.ndarray]:
        if self._closed:
            raise RuntimeError("BatchingScorer is closed")
        req = _Pending(items)
        self._queue.put(req)
        # a request racing close() past the check above must not block
        # forever once the worker has exited
        while not req.done.wait(timeout=0.5):
            if self._closed and not self._worker.is_alive():
                raise RuntimeError("BatchingScorer closed while pending")
        if req.error is not None:
            raise req.error
        return req.result

    def score(self, discussion: Discussion) -> np.ndarray:
        return self.score_items([discussion.to_item()])[0]

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=10)
        # fail a request that raced the close sentinel into the queue
        while True:
            try:
                straggler = self._queue.get_nowait()
            except queue.Empty:
                break
            if straggler is not None:
                straggler.error = RuntimeError("BatchingScorer is closed")
                straggler.done.set()

    def _drain(self, first: _Pending) -> List[_Pending]:
        """Collect more requests until max_batch discussions or max_wait."""
        group, n = [first], len(first.items)
        deadline = time.monotonic() + self.max_wait
        while n < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:  # close() sentinel: re-post for the main loop
                self._queue.put(None)
                break
            group.append(nxt)
            n += len(nxt.items)
        return group

    def _run(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            group = self._drain(req)
            flat = [it for r in group for it in r.items]
            try:
                probs = self.scorer.score_items(flat)
                off = 0
                for r in group:
                    r.result = probs[off : off + len(r.items)]
                    off += len(r.items)
            except BaseException as e:  # deliver, don't kill the worker
                for r in group:
                    r.error = e
            finally:
                for r in group:
                    r.done.set()


def _parse_discussion(obj: dict) -> Discussion:
    parents = obj["parents"]
    ids = np.asarray(obj["input_ids"], np.int32)
    if ids.ndim != 2 or ids.shape[0] != len(parents):
        raise ValueError(f"input_ids must be (num_nodes={len(parents)}, S), got {ids.shape}")
    mask = obj.get("attention_mask")
    types = obj.get("token_type_ids")
    images = {int(k): v for k, v in (obj.get("images") or {}).items()}
    d = Discussion()
    for i, parent in enumerate(parents):
        d.add_node(
            int(parent),
            ids[i],
            attention_mask=None if mask is None else np.asarray(mask[i]),
            token_type_ids=None if types is None else np.asarray(types[i]),
            image=np.asarray(images[i], np.float32) if i in images else None,
        )
    return d


class _Handler(BaseHTTPRequestHandler):
    server: "ScoreServer"
    timeout = 120  # seconds a socket read or write may block: bounds how long close() waits

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path != "/v1/score":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            discussions = [_parse_discussion(o) for o in req.get("discussions", [])]
            if not discussions:
                raise ValueError("request contains no discussions")
            items = [d.to_item(i) for i, d in enumerate(discussions)]
            probs = self.server.scorer.score_items(items)
            self._reply(200, {"probs": [p.tolist() for p in probs]})
        except Exception as e:  # surface as a 400, keep serving
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args) -> None:  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)


class ScoreServer(ThreadingHTTPServer):
    """HTTP front for a (batching) scorer:

        server = ScoreServer(("0.0.0.0", 8000), scorer)
        server.serve_forever()

    Requests from the thread-per-connection handlers coalesce inside the
    BatchingScorer into shared device batches."""

    # close() joins the handler threads: a daemon thread still closing its
    # socket while the interpreter shuts down can abort the process
    daemon_threads = False

    def __init__(self, addr, scorer, batching: bool = True, verbose: bool = False, **batch_kw):
        self.scorer = (
            scorer
            if isinstance(scorer, BatchingScorer) or not batching
            else BatchingScorer(scorer, **batch_kw)
        )
        self.verbose = verbose
        super().__init__(addr, _Handler)

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        if isinstance(self.scorer, BatchingScorer):
            self.scorer.close()


def main(argv=None) -> int:
    """Serve a trained checkpoint until interrupted."""
    import argparse

    p = argparse.ArgumentParser(description="Serve a trained mDT checkpoint over HTTP")
    p.add_argument("--checkpoint", required=True, help="save dir of a trained run")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--latest", action="store_true", default=False,
                   help="serve the latest checkpoint instead of the best")
    p.add_argument("--batch-buckets", default="pow2",
                   help="request-batch size ladder: 'pow2' (default), a comma list like '4,8,16', "
                        "or 'none' to disable batch padding")
    p.add_argument("--device", default="cuda", help="torch device to score on (default cuda; cpu to run on the CPU)")
    p.add_argument("--verbose", action="store_true", default=False)
    args = p.parse_args(argv)

    buckets = (
        None if args.batch_buckets == "none"
        else "pow2" if args.batch_buckets == "pow2"
        else tuple(int(x) for x in args.batch_buckets.split(","))
    )
    scorer = DiscussionScorer.from_checkpoint(
        args.checkpoint, best=not args.latest, device=args.device, batch_buckets=buckets
    )
    server = ScoreServer(
        (args.host, args.port), scorer, verbose=args.verbose, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms
    )
    host, port = server.server_address[:2]
    print(f"serving {args.checkpoint} on http://{host}:{port} (POST /v1/score, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
