"""Registration server of the port: serve an exported artifact over HTTP
(twin of ``rdmnet_tpu/cli/serve.py``, same protocol).

Usage:
    rdmnet-torch-serve --artifact_dir output/export [--host 127.0.0.1]
                       [--port 8477] [--warmup] [--device cpu]

An artifact of the JAX package (no ``config`` in its ``serving.json``)
serves when ``--buckets`` gives the scales it was exported with; the config
then comes from ``--cfg_preset`` and the pyramid overrides, which are
refused without ``--buckets`` (the port's artifact carries its config).

Protocol (npz over HTTP):

* ``POST /register`` — request body is an ``.npz`` with ``ref_points`` and
  ``src_points`` (N, >=3) float arrays; the response body is an ``.npz``
  with ``estimated_transform`` (4, 4), ``ref_corr_points`` /
  ``src_corr_points`` / ``corr_scores`` trimmed to the valid
  correspondences (``corr_scores > 0``). A malformed body gets 400, a
  failure while serving 500.
* ``GET /healthz`` — JSON artifact metadata, request and error counters and
  requests per bucket.

Requests are serialized around the device call: ThreadingHTTPServer
overlaps the network IO, and the compute lock keeps one request on the card
at a time.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(serve_fn, meta):
    lock = threading.Lock()
    counter = {"requests": 0, "errors": 0}
    bucket_counts = {}  # capacity -> requests served at that bucket

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default stderr chatter
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            with lock:  # POST threads mutate counter/bucket_counts
                body = json.dumps(
                    {"ok": True, **meta, **counter,
                     "bucket_requests": {str(k): v for k, v in bucket_counts.items()}}
                ).encode()
            self._send(200, body, "application/json")

        def do_POST(self):
            if self.path != "/register":
                self._send(404, b"not found", "text/plain")
                return
            try:  # client errors -> 400
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                ref = np.asarray(data["ref_points"], np.float32)
                src = np.asarray(data["src_points"], np.float32)
            except Exception as e:  # malformed request must not kill the server
                with lock:
                    counter["errors"] += 1
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            try:  # server/device faults -> 500 (so clients retry/fail over)
                with lock:
                    out = serve_fn(ref, src)
                    counter["requests"] += 1
                    cap = getattr(serve_fn, "last_cap", None)
                    if cap is not None:
                        bucket_counts[cap] = bucket_counts.get(cap, 0) + 1
                sel = out["corr_scores"] > 0
                buf = io.BytesIO()
                np.savez(
                    buf,
                    estimated_transform=out["estimated_transform"],
                    ref_corr_points=out["ref_corr_points"][sel],
                    src_corr_points=out["src_corr_points"][sel],
                    corr_scores=out["corr_scores"][sel],
                )
                self._send(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:
                with lock:
                    counter["errors"] += 1
                self._send(500, f"internal error: {e}".encode(), "text/plain")

    return Handler


def main(argv=None):
    from rdmnet_tpu_torch.cli.common import add_pyramid_overrides, make_cli_cfg

    parser = argparse.ArgumentParser()
    add_pyramid_overrides(parser)
    parser.add_argument("--artifact_dir", required=True,
                        help="directory written by rdmnet-torch-export (or rdmnet-export)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8477)
    parser.add_argument("--warmup", action="store_true",
                        help="run one synthetic pair per bucket before accepting traffic")
    parser.add_argument("--buckets", default=None,
                        help="bucket scales of an artifact of the JAX package (comma floats)")
    args = parser.parse_args(argv)
    given = [f"--{k}" for k in ("caps", "band_caps", "neighbor_limits", "cfg_preset")
             if getattr(args, k) is not None]
    if given and not args.buckets:
        # the port's artifact carries its config: only a JAX artifact reads these
        parser.error(f"{', '.join(given)} apply only with --buckets (an artifact of the "
                     "JAX package)")

    from rdmnet_tpu_torch.serving import load_exported

    cfg = scales = None
    if args.buckets:
        cfg = make_cli_cfg(args)
        scales = [float(s) for s in args.buckets.split(",") if s.strip()]
    serve_fn, meta = load_exported(args.artifact_dir, device=args.device, cfg=cfg,
                                   bucket_scales=scales)
    if args.warmup:
        rng = np.random.RandomState(0)
        # one pair PER bucket: each capacity has its own shapes
        for b in meta.get("buckets") or [{"cap": meta["cap"]}]:
            pts = (rng.rand(int(b["cap"]), 3) * 20).astype(np.float32)
            serve_fn(pts, pts)

    server = ThreadingHTTPServer((args.host, args.port), make_handler(serve_fn, meta))
    print(f"serving {args.artifact_dir} on http://{args.host}:{server.server_address[1]}",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
