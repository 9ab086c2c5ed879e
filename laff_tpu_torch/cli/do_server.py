#!/usr/bin/env python3
"""Retrieval server (``laff_tpu.cli.do_server``'s flags and endpoints):
loads a checkpoint, embeds the collection's gallery on the card once
(``engine.service.RetrievalService``) and serves ad-hoc text queries over
stdlib HTTP:

  POST /search   {"queries": ["a dog runs", ...], "k": 10}
                 -> {"results": [[{"id": ..., "score": ...}, ...], ...]}
  POST /ingest   {"ids": [...], "features": {"clip_ft": [[...], ...], ...}}
                 -> {"count": N, "capacity": C}   (needs --capacity slots)
  GET  /healthz  -> {"ok": true, "gallery": N, "dtype": "bf16", "heads": H}
  GET  /metrics  -> the service's counters (and the micro-batcher's)

A malformed request or a client error (a bad k, a duplicate id, a full
gallery) is a 400, a server fault a 500. With ``--batch_window_ms`` above 0
concurrent searches coalesce into one dispatch (``MicroBatcher``).
``--mesh_devices N`` above 1 launches N ranks (``parallel.launch``), one
process a card, over which the gallery is sharded by rows: rank 0 serves
HTTP and the other ranks follow its searches and ingests
(``RetrievalService(mesh=)``); ``--device cpu`` runs the plain versions of
the kernels (and gloo ranks).

  python -m laff_tpu_torch.cli.do_server iacc.3 <model_best.pth.tar> \
      --rootpath <root> --port 8080 [--gallery_dtype int8] [--capacity N]
"""

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from laff_tpu_torch.utils import ROOT_PATH, get_logger

logger = get_logger("do_server")


def parse_args(argv=None):
    p = argparse.ArgumentParser("LAFF retrieval server (PyTorch/CUDA port)")
    p.add_argument("collection", type=str, help="gallery collection")
    p.add_argument("model_path", type=str, help="checkpoint to serve")
    p.add_argument("--rootpath", type=str, default=ROOT_PATH)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--k_default", type=int, default=10)
    p.add_argument("--gallery_dtype", type=str, default="bf16", choices=["bf16", "int8"],
                   help="int8 = half the device memory, quantized scores (rankings hold)")
    p.add_argument("--capacity", type=int, default=0,
                   help="preallocated gallery slots for POST /ingest (0 = read-only at its "
                        "initial size)")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="coalesce concurrent /search requests arriving within this window "
                        "into one dispatch (0 disables)")
    p.add_argument("--gallery_cache", type=str, default=None,
                   help="snapshot file (.npz) of the embedded gallery: a restart restores it "
                        "instead of running the video tower")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="shard the gallery over N devices, one process each (rank 0 "
                        "serves HTTP); 0 = one device")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    return p.parse_args(argv)


def make_handler(service, k_default: int):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "gallery": len(service.vis_ids),
                                  "dtype": service.gallery_dtype, "heads": service.heads})
            elif self.path == "/metrics":
                self._reply(200, service.metrics())
            else:
                self._reply(404, {"error": "unknown path"})

        def _ingest(self):
            try:
                req = self._body()
                ids, feats = req.get("ids"), req.get("features")
                if (not isinstance(ids, list) or not all(isinstance(i, str) for i in ids)
                        or not isinstance(feats, dict)):
                    self._reply(400, {"error": "'ids' must be a list of strings and "
                                               "'features' a dict of name -> rows"})
                    return
                try:
                    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in feats.items()}
                except (TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad feature rows: {e}"})
                    return
                count = service.add_videos(ids, arrays)
                self._reply(200, {"count": count, "capacity": service.capacity})
            except (ValueError, TypeError, IndexError, KeyError) as e:
                # client input (shapes, duplicates, capacity, an unknown feature)
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - a server fault, reported
                logger.exception("ingest failed")
                self._reply(500, {"error": str(e)})

        def _search(self):
            try:
                req = self._body()
                queries = req.get("queries")
                if not isinstance(queries, list) or not all(isinstance(q, str)
                                                            for q in queries):
                    self._reply(400, {"error": "'queries' must be a list of strings"})
                    return
                k = req.get("k", k_default)
                if not isinstance(k, int) or isinstance(k, bool) or not 1 <= k <= 10000:
                    self._reply(400, {"error": "'k' must be an int in [1, 10000]"})
                    return
                results = service.search(queries, k=k)
                self._reply(200, {"results": [[{"id": vid, "score": score} for vid, score in row]
                                              for row in results]})
            except Exception as e:  # noqa: BLE001 - reported to the client
                logger.exception("search failed")
                self._reply(500, {"error": str(e)})

        def do_POST(self):
            if self.path == "/ingest":
                self._ingest()
            elif self.path == "/search":
                self._search()
            else:
                self._reply(404, {"error": "unknown path"})

        def log_message(self, fmt, *args):
            logger.info("%s %s", self.address_string(), fmt % args)

    return Handler


class _Front:
    """The service with searches routed through the micro-batcher;
    everything else (ingest, metadata) goes to the service."""

    def __init__(self, service, batcher) -> None:
        self._service = service
        self._batcher = batcher

    def search(self, queries, k=10):
        return self._batcher.search(queries, k=k)

    def metrics(self):
        m = self._service.metrics()
        m["batched_requests"] = self._batcher.requests
        m["fused_dispatches"] = self._batcher.dispatches
        return m

    def __getattr__(self, name):
        return getattr(self._service, name)


def build_service(args, mesh=None):
    from laff_tpu_torch.engine.service import RetrievalService

    return RetrievalService(args.model_path, args.rootpath, args.collection,
                            batch_size=args.batch_size, gallery_dtype=args.gallery_dtype,
                            capacity=args.capacity or None, gallery_cache=args.gallery_cache,
                            mesh=mesh, device=args.device)


def build_server(args, mesh=None):
    """(server, service, batcher or None) for parsed ``args`` (on rank 0 of
    ``mesh`` when given); the caller runs ``server.serve_forever`` and, when
    done, shuts the server down, closes the batcher and closes the service
    (which releases the other ranks)."""
    from laff_tpu_torch.engine.service import MicroBatcher

    service = build_service(args, mesh)
    front, batcher = service, None
    if args.batch_window_ms > 0:
        batcher = MicroBatcher(service, window_ms=args.batch_window_ms)
        front = _Front(service, batcher)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(front, args.k_default))
    logger.info("serving %s on http://%s:%d (POST /search)", args.collection, args.host,
                server.server_address[1])
    return server, service, batcher


def serve(args, mesh=None) -> None:
    server, service, batcher = build_server(args, mesh)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
        service.close()


def serve_rank(mesh, args) -> None:
    """One rank of ``--mesh_devices``: rank 0 serves, the others follow."""
    if mesh.is_main:
        serve(args, mesh)
    else:
        build_service(args, mesh).follow()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh_devices > 1:
        from laff_tpu_torch.parallel import launch

        launch(args.mesh_devices, serve_rank, args, device=args.device)
    else:
        serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
