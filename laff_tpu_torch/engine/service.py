"""Online retrieval serving (``laff_tpu.engine.service``): checkpoint ->
resident gallery -> live queries.

``RetrievalService`` loads a checkpoint once, embeds a collection's gallery
through the video tower once (the gate kernel on the card, batch by batch)
into a preallocated buffer on the device, bf16 rows or int8 rows with f32
scales (``ops.quantized``), and answers ad-hoc text queries: each query
chunk is one text-tower pass (in-graph BERT, GRU, bow, w2v, a live tower)
and one scoring of the resident gallery.

Scoring is a plain product, as ``laff_tpu``'s XLA ``_score_topk``: f32 sums
of bf16 products divided by the head count (``evaluator._flat_scores``), or
``int8_scores``. The gallery is scored in blocks of ``SCORE_BLOCK`` rows, so
no product or upcast of the whole gallery is ever held (at 335,944 x 4,096
that would be 5.5 GB of f32 on every search), and the blocks' top k are
merged as they come. Only the live rows are scored: the capacity slots
beyond the live count never enter a product and are never returned. Each
list is ordered by score, and equal scores in decreasing gallery index, as
every top-k list of the port orders them (``evaluator.ordered_topk``);
``laff_tpu``'s ``lax.top_k`` puts the lower index first. The order is
exact: each (score, index) pair is packed into one int64 key that sorts as
the pair does, so ``torch.topk`` (whose order of ties is unspecified) never
sees a tie.

Query counts round up to the buckets (1, 8, 64, 512) for the text tower's
batch, and ``k`` to the k buckets (10, 100, 1,000, 10,000, at most the
capacity), as in ``laff_tpu``, whose compiled executables they key;
results are sliced back. ``add_videos`` embeds new videos and writes them
in place into the capacity slots. ``gallery_cache`` keeps an ``.npz``
snapshot of the serving arrays in ``laff_tpu``'s layout and key
(``vn_bf16`` as a uint16 view, or ``vq`` / ``vs``; ``vis_ids``, ``heads``,
``key`` = abspath|mtime|collection|dtype), so a restart skips the embed.

``MicroBatcher`` coalesces concurrent ``search`` calls into one dispatch
(``cli/do_server.py`` fronts the service with it). A ``mesh`` shards the
gallery over the ranks of a launched group (``RetrievalService``). Not
taken from ``laff_tpu``: the compile cache belongs to JAX and has no
counterpart.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import EvalFeed, TextBatcher, VisBatcher
from ..ops import flatten_heads, int8_scores, quantize_rows
from ..ops.similarity import blocked_topk
from ..parallel.mesh import Mesh
from ..parallel.sim_engine import sharded_blocked_topk
from ..utils import get_logger
from .checkpoint import load_checkpoint
from .evaluator import Embedder, _vis_blocks
from .predictor import rebuild_featurizers, rebuild_model, resolve_device
from .prepare import vision_source

logger = get_logger(__name__)

SCORE_BLOCK = 32768  # gallery rows per scored block: a 512 MB f32 upcast at 4,096 wide


class MicroBatcher:
    """Coalesce concurrent ``search`` calls into single device dispatches
    (``laff_tpu``'s): a dispatcher thread drains everything queued (up to
    ``max_queries`` requests) after waiting ``window_ms`` for stragglers,
    runs one search for the union at the largest ``k`` asked, and slices
    each request's rows back, truncated to its own ``k``. A failure reaches
    every caller of the batch. The thread turns grad off for itself (grad
    mode is per thread); ``close`` joins it."""

    def __init__(self, service: "RetrievalService", window_ms: float = 2.0,
                 max_queries: int = 512) -> None:
        self._service = service
        self._window = window_ms / 1e3
        self._max = max_queries
        self._pending: List[tuple] = []  # (queries, k, event, slot)
        self._cv = threading.Condition()
        self._closed = False
        self.dispatches = 0  # fused searches run
        self.requests = 0  # search() calls taken
        self._thread = threading.Thread(target=self._run, daemon=True, name="laff-microbatch")
        self._thread.start()

    def search(self, queries: Sequence[str], k: int = 10):
        """``RetrievalService.search``, batched across concurrent callers."""
        if not queries:
            return []
        if int(k) < 1:  # per request: a bad k must not fail the batch
            raise ValueError(f"k must be >= 1, got {k}")
        slot: dict = {}
        done = threading.Event()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append((list(queries), int(k), done, slot))
            self.requests += 1
            self._cv.notify()
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def _run(self) -> None:
        torch.set_grad_enabled(False)
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            time.sleep(self._window)  # stragglers of an idle period join this batch
            with self._cv:
                batch, self._pending = self._pending[:self._max], self._pending[self._max:]
            queries = [q for qs, _, _, _ in batch for q in qs]
            k_max = max(k for _, k, _, _ in batch)
            try:
                results = self._service.search(queries, k=k_max)
                self.dispatches += 1
                off = 0
                for qs, k, event, slot in batch:
                    slot["result"] = [row[:k] for row in results[off:off + len(qs)]]
                    off += len(qs)
                    event.set()
            except Exception as e:  # noqa: BLE001 - delivered to every caller
                for _, _, event, slot in batch:
                    slot["error"] = e
                    event.set()


class _QueryBatcher:
    """An ``EvalFeed`` batcher over a list of query strings (ids are list
    indices as strings)."""

    def __init__(self, text_batcher: TextBatcher, queries: Sequence[str]) -> None:
        self._tb = text_batcher
        self._queries = list(queries)

    def __call__(self, ids: Sequence[str]) -> Dict[str, np.ndarray]:
        return self._tb.encode_captions([self._queries[int(i)] for i in ids], ids)


class RetrievalService:
    """Checkpoint + feature collection -> live text-to-video search on
    ``device`` (the card unless the caller names the CPU).

    gallery_dtype 'bf16': the per-head unit rows in bf16 (exact
    mean-of-cosines scores); 'int8': symmetric per-row int8 with f32 scales
    at half the bytes, whose rankings hold but whose score values are not
    cosine-exact (a warning says so; the predictor's ``--int8_gallery 1``
    gives exact scores).

    Raises ``ValueError`` for a checkpoint trained with measure 'hist' and
    for one with a precomputed-only text modality (ad-hoc queries have no
    precomputed rows). A FrameLAFF gallery's frames are cut at the config's
    ``max_frame`` (``laff_tpu``'s ``max_frame`` override has no caller and
    is not taken).

    With a ``mesh`` (``parallel.Mesh``, one rank of a launched group, on
    ``mesh.device``) the gallery is split into equal slabs of rows, the
    capacity rounded up to a multiple of the world (``laff_tpu``'s
    ``_make_sharded_scorers``): rank r holds global rows [r * slab, (r + 1) *
    slab) and embeds only its own live rows through the video tower, so the
    gate kernel runs on every card. Rank 0 drives: ``search`` and
    ``add_videos`` are called there (the HTTP front and the micro-batcher
    live on rank 0), and each broadcasts its work to the other ranks, which
    sit in ``follow`` until rank 0's ``close``. A search embeds the queries
    on rank 0 and broadcasts their rows and k; every rank scores its slab
    with the same ``score_block`` and blocked top k, and the (score, global
    column) keys of every rank merge (``parallel.sim_engine``), so results
    are in the one-card order. An ingested row lands in the slab that owns
    its slot. A snapshot keeps the one-card file format: rank 0 gathers the
    live rows and writes it, and a restart over a mesh slices it."""

    _BUCKETS = (1, 8, 64, 512)
    _K_BUCKETS = (10, 100, 1000, 10000)

    def __init__(self, model_path: str, rootpath: str, collection: str,
                 batch_size: int = 512, gallery_dtype: str = "bf16",
                 capacity: Optional[int] = None,
                 gallery_cache: Optional[str] = None, mesh: Optional[Mesh] = None,
                 device="cuda") -> None:
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        ckpt = load_checkpoint(model_path)
        self.config = ckpt["config"]
        measure = getattr(self.config, "measure", "cosine")
        if measure != "cosine":
            raise ValueError(
                f"RetrievalService only serves measure='cosine' checkpoints (this one was "
                f"trained with measure={measure!r}; use the predictor for batch evaluation)")
        featurizers = rebuild_featurizers(ckpt, rootpath, self.device)
        dead = [n for n, f in featurizers.items() if f is None]
        if dead:
            raise ValueError(
                f"text modalities {dead} are precomputed-only in this config; ad-hoc queries "
                f"cannot be embedded. Serve a checkpoint whose text encoders are live "
                f"(bow/w2v/gru/netvlad/in-graph bert/live clip).")
        if gallery_dtype not in ("bf16", "int8"):
            raise ValueError(f"gallery_dtype {gallery_dtype!r} is not 'bf16' or 'int8'")
        self.spec = ckpt["spec"]
        self.embedder = Embedder(rebuild_model(ckpt, self.device), self.device)
        self._text_batcher = TextBatcher(None, featurizers,
                                         max_txtlength=getattr(self.config, "max_txtlength", 77))
        self._lock = threading.Lock()
        self.gallery_dtype = gallery_dtype
        if gallery_dtype == "int8":
            logger.warning(
                "gallery_dtype='int8': search() scores are quantized approximations on the int8 "
                "scale — rankings are reliable but score VALUES are not cosine-exact; use the "
                "predictor's --int8_gallery rescored path when exact scores matter")

        t0 = time.perf_counter()
        snap = None
        if gallery_cache and self._main:
            snap = self._load_snapshot(gallery_cache, model_path, collection, gallery_dtype)
        if mesh is not None and self.mesh.broadcast_object(snap is not None) and snap is None:
            snap = np.load(gallery_cache, allow_pickle=False)  # rank 0 found it good
        self._vn = self._vq = self._vs = None
        if snap is not None:
            self.vis_ids = [str(v) for v in snap["vis_ids"]]
            self.heads = int(snap["heads"])
            self._set_capacity(capacity)
            lo, hi = self._live_rows()
            if gallery_dtype == "int8":
                self._allocate(snap["vq"].shape[1])
                self._write(0, torch.from_numpy(snap["vq"][lo:hi]),
                            torch.from_numpy(snap["vs"][lo:hi]))
            else:
                rows = torch.from_numpy(snap["vn_bf16"][lo:hi].view(np.int16))
                self._allocate(rows.shape[1])
                self._write(0, rows.view(torch.bfloat16))
            logger.info("gallery restored from snapshot %s (%d videos)", gallery_cache,
                        self._count)
        else:
            source = vision_source(rootpath, collection, self.config)
            self.vis_ids = list(source.vis_ids)
            self._set_capacity(capacity)
            lo, hi = self._live_rows()
            feed = EvalFeed(self.vis_ids[lo:hi], VisBatcher(source), batch_size=batch_size)
            row = 0
            with torch.no_grad():
                for emb, _ in _vis_blocks(self.embedder, feed):
                    if row == 0:
                        self.heads = emb.shape[1] if emb.ndim == 3 else 1
                        self._allocate(emb.shape[1] * (emb.shape[2] if emb.ndim == 3 else 1))
                    self._write_embeddings(row, emb)
                    row += emb.shape[0]
            if mesh is not None:  # a rank with no live rows learns the width from rank 0
                self.heads, width = self.mesh.broadcast_object(
                    (self.heads, self.width) if self._main else None)
                if self._vn is None and self._vq is None:
                    self._allocate(width)
            if gallery_cache:
                self._save_snapshot(gallery_cache, model_path, collection, gallery_dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_seconds = time.perf_counter() - t0
        self._id_set = set(self.vis_ids)
        # the ids as one object array: a result row is one fancy index
        self._id_array = np.asarray(self.vis_ids, dtype=object)
        self._stats = {"searches": 0, "queries": 0, "search_seconds": 0.0,
                       "search_seconds_max": 0.0, "ingests": 0, "ingested_rows": 0}
        logger.info("serving %d videos (%s gallery, capacity %d, %.1f MB on %s%s), %d heads x "
                    "%d dims, built in %.1f s", self._count, gallery_dtype, self.capacity,
                    self.gallery_bytes / 1e6, self.device,
                    f", slab {self.slab} of {mesh.size}" if mesh is not None else "",
                    self.heads, self.width // self.heads, self.build_seconds)

    # -- the mesh ------------------------------------------------------------

    @property
    def _main(self) -> bool:
        return self.mesh is None or self.mesh.is_main

    def _set_capacity(self, capacity: Optional[int]) -> None:
        """The live count, the capacity (a multiple of the world over a mesh)
        and this rank's slab of rows."""
        self._count = len(self.vis_ids)
        cap = max(int(capacity or 0), self._count)
        size = 1 if self.mesh is None else self.mesh.size
        self.capacity = -(-cap // size) * size
        self.slab = self.capacity // size
        self._row0 = 0 if self.mesh is None else self.mesh.rank * self.slab

    def _live_rows(self, count: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi): the global rows of this rank's slab below ``count`` (the
        live count by default)."""
        count = self._count if count is None else count
        lo = self._row0
        return lo, max(lo, min(count, lo + self.slab))

    @torch.no_grad()
    def follow(self) -> None:
        """A rank other than 0: do what rank 0 broadcasts (searches, ingests)
        until it closes."""
        while True:
            op, args = self.mesh.broadcast_object()
            if op == "close":
                return
            if op == "search":
                n, k = args
                tn = torch.empty((n, self.width), dtype=torch.float32, device=self.device)
                self._sharded_topk(self.mesh.broadcast(tn), k)
            else:
                self._ingest(*args)

    def close(self) -> None:
        """Rank 0 of a mesh: release the other ranks from ``follow``."""
        if self.mesh is not None and self._main:
            with self._lock:
                self.mesh.broadcast_object(("close", None))

    # -- the resident gallery ------------------------------------------------

    def _allocate(self, width: int) -> None:
        self.width = width
        if self.gallery_dtype == "int8":
            self._vq = torch.zeros((self.slab, width), dtype=torch.int8, device=self.device)
            self._vs = torch.ones((self.slab,), dtype=torch.float32, device=self.device)
        else:
            self._vn = torch.zeros((self.slab, width), dtype=torch.bfloat16, device=self.device)

    @property
    def gallery_bytes(self) -> int:
        if self._vn is not None:
            return self._vn.numel() * 2
        return self._vq.numel() + self._vs.numel() * 4

    def _write(self, row: int, rows: torch.Tensor, scales: Optional[torch.Tensor] = None):
        """``rows`` at ``row`` of this rank's slab."""
        n = rows.shape[0]
        if scales is not None:
            self._vq[row:row + n] = rows.to(self.device)
            self._vs[row:row + n] = scales.to(self.device)
        else:
            self._vn[row:row + n] = rows.to(self.device)

    def _write_embeddings(self, row: int, embs: torch.Tensor) -> None:
        """Tower outputs -> per-head unit rows, written at ``row`` in the
        gallery's type."""
        flat = flatten_heads(embs)
        if self.gallery_dtype == "int8":
            self._write(row, *quantize_rows(flat))
        else:
            self._write(row, flat.to(torch.bfloat16))

    # -- snapshots -----------------------------------------------------------

    @staticmethod
    def _snapshot_key(model_path: str, collection: str, dtype: str) -> str:
        p = os.path.abspath(model_path)
        return f"{p}|{os.path.getmtime(p):.6f}|{collection}|{dtype}"

    def _load_snapshot(self, path: str, model_path: str, collection: str, dtype: str):
        if not os.path.exists(path):
            return None
        try:
            snap = np.load(path, allow_pickle=False)
        except (OSError, ValueError) as e:
            logger.warning("gallery snapshot %s unreadable (%s); re-embedding", path, e)
            return None
        if str(snap["key"]) != self._snapshot_key(model_path, collection, dtype):
            logger.info("gallery snapshot %s is for a different checkpoint/collection/dtype; "
                        "re-embedding", path)
            return None
        return snap

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """The live rows of every slab (rank 0 gathers them over a mesh)."""
        if self.mesh is not None:
            t = self.mesh.all_gather(t)
        return t[:self._count]

    def _save_snapshot(self, path: str, model_path: str, collection: str, dtype: str) -> None:
        """The live rows only (not the capacity slots), in ``laff_tpu``'s
        layout; over a mesh, rank 0 writes every slab's."""
        if dtype == "int8":
            vq, vs = self._gathered(self._vq), self._gathered(self._vs)
        else:
            vn = self._gathered(self._vn)
        if not self._main:
            return
        arrays = {"key": np.asarray(self._snapshot_key(model_path, collection, dtype)),
                  "vis_ids": np.asarray(self.vis_ids), "heads": np.asarray(self.heads)}
        if dtype == "int8":
            arrays["vq"], arrays["vs"] = vq.cpu().numpy(), vs.cpu().numpy()
        else:
            arrays["vn_bf16"] = vn.view(torch.int16).cpu().numpy().view(np.uint16)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
        logger.info("gallery snapshot written to %s (%d videos)", path, self._count)

    # -- ingest --------------------------------------------------------------

    def add_videos(self, vis_ids: Sequence[str], features: Dict[str, np.ndarray],
                   batch_size: int = 64) -> int:
        """Live ingest: embed new videos through the video tower and write
        them into the capacity slots after the live rows. ``features`` holds
        the arrays of a VisBatcher batch (feature name -> (N, D) rows).
        Returns the new live count; queries see the videos at once. Over a
        mesh (called on rank 0) each rank embeds the new rows its slab
        holds."""
        vis_ids = list(vis_ids)
        n = len(vis_ids)
        if n == 0:
            return self._count
        if len(set(vis_ids)) != n:
            raise ValueError("duplicate ids within the ingest request")
        rows = {}
        for name, v in features.items():
            v = np.asarray(v, dtype=np.float32)
            if v.ndim != 2 or v.shape[0] != n:
                raise ValueError(f"features[{name!r}] must be ({n}, D) rows, got {v.shape}")
            rows[name] = v
        # every check on the live count happens under the lock: a concurrent
        # ingest could otherwise move it past the capacity
        with self._lock:
            dup = set(vis_ids) & self._id_set
            if dup:
                raise ValueError(f"videos already served: {sorted(dup)[:5]}")
            if self._count + n > self.capacity:
                raise ValueError(f"gallery capacity exhausted ({self._count}+{n} > "
                                 f"{self.capacity}); construct with a larger capacity=")
            if self.mesh is not None:
                self.mesh.broadcast_object(("ingest", (vis_ids, rows, batch_size)))
            self._ingest(vis_ids, rows, batch_size)
            self._stats["ingests"] += 1
            self._stats["ingested_rows"] += n
        logger.info("ingested %d videos (live count %d / capacity %d)", n, self._count,
                    self.capacity)
        return self._count

    def _ingest(self, vis_ids: List[str], rows: Dict[str, np.ndarray], batch_size: int) -> None:
        """Embed and write the new rows this rank's slab holds; every rank
        counts them."""
        n = len(vis_ids)
        lo, hi = self._live_rows(self._count + n)
        lo = max(lo, self._count)
        if hi > lo:
            pick = range(lo - self._count, hi - self._count)
            feed = EvalFeed([str(i) for i in pick],
                            lambda ids: {k: v[[int(i) for i in ids]] for k, v in rows.items()},
                            batch_size=batch_size)
            embs, _ = self.embedder.embed_vis(feed)
            self._write_embeddings(lo - self._row0, embs)
        self.vis_ids.extend(vis_ids)
        self._id_set.update(vis_ids)
        self._id_array = np.concatenate([self._id_array, np.asarray(vis_ids, dtype=object)])
        self._count += n

    # -- search --------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return next((b for b in self._BUCKETS if n <= b), self._BUCKETS[-1])

    def search(self, queries: Sequence[str], k: int = 10) -> List[List[Tuple[str, float]]]:
        """Ranked (vis_id, score) lists, one per query, best first."""
        if not queries:
            return []
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        k_exec = min(next((b for b in self._K_BUCKETS if k <= b), self._K_BUCKETS[-1]),
                     self.capacity)
        out: List[List[Tuple[str, float]]] = []
        t0 = time.perf_counter()
        with self._lock:
            k = min(k, self._count, k_exec)
            for start in range(0, len(queries), self._BUCKETS[-1]):
                out.extend(self._search_chunk(list(queries[start:start + self._BUCKETS[-1]]),
                                              k, k_exec))
            dt = time.perf_counter() - t0
            self._stats["searches"] += 1
            self._stats["queries"] += len(queries)
            self._stats["search_seconds"] += dt
            self._stats["search_seconds_max"] = max(self._stats["search_seconds_max"], dt)
        return out

    def embed_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """The per-head unit rows (N, H*d) f32 of up to 512 queries, through
        the text tower at the query count's bucket."""
        feed = EvalFeed([str(i) for i in range(len(queries))],
                        _QueryBatcher(self._text_batcher, queries),
                        batch_size=self._bucket(len(queries)))
        return flatten_heads(self.embedder.embed_txt(feed)[0])

    def score_block(self, tn: torch.Tensor) -> Callable[[int, int], torch.Tensor]:
        """start, stop -> the (N, stop - start) scores of the gallery rows
        [start, stop): f32 sums of bf16 products over the head count, or the
        int8 product rescaled."""
        heads = self.heads
        if self.gallery_dtype == "int8":
            tq, ts = quantize_rows(tn)
            return lambda s, e: int8_scores(tq, ts, self._vq[s:e], self._vs[s:e]) / heads
        t = tn.to(torch.bfloat16).float()
        return lambda s, e: (t @ self._vn[s:e].float().T) / heads

    def _sharded_topk(self, tn: torch.Tensor, k: int):
        """Every rank: the top ``k`` of the live rows over all slabs."""
        return sharded_blocked_topk(self.score_block(tn), tn.shape[0], self.slab, self._count,
                                    k, self.mesh, self.device, SCORE_BLOCK)

    @torch.no_grad()
    def _search_chunk(self, chunk: List[str], k: int, k_exec: int):
        tn = self.embed_queries(chunk)
        k_run = min(k_exec, self._count)
        if self.mesh is not None:
            self.mesh.broadcast_object(("search", (tn.shape[0], k_run)))
            vals, idx = self._sharded_topk(self.mesh.broadcast(tn), k_run)
            vals, idx = vals[:, :k], idx[:, :k]
        else:
            vals, idx = blocked_topk(self.score_block(tn), self._count, k_run, SCORE_BLOCK)
            vals, idx = vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
        return [list(zip(self._id_array[row_i].tolist(), row_v.tolist()))
                for row_i, row_v in zip(idx, vals)]

    def metrics(self) -> Dict:
        """Counters for the /metrics endpoint (JSON-serializable)."""
        with self._lock:
            out = dict(self._stats)
        out.update(gallery=self._count, capacity=self.capacity, dtype=self.gallery_dtype,
                   heads=self.heads)
        return out
