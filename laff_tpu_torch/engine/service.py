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
(``cli/do_server.py`` fronts the service with it). Not taken from
``laff_tpu``: a ``mesh`` (a gallery sharded over devices) raises, naming
its ROADMAP item; the compile cache belongs to JAX and has no counterpart.
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


def _order_keys(scores: torch.Tensor, col0: int) -> torch.Tensor:
    """(T, B) f32 scores of gallery columns col0.. -> int64 keys that sort
    as (score, column): the score's bits made monotone as a signed int32
    (negative floats have their magnitude bits flipped; -0.0 is made +0.0)
    in the high word, the column in the low word."""
    bits = (scores + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(col0, col0 + scores.shape[1], device=scores.device)
    return (bits.to(torch.int64) << 32) | cols


def _decode_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    bits = (keys >> 32).to(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def blocked_topk(score_block: Callable[[int, int], torch.Tensor], n_rows: int,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top ``k`` of ``n_rows`` gallery rows, scored
    ``score_block(start, stop)`` -> (T, stop - start) ``SCORE_BLOCK`` rows at
    a time: (values (T, k), indices (T, k)), descending, equal scores in
    decreasing gallery index."""
    run = None
    for start in range(0, n_rows, SCORE_BLOCK):
        keys = _order_keys(score_block(start, min(start + SCORE_BLOCK, n_rows)), start)
        if run is not None:
            keys = torch.cat([run, keys], dim=1)
        run = torch.topk(keys, min(k, keys.shape[1]), dim=1).values
    return _decode_keys(run)


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
    precomputed rows), and ``NotImplementedError`` for a ``mesh``. A
    FrameLAFF gallery's frames are cut at the config's ``max_frame``
    (``laff_tpu``'s ``max_frame`` override has no caller and is not taken)."""

    _BUCKETS = (1, 8, 64, 512)
    _K_BUCKETS = (10, 100, 1000, 10000)

    def __init__(self, model_path: str, rootpath: str, collection: str,
                 batch_size: int = 512, gallery_dtype: str = "bf16",
                 capacity: Optional[int] = None,
                 gallery_cache: Optional[str] = None, mesh=None, device="cuda") -> None:
        if mesh is not None:
            raise NotImplementedError("a gallery sharded over a device mesh is not ported yet: "
                                      "ROADMAP Queue 1 item 5")
        self.device = resolve_device(device)
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
        snap = (self._load_snapshot(gallery_cache, model_path, collection, gallery_dtype)
                if gallery_cache else None)
        self._vn = self._vq = self._vs = None
        if snap is not None:
            self.vis_ids = [str(v) for v in snap["vis_ids"]]
            self.heads = int(snap["heads"])
            self._count = len(self.vis_ids)
            self.capacity = max(int(capacity or 0), self._count)
            if gallery_dtype == "int8":
                self._allocate(snap["vq"].shape[1])
                self._write(0, torch.from_numpy(snap["vq"]), torch.from_numpy(snap["vs"]))
            else:
                rows = torch.from_numpy(snap["vn_bf16"].view(np.int16)).view(torch.bfloat16)
                self._allocate(rows.shape[1])
                self._write(0, rows)
            logger.info("gallery restored from snapshot %s (%d videos)", gallery_cache,
                        self._count)
        else:
            source = vision_source(rootpath, collection, self.config)
            self.vis_ids = list(source.vis_ids)
            self._count = len(self.vis_ids)
            self.capacity = max(int(capacity or 0), self._count)
            feed = EvalFeed(self.vis_ids, VisBatcher(source), batch_size=batch_size)
            row = 0
            with torch.no_grad():
                for emb, _ in _vis_blocks(self.embedder, feed):
                    if row == 0:
                        self.heads = emb.shape[1] if emb.ndim == 3 else 1
                        self._allocate(emb.shape[1] * (emb.shape[2] if emb.ndim == 3 else 1))
                    self._write_embeddings(row, emb)
                    row += emb.shape[0]
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
        logger.info("serving %d videos (%s gallery, capacity %d, %.1f MB on %s), %d heads x "
                    "%d dims, built in %.1f s", self._count, gallery_dtype, self.capacity,
                    self.gallery_bytes / 1e6, self.device, self.heads,
                    self.width // self.heads, self.build_seconds)

    # -- the resident gallery ------------------------------------------------

    def _allocate(self, width: int) -> None:
        self.width = width
        if self.gallery_dtype == "int8":
            self._vq = torch.zeros((self.capacity, width), dtype=torch.int8, device=self.device)
            self._vs = torch.ones((self.capacity,), dtype=torch.float32, device=self.device)
        else:
            self._vn = torch.zeros((self.capacity, width), dtype=torch.bfloat16,
                                   device=self.device)

    @property
    def gallery_bytes(self) -> int:
        if self._vn is not None:
            return self._vn.numel() * 2
        return self._vq.numel() + self._vs.numel() * 4

    def _write(self, row: int, rows: torch.Tensor, scales: Optional[torch.Tensor] = None):
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

    def _save_snapshot(self, path: str, model_path: str, collection: str, dtype: str) -> None:
        """The live rows only (not the capacity slots), in ``laff_tpu``'s
        layout."""
        n = self._count
        arrays = {"key": np.asarray(self._snapshot_key(model_path, collection, dtype)),
                  "vis_ids": np.asarray(self.vis_ids), "heads": np.asarray(self.heads)}
        if dtype == "int8":
            arrays["vq"] = self._vq[:n].cpu().numpy()
            arrays["vs"] = self._vs[:n].cpu().numpy()
        else:
            arrays["vn_bf16"] = self._vn[:n].view(torch.int16).cpu().numpy().view(np.uint16)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
        logger.info("gallery snapshot written to %s (%d videos)", path, n)

    # -- ingest --------------------------------------------------------------

    def add_videos(self, vis_ids: Sequence[str], features: Dict[str, np.ndarray],
                   batch_size: int = 64) -> int:
        """Live ingest: embed new videos through the video tower and write
        them into the capacity slots after the live rows. ``features`` holds
        the arrays of a VisBatcher batch (feature name -> (N, D) rows).
        Returns the new live count; queries see the videos at once."""
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
        feed = EvalFeed([str(i) for i in range(n)],
                        lambda ids: {k: v[[int(i) for i in ids]] for k, v in rows.items()},
                        batch_size=batch_size)
        # every check on the live count happens under the lock: a concurrent
        # ingest could otherwise move it past the capacity
        with self._lock:
            dup = set(vis_ids) & self._id_set
            if dup:
                raise ValueError(f"videos already served: {sorted(dup)[:5]}")
            if self._count + n > self.capacity:
                raise ValueError(f"gallery capacity exhausted ({self._count}+{n} > "
                                 f"{self.capacity}); construct with a larger capacity=")
            embs, _ = self.embedder.embed_vis(feed)
            self._write_embeddings(self._count, embs)
            self.vis_ids.extend(vis_ids)
            self._id_set.update(vis_ids)
            self._id_array = np.concatenate([self._id_array, np.asarray(vis_ids, dtype=object)])
            self._count += n
            self._stats["ingests"] += 1
            self._stats["ingested_rows"] += n
        logger.info("ingested %d videos (live count %d / capacity %d)", n, self._count,
                    self.capacity)
        return self._count

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

    @torch.no_grad()
    def _search_chunk(self, chunk: List[str], k: int, k_exec: int):
        tn = self.embed_queries(chunk)
        vals, idx = blocked_topk(self.score_block(tn), self._count, min(k_exec, self._count))
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
