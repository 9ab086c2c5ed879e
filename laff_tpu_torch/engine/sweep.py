"""Seed sweeps: S runs of one config trained in one process
(``laff_tpu.engine.sweep.sweep_main``).

``laff_tpu`` stacks the S train states and vmaps its step over them. Here
each seed is a ``trainer.TrainRun`` of its own: its own model, optimizer
and K-step dispatch (on the card a CUDA graph captured with the seed's own
generator, which ``epoch_generator`` reseeds each epoch, seed x 1000 +
epoch). Each epoch the active seeds' dispatches go to the card in turn,
K steps of one seed, then K of the next. A seed that has stopped sends no
more dispatches, so its state stays exactly as it was. What the seeds
share: the prepared data, the device caches and the w2v table (built once
under ``setup_dispatch``'s rules), and the validation feeds, staged on the
card by the first validation and replayed for every seed.

Each seed trains as the port's own ``trainer.main`` trains it, bit for bit:

* its init: ``seeded_model`` from the seed, the GRU's word embedding from
  the legacy ``RandomState(seed)`` over the w2v dump (``laff_tpu``
  :380-390), the warm start from ``pretrained_file_path`` for every seed;
* its ``PairFeed`` order and, with task3, its ``TextSource`` of false
  captions shuffled by the seed (:362-376);
* its LR controller, best / early stop, mean_last, and its checkpoints,
  ``val_perf_hist.txt``, ``val_perf.txt`` and ``scalars.tsv`` in
  ``<prefix>_seed_<s>`` (the prefix alone for one seed), the single run's
  layout, which the predictor reads unchanged.

Validation embeds each active seed with its own model (the gate kernel on
the card) and ranks it on the run's ``rank_path`` (the wide rank kernel
with 'kernel').

Over a mesh (``sweep_main(..., mesh=)``, called in every rank, as
``trainer.main(mesh=)`` is), ``laff_tpu``'s two layouts:

* a 1-D mesh (``parallel.data_parallel_mesh``): the seed axis over the
  ranks. ``len(seeds)`` must divide by the ranks; rank r trains its
  contiguous share of the seeds as a one-card sweep does (no collectives),
  each seed in its own ``<prefix>_seed_<s>``;
* a ('seed', 'dp') mesh (``parallel.seed_data_mesh``): the seeds over the
  rows, and each seed's batch over its row (``TrainRun(mesh=row)``, the
  data-parallel step of ``trainer``); ``batch_size`` must divide by
  ``n_dp``. Nothing crosses rows.

World rank 0 returns every seed's result in ``seeds``' order, each without
its 'model' (the weights are in the checkpoints); the other ranks return
an empty list. Without a mesh a sweep runs on one device (``laff_tpu``'s
sweep never reads ``data_parallel``).

Raise, as in ``laff_tpu``: ``trainCollection2`` and ``resume``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..data.sources import TextSource
from ..parallel.mesh import SeedDataMesh
from ..utils import get_logger
from .predictor import resolve_device
from .prepare import Options, Prepared, gru_init_we, model_dir_for
from .trainer import TrainRun, prepare_ranks, validation_feeds

logger = get_logger(__name__)


def seed_options(opt: Options, seeds: List[int]) -> List[Options]:
    """One Options per seed: its ``random_seed``, and its model prefix
    ``<prefix>_seed_<s>`` (the prefix alone for a single seed)."""
    prefix = opt.model_prefix
    return [dataclasses.replace(opt, random_seed=s,
                                model_prefix=f"{prefix}_seed_{s}" if len(seeds) > 1 else prefix)
            for s in seeds]


def seed_prepared(opt: Options, prepared: Prepared) -> Prepared:
    """``prepared`` (made for another seed) as ``prepare(opt)`` would give it
    for ``opt.random_seed``: the train feed's order, task3's false-caption
    source, the GRU embedding's w2v rows and the model directory."""
    s = opt.random_seed
    feed = copy.copy(prepared.train_feed)
    feed.seed = s
    if feed.task3_source is not None:
        path = os.path.join(opt.rootpath, opt.trainCollection, "TextData",
                            f"{opt.trainCollection}.caption.{opt.task3_caption}.txt")
        feed.task3_source = TextSource(path, task3=True, shuffle_seed=s)
        feed._augmented = feed.task3_source.negation_augmented()
    we = gru_init_we(prepared.config, prepared.gru_vocab, prepared.w2v_dir,
                     np.random.RandomState(s))
    model_path = model_dir_for(opt)
    os.makedirs(model_path, exist_ok=True)
    return dataclasses.replace(prepared, train_feed=feed, we=we, model_path=model_path)


def _layout(mesh):
    """(world, row, index, shares) of a sweep's mesh: this rank trains the
    index-th of ``shares`` equal shares of the seeds; with ``row``, each as
    one rank of a data-parallel run over it."""
    if mesh is None:
        return None, None, 0, 1
    if isinstance(mesh, SeedDataMesh):
        return mesh.world, mesh.row, mesh.seed_index, mesh.n_seed
    return mesh, None, mesh.rank, mesh.size


def sweep_main(opt: Options, seeds: List[int], prepared: Optional[Prepared] = None,
               mesh=None) -> List[Dict]:
    """Train ``len(seeds)`` runs of ``opt``'s experiment in this process, or
    this rank's share of them over ``mesh`` (see the module docstring).
    Returns one ``trainer.main``-shaped result per seed, in ``seeds``'
    order (under a mesh on world rank 0 only)."""
    world, row, index, shares = _layout(mesh)
    if len(seeds) % shares:
        raise ValueError(f"{len(seeds)} seeds must divide over the mesh's {shares} "
                         f"{'rows' if row is not None else 'ranks'}")
    if row is not None and opt.batch_size % row.size:
        raise ValueError(f"batch_size {opt.batch_size} must divide the mesh 'dp' axis "
                         f"({row.size})")
    if opt.trainCollection2 != "None":
        raise NotImplementedError("batched seed sweeps do not support trainCollection2 (run "
                                  "seeds as separate jobs for two-feed recipes)")
    if opt.resume:
        raise NotImplementedError("batched seed sweeps do not support --resume; rerun the "
                                  "sweep from scratch")
    if not seeds:
        raise ValueError("need at least one seed")
    opts = seed_options(dataclasses.replace(opt, rootpath=os.path.expanduser(opt.rootpath)),
                        seeds)
    per = len(seeds) // shares
    mine = opts[index * per:(index + 1) * per]
    t_prepare = time.time()
    if prepared is None:
        prepared = prepare_ranks(mine[0], world)
    device = resolve_device(opt.device) if world is None else world.device
    results = _train_seeds(opt, mine, prepared, device, time.time() - t_prepare, row=row)
    if world is None:
        return results
    for r in results:
        r["model"] = None
    gathered = world.gather_object(results)
    if gathered is None:
        return []
    if row is not None:  # each row's first rank speaks for its seeds
        gathered = gathered[::row.size]
    return [r for share in gathered for r in share]


def _train_seeds(opt: Options, opts: List[Options], prepared: Prepared, device,
                 prepare_seconds: float, row=None) -> List[Dict]:
    """The seeds of ``opts`` trained in this process, their dispatches in
    turn; with ``row``, each as one rank of a data-parallel run over it."""
    val_feeds = validation_feeds(opt, prepared)
    runs: List[TrainRun] = []
    try:
        for o in opts:
            runs.append(TrainRun(o, seed_prepared(o, prepared), device, prepare_seconds,
                                 shared=runs[0].dispatch if runs else None,
                                 val_feeds=val_feeds, mesh=row))
        for epoch in range(opt.num_epochs):
            active = [r for r in runs if not r.stopped]
            if not active:
                break
            logger.info("sweep epoch %d/%d: seeds %s", epoch, opt.num_epochs,
                        [r.opt.random_seed for r in active])
            t0 = time.time()
            for r in active:
                r.begin_epoch(epoch)
            streams = [r.epoch_stream(epoch) for r in active]
            live = list(streams)
            while live:  # each active seed's next K steps, in turn
                live = [s for s in live if s.advance()]
            done = [r.finish_stream(s) for r, s in zip(active, streams)]
            epoch_time = time.time() - t0
            for r, (loss, steps) in zip(active, done):
                r.end_epoch(epoch, loss, steps, epoch_time)
        for r in runs:
            r.saver.join()
    except BaseException:
        for r in runs:
            r.saver.join_quietly()
        raise
    finally:
        for r in runs:
            r.close()
    return [r.result() for r in runs]
