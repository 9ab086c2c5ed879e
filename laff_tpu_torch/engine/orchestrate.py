"""Experiment orchestration: seed x parm sweeps of train -> predict ->
(AVS: xml -> infAP) (``laff_tpu.engine.orchestrate``; the reference's
``shell/retrieval_task.sh`` and ``shell/avs_task.sh``).

``retrieval_task`` trains each (seed, parm) combination that has no
``model_best.pth.tar`` yet (or every one with ``overwrite``), then
benchmark-predicts each requested checkpoint. With ``batch_seeds`` and two
or more pending seeds of a parm, those seeds train first in one process
through ``engine.sweep.sweep_main``, and the loop goes straight to their
prediction. ``avs_task`` runs ``retrieval_task`` on the AVS query sets,
then turns each score file into a TRECVID submission and scores its
edition's qrels (``eval/trecvid``).

The model directories, the ``sim_name`` layout, the result file's rows and
the result dict's keys (``train``, ``predict``, ``predict_all``, and for
AVS ``infAP`` and ``infAP_all``) are ``laff_tpu``'s. ``device`` and
``rank_path`` pass to every training and prediction run; the runs are on
the card unless ``device`` is 'cpu'.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..utils import get_logger
from .prepare import Options, model_dir_for

logger = get_logger(__name__)


@dataclasses.dataclass
class SweepOptions:
    trainCollection: str
    valCollection: str
    testCollection: str
    rootpath: str
    config_name: str
    parm_adjust_configs: List[str]
    random_seeds: List[int]
    val_set: str = "no"
    batch_size: int = 128
    num_epochs: int = 80
    overwrite: int = 0
    model_prefix_base: str = "runs_"
    result_file: str = "result_log/result_test.txt"
    trainCollection2: str = "None"
    save_mean_last: int = 0
    pretrained_file_path: str = "None"
    task3_caption: str = "no_task3_caption"
    # AVS mode (avs_task.sh): score query sets + TRECVID editions
    avs_query_sets: Optional[str] = None  # e.g. 'tv16.avs.txt,tv17.avs.txt'
    avs_editions: Optional[List[str]] = None  # e.g. ['tv16', 'tv17']
    checkpoints: List[str] = dataclasses.field(
        default_factory=lambda: ["model_best.pth.tar"]
    )
    # train the pending seeds of a parm config in one process (engine/sweep.py)
    batch_seeds: bool = False
    device: str = "cuda"
    rank_path: str = "auto"


def _train_options(sweep: SweepOptions, parm: str, prefix: str, **kw) -> Options:
    return Options(trainCollection=sweep.trainCollection, valCollection=sweep.valCollection,
                   rootpath=sweep.rootpath, val_set=sweep.val_set,
                   config_name=sweep.config_name, parm_adjust_config=parm,
                   batch_size=sweep.batch_size, num_epochs=sweep.num_epochs,
                   model_prefix=prefix, overwrite=sweep.overwrite,
                   save_mean_last=sweep.save_mean_last,
                   pretrained_file_path=sweep.pretrained_file_path,
                   task3_caption=sweep.task3_caption, device=sweep.device,
                   rank_path=sweep.rank_path, **kw)


def _sweep_pretrain(sweep: SweepOptions) -> set:
    """``batch_seeds``: each parm's pending seeds (no model_best, or all with
    ``overwrite``) trained in one sweep when there are two or more; the
    (seed, parm) pairs it trained."""
    from .sweep import sweep_main

    trained = set()
    for parm in sweep.parm_adjust_configs:
        pending = []
        for seed in sweep.random_seeds:
            probe = _train_options(sweep, parm, f"{sweep.model_prefix_base}{parm}_seed_{seed}")
            if sweep.overwrite or not os.path.exists(
                    os.path.join(model_dir_for(probe), "model_best.pth.tar")):
                pending.append(seed)
        if len(pending) < 2:
            continue  # a single pending seed trains in the per-seed loop
        logger.info("batched seed sweep: parm=%s seeds=%s", parm, pending)
        sweep_main(_train_options(sweep, parm, f"{sweep.model_prefix_base}{parm}"), pending)
        trained.update((s, parm) for s in pending)
    return trained


def _sim_name(sweep: SweepOptions) -> str:
    train_tag = sweep.trainCollection
    if sweep.trainCollection2 != "None":
        train_tag += "_" + sweep.trainCollection2
    parts = [train_tag, sweep.valCollection]
    if sweep.val_set != "no":
        parts.append(sweep.val_set)
    parts.append(sweep.config_name)
    return os.path.join(*parts)


def retrieval_task(sweep: SweepOptions) -> Dict[str, Dict]:
    """Train + benchmark-predict over the sweep grid
    (``shell/retrieval_task.sh:118-197``). Returns {prefix: {train,
    predict (model_best's, else the first checkpoint's), predict_all}}."""
    from . import trainer
    from .predictor import PredictOptions, main as predict_main

    sweep_trained = set()  # (seed, parm) pairs the sweep trained
    if (sweep.batch_seeds and len(sweep.random_seeds) > 1
            and sweep.trainCollection2 == "None"):
        sweep_trained = _sweep_pretrain(sweep)
    elif sweep.batch_seeds:
        logger.info("batch_seeds requested but not applicable (single seed or "
                    "trainCollection2); using per-seed jobs")

    sim_name = _sim_name(sweep)
    results: Dict[str, Dict] = {}
    for seed in sweep.random_seeds:
        for parm in sweep.parm_adjust_configs:
            prefix = f"{sweep.model_prefix_base}{parm}_seed_{seed}"
            opt = _train_options(sweep, parm, prefix, random_seed=seed,
                                 trainCollection2=sweep.trainCollection2)
            model_dir = model_dir_for(opt)
            best_ckpt = os.path.join(model_dir, "model_best.pth.tar")
            if (seed, parm) in sweep_trained:
                # trained by the sweep in this call: never again, even with overwrite
                train_result = {"model_path": model_dir, "skipped": True, "batched": True}
            elif os.path.exists(best_ckpt) and not sweep.overwrite:
                logger.info("%s exists; skipping training", best_ckpt)
                train_result = {"model_path": model_dir, "skipped": True}
            else:
                train_result = trainer.main(opt)

            # every requested checkpoint (reference avs_task.sh loops
            # model_best and mean_last10, avs_task.sh:169-259)
            preds = {}
            for ckpt_name in sweep.checkpoints:
                ckpt_path = os.path.join(model_dir, ckpt_name)
                if not os.path.exists(ckpt_path):
                    logger.info("checkpoint %s absent; skipping", ckpt_path)
                    continue
                tag = ckpt_name.replace(".pth.tar", "")
                popt = PredictOptions(
                    testCollection=sweep.testCollection, model_path=ckpt_path,
                    sim_name=(os.path.join(sim_name, tag) if len(sweep.checkpoints) > 1
                              else sim_name),
                    rootpath=sweep.rootpath, overwrite=1,
                    query_sets=sweep.avs_query_sets or f"{sweep.testCollection}.caption.txt",
                    predict_result_file=sweep.result_file,
                    batch_size=max(sweep.batch_size, 256), device=sweep.device,
                    rank_path=sweep.rank_path)
                preds[tag] = predict_main(popt)
            pred = preds.get("model_best", next(iter(preds.values())) if preds else {})
            results[prefix] = {"train": train_result, "predict": pred, "predict_all": preds}
    return results


def avs_task(sweep: SweepOptions) -> Dict[str, Dict]:
    """Train + AVS-score + TRECVID infAP over editions and checkpoints
    (``shell/avs_task.sh:169-259``): ``retrieval_task``'s result with, per
    prefix, ``infAP_all`` {checkpoint tag: {edition: infAP}} and ``infAP``
    (model_best's, else the first checkpoint's)."""
    from ..eval.trecvid import evaluate_xml, scores_to_xml

    results = retrieval_task(sweep)
    if not sweep.avs_editions:
        return results
    tdir = os.path.join(sweep.rootpath, sweep.testCollection, "TextData")
    shots = os.path.join(sweep.rootpath, sweep.testCollection, "VideoSets",
                         f"{sweep.testCollection}.txt")
    for prefix, res in results.items():
        res["infAP_all"] = {}
        for tag, pred_set in res.get("predict_all", {}).items():
            per_edition = res["infAP_all"].setdefault(tag, {})
            for query_set, pred in pred_set.items():
                score_file = pred.get("score_file")
                if not score_file:
                    continue
                edition = query_set.split(".")[0]  # 'tv16.avs.txt' -> 'tv16'
                if edition not in sweep.avs_editions:
                    continue
                topics = os.path.join(tdir, query_set)
                xml = scores_to_xml(score_file,
                                    topics_file=topics if os.path.exists(topics) else None,
                                    shots_file=shots if os.path.exists(shots) else None,
                                    overwrite=True)
                qrels = os.path.join(tdir, f"avs.qrels.{edition}")
                if os.path.exists(qrels):
                    per_edition[edition] = evaluate_xml(xml, qrels, overwrite=True)
                    logger.info("%s %s %s infAP=%.4f", prefix, tag, edition,
                                per_edition[edition])
        res["infAP"] = res["infAP_all"].get(
            "model_best", next(iter(res["infAP_all"].values())) if res["infAP_all"] else {})
    return results
