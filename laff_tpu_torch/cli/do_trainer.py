#!/usr/bin/env python3
"""Training CLI; the argument surface and defaults follow
``laff_tpu.cli.do_trainer`` for the options the port implements (the
others raise, naming the ROADMAP item that brings them).

  python -m laff_tpu_torch.cli.do_trainer <trainCollection> <valCollection> \
      --rootpath <root> --config_name rehearsal [--device cpu] [--rank_path kernel]

At the defaults the train features live on the card when they fit
``LAFF_TPU_CACHE_BUDGET`` (4 GiB), K = 8 steps go per dispatch as a CUDA
graph, and validation batches are staged on the card. An End2EndClip
config (``model_name = 'End2EndClip'``, e.g. ``--config_name end2end_clip``)
trains on raw frames through ``engine.end2end.main``, as ``laff_tpu``'s CLI
dispatches it. ``--data_parallel N`` over several visible cards trains on
min(N, cards) ranks, one process a card (``trainer.main``).
"""

import argparse
import os
import sys

from laff_tpu_torch.engine import end2end
from laff_tpu_torch.engine.evaluator import RANK_PATHS
from laff_tpu_torch.engine.prepare import Options, check_data_parallel, load_config, model_dir_for
from laff_tpu_torch.engine.trainer import main as train_main
from laff_tpu_torch.utils import ROOT_PATH, check_to_skip


def parse_args(argv=None) -> Options:
    parser = argparse.ArgumentParser("LAFF trainer (PyTorch/CUDA port)")
    parser.add_argument("trainCollection", type=str, help="train collection")
    parser.add_argument("valCollection", type=str, help="validation collection")
    parser.add_argument("--rootpath", type=str, default=ROOT_PATH)
    parser.add_argument("--trainCollection2", type=str, default="None")
    parser.add_argument("--task2_caption", type=str, default="no_task2_caption",
                        help="object-caption file suffix of the task2 concept labels")
    parser.add_argument("--task2_intended", default=0, type=int, choices=[0, 1],
                        help="opt-in concept-space task2 loss (the reference's task2 is "
                             "dead code; 0 keeps --task2_caption inert)")
    parser.add_argument("--task3_caption", type=str, default="no_task3_caption",
                        help="false-caption file suffix of the task3 negation loss")
    parser.add_argument("--train_strategy", type=str, default="usual")
    parser.add_argument("--overwrite", type=int, default=0, choices=[0, 1])
    parser.add_argument("--val_set", type=str, default="setA")
    parser.add_argument("--metric", type=str, default="mir",
                        choices=["r1", "r5", "r10", "medr", "meanr", "mir"])
    parser.add_argument("--num_epochs", default=80, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--workers", default=2, type=int,
                        help="feed prefetch depth (batches kept in flight)")
    parser.add_argument("--model_prefix", default="runs_0", type=str)
    parser.add_argument("--config_name", type=str, default="laff")
    parser.add_argument("--parm_adjust_config", type=str, default="None")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--rank_path", default="auto", choices=list(RANK_PATHS),
                        help="validation rank path; 'kernel' forces the fused CUDA rank kernel")
    parser.add_argument("--sync_debug", default=0, type=int, choices=[0, 1],
                        help="run the steps between two loss reads under "
                             "torch.cuda.set_sync_debug_mode('error')")
    parser.add_argument("--random_seed", default=2, type=int)
    parser.add_argument("--local_rank", default=0, type=int)
    parser.add_argument("--pretrained_file_path", default="None", type=str,
                        help="port checkpoint to warm-start from")
    parser.add_argument("--save_mean_last", default=0, type=int, choices=[0, 1])
    parser.add_argument("--resume", default=0, type=int, choices=[0, 1],
                        help="resume a run (optimizer, LR controller, counters) from "
                             "model_resume.pth.tar")
    parser.add_argument("--early_stop_patience", default=10, type=int)
    parser.add_argument("--steps_per_dispatch", default=-1, type=int,
                        help="K train steps per dispatch, on the card one CUDA graph "
                             "replayed K times; -1 auto (8 once both caches are on)")
    parser.add_argument("--device_feature_cache", default=-1, type=int, choices=[-1, 0, 1],
                        help="keep the train video features on the card; batches carry "
                             "row indices (-1 auto: within LAFF_TPU_CACHE_BUDGET)")
    parser.add_argument("--device_text_cache", default=-1, type=int, choices=[-1, 0, 1],
                        help="keep the caption encodings on the card too (-1 auto: with "
                             "the feature cache, within the budget)")
    parser.add_argument("--device_text_featurize", default=0, type=int, choices=[0, 1],
                        help="ship bow as sparse (ids, counts) and w2v as row ids; "
                             "densify and mean-pool on the card")
    parser.add_argument("--stage_val_features", default=1, type=int, choices=[0, 1],
                        help="keep the validation batches on the card after the first "
                             "pass and replay them (LAFF_TPU_EVAL_STAGE_BUDGET)")
    parser.add_argument("--data_parallel", default=0, type=int,
                        help="train data-parallel over min(N, visible cards) ranks, one process "
                             "a card; with fewer than two cards, a warning and the one device")
    return Options(**vars(parser.parse_args(argv)))


def main(argv=None) -> int:
    opt = parse_args(argv)
    if check_to_skip(os.path.join(model_dir_for(opt), "model_best.pth.tar"), opt.overwrite):
        return 0
    if getattr(load_config(opt.config_name), "model_name", "") == "End2EndClip":
        if check_data_parallel(opt.data_parallel, opt.device) > 1:
            # laff_tpu's CLI trains End2EndClip on one device whatever it asks
            raise ValueError("End2EndClip trains on one device; --data_parallel over several "
                             "cards is taken by the LAFF trainer only")
        end2end.main(opt)
    else:
        train_main(opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
