#!/usr/bin/env python3
"""Two-stage AVS recipe with the port (the counterpart of
``shell/do_pretrain_gcc_train_avs.py``, the reference's
``shell/do_pretrain_gcc_train_avs.sh``): a GCC caption pretrain, then a
fine-tune on tgif-msrvtt10k from the pretrained checkpoint, then the AVS
collections scored.

  python -m laff_tpu_torch.cli.do_pretrain_gcc_train_avs --rootpath ~/VisualSearch \
      --config laff --parm 0_12_0_12_0_0_1 --testCollection iacc.3 \
      --avs_query_sets tv16.avs.txt,tv17.avs.txt,tv18.avs.txt \
      --avs_editions tv16,tv17,tv18 [--device cpu]

Stage 1 (``trainer.main``, ``train_strategy='subset'`` under
``--only_train 1``) is skipped when its ``model_best.pth.tar`` exists;
stage 2 is ``engine.orchestrate.avs_task`` with that checkpoint as
``pretrained_file_path``. ``run(argv)`` returns what the stages did:
{'pretrain_ckpt', 'pretrained' (whether stage 1 ran), 'avs' (avs_task's
result)}.
"""

import argparse
import os
import sys
from typing import Dict

from laff_tpu_torch.engine import orchestrate, trainer
from laff_tpu_torch.engine.prepare import Options, model_dir_for
from laff_tpu_torch.utils import ROOT_PATH, get_logger

logger = get_logger(__name__)


def run(argv=None) -> Dict:
    parser = argparse.ArgumentParser("GCC pretrain -> AVS fine-tune (PyTorch port)")
    parser.add_argument("--rootpath", default=ROOT_PATH)
    parser.add_argument("--pretrainCollection", default="gcc11train")
    parser.add_argument("--pretrainVal", default="gcc11val",
                        help="ignored when --only_train 1")
    parser.add_argument("--only_train", type=int, default=1,
                        help="pretrain without a val collection: split the train pairs "
                             "98.5/1.5 and validate on the holdout (reference --only_train / "
                             "train_strategy=subset)")
    parser.add_argument("--trainCollection", default="tgif-msrvtt10k")
    parser.add_argument("--valCollection", default="tv2016train")
    parser.add_argument("--val_set", default="setA")
    parser.add_argument("--testCollection", default="iacc.3")
    parser.add_argument("--config", default="laff")
    parser.add_argument("--parm", default="None")
    parser.add_argument("--seed", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--pretrain_epochs", type=int, default=80)
    parser.add_argument("--num_epochs", type=int, default=80)
    parser.add_argument("--avs_query_sets", default="tv16.avs.txt")
    parser.add_argument("--avs_editions", default="tv16")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    rootpath = os.path.expanduser(args.rootpath)

    pre_opt = Options(
        trainCollection=args.pretrainCollection, valCollection=args.pretrainVal,
        rootpath=rootpath, val_set="no", config_name=args.config,
        parm_adjust_config=args.parm, random_seed=args.seed, batch_size=args.batch_size,
        num_epochs=args.pretrain_epochs,
        model_prefix=f"gcc_pretrain_{args.parm}_seed_{args.seed}",
        train_strategy="subset" if args.only_train else "usual", device=args.device)
    pretrain_ckpt = os.path.join(model_dir_for(pre_opt), "model_best.pth.tar")
    pretrained = not os.path.exists(pretrain_ckpt)
    if pretrained:
        logger.info("stage 1: GCC pretrain -> %s", pretrain_ckpt)
        trainer.main(pre_opt)
    else:
        logger.info("stage 1 checkpoint exists: %s", pretrain_ckpt)

    sweep = orchestrate.SweepOptions(
        trainCollection=args.trainCollection, valCollection=args.valCollection,
        testCollection=args.testCollection, rootpath=rootpath, config_name=args.config,
        parm_adjust_configs=[args.parm], random_seeds=[args.seed], val_set=args.val_set,
        batch_size=args.batch_size, num_epochs=args.num_epochs, model_prefix_base="gccft_",
        pretrained_file_path=pretrain_ckpt, avs_query_sets=args.avs_query_sets,
        avs_editions=[e for e in args.avs_editions.split(",") if e], device=args.device)
    return {"pretrain_ckpt": pretrain_ckpt, "pretrained": pretrained,
            "avs": orchestrate.avs_task(sweep)}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
