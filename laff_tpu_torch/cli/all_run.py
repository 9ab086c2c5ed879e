#!/usr/bin/env python3
"""Multi-dataset AllRun sweep (``shell/all_run.py``'s surface, the
reference's ``shell/laff_AllRun.sh`` and ``shell/laffFrame_AllRun.sh``):
the benchmark's (train, val, test) collection triples, each through
``cli.retrieval_task`` with one config and parm string, their rows
appended to one result file.

  python -m laff_tpu_torch.cli.all_run                 # LAFF on all 5 datasets
  python -m laff_tpu_torch.cli.all_run --frame         # FrameLAFF on msvd + tgif
  python -m laff_tpu_torch.cli.all_run --datasets a:b:c,d:e:f --device cpu
"""

import argparse
import os
import sys

from laff_tpu_torch.cli import retrieval_task

# (train, val, test) triples, in laff_AllRun.sh:9-13's order
DATASETS = [
    ("msrvtt10ktrain", "msrvtt10kval", "msrvtt10ktest"),
    ("msvdtrain", "msvdval", "msvdtest"),
    ("msrvtt1kAtrain", "msrvtt1kAval", "msrvtt1kAtest"),
    ("tgiftrain", "tgifval", "tgiftest"),
    ("vatex_train", "vatex_val1k5", "vatex_test1k5"),
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("LAFF AllRun multi-dataset sweep (PyTorch port)")
    parser.add_argument("--rootpath", default=None)
    parser.add_argument("--frame", action="store_true",
                        help="FrameLAFF AllRun: the StrongCLIP frame config on the msvd + tgif "
                             "triples (laffFrame_AllRun.sh)")
    parser.add_argument("--config", default=None,
                        help="the config (default: laff, or "
                             "FrameLaff_NoFrameFc_StrongCLIP_adjust with --frame)")
    parser.add_argument("--parm_adjust_configs", default=None,
                        help="the parm string (default: the headline 0_12_0_12_0_0_1, or "
                             "0_7_1_12_0_12_0 with --frame)")
    parser.add_argument("--indices", default=None,
                        help="comma-separated dataset indices (default: 0-4, or 1,3 with "
                             "--frame)")
    parser.add_argument("--datasets", default=None,
                        help="train:val:test triples, comma-separated (overrides --indices)")
    parser.add_argument("--random_seeds", default="2")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_epochs", type=int, default=80)
    parser.add_argument("--overwrite", type=int, default=1)
    parser.add_argument("--model_prefix_", default="runs_")
    parser.add_argument("--result_file", default=None)
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    config = args.config or ("FrameLaff_NoFrameFc_StrongCLIP_adjust" if args.frame else "laff")
    parms = args.parm_adjust_configs or ("0_7_1_12_0_12_0" if args.frame
                                         else "0_12_0_12_0_0_1")
    result_file = args.result_file or os.path.join(
        "result_log", f"result_{args.model_prefix_}_{config}.txt")
    if args.datasets:
        triples = [tuple(t.split(":")) for t in args.datasets.split(",")]
    else:
        indices = ([int(i) for i in args.indices.split(",")] if args.indices
                   else ([1, 3] if args.frame else list(range(len(DATASETS)))))
        triples = [DATASETS[i] for i in indices]

    rc = 0
    for train, val, test in triples:
        cmd = ["--trainCollection", train, "--valCollection", val, "--testCollection", test,
               "--config", config, "--parm_adjust_configs", parms,
               "--random_seeds", args.random_seeds, "--batch_size", str(args.batch_size),
               "--num_epochs", str(args.num_epochs), "--overwrite", str(args.overwrite),
               "--model_prefix_", args.model_prefix_, "--result_file", result_file,
               "--jobs", str(args.jobs), "--device", args.device]
        if args.rootpath:
            cmd += ["--rootpath", args.rootpath]
        rc = max(rc, retrieval_task.main(cmd) or 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
