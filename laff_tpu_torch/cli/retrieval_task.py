#!/usr/bin/env python3
"""Sweep CLI: train + predict over seeds x parm_adjust_configs
(``shell/retrieval_task.py``'s surface, the reference's
``shell/retrieval_task.sh``), through ``engine.orchestrate``; AVS mode
(``--avs_query_sets``) adds the TRECVID infAP of each edition.

  python -m laff_tpu_torch.cli.retrieval_task \
      --trainCollection msrvtt10ktrain --valCollection msrvtt10kval \
      --testCollection msrvtt10ktest --config laff \
      --parm_adjust_configs 0_12_0_12_0_0_1 --random_seeds 2 [--device cpu]

``--jobs N`` runs up to N (seed, parm) combinations at once, each in a
subprocess of its own; ``--batch_seeds 1`` trains a parm's seeds in one
process (``engine.sweep``). The two exclude each other.
"""

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from laff_tpu_torch.engine.evaluator import RANK_PATHS
from laff_tpu_torch.engine.orchestrate import SweepOptions, avs_task, retrieval_task
from laff_tpu_torch.utils import ROOT_PATH

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser("LAFF seed and parm sweep (PyTorch port)")
    parser.add_argument("--rootpath", default=ROOT_PATH)
    parser.add_argument("--trainCollection", required=True)
    parser.add_argument("--valCollection", required=True)
    parser.add_argument("--testCollection", required=True)
    parser.add_argument("--val_set", default="no")
    parser.add_argument("--config", required=True)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_epochs", type=int, default=80)
    parser.add_argument("--overwrite", type=int, default=0)
    parser.add_argument("--random_seeds", default="2", help="space- or comma-separated")
    parser.add_argument("--parm_adjust_configs", default="None",
                        help="space- or comma-separated sweep strings")
    parser.add_argument("--model_prefix_", default="runs_")
    parser.add_argument("--result_file", default="result_log/result_test.txt")
    parser.add_argument("--trainCollection2", default="None")
    parser.add_argument("--save_mean_last", type=int, default=0)
    parser.add_argument("--pretrained_file_path", default="None")
    parser.add_argument("--task3_caption", default="no_task3_caption")
    parser.add_argument("--avs_query_sets", default=None,
                        help="e.g. tv16.avs.txt,tv17.avs.txt (enables AVS mode)")
    parser.add_argument("--avs_editions", default=None, help="e.g. tv16,tv17")
    parser.add_argument("--jobs", type=int, default=1,
                        help="run up to N (seed x parm) combinations as parallel "
                             "subprocesses (the reference's PID queue over devices, "
                             "retrieval_task.sh:17-45); jobs on one card share its memory")
    parser.add_argument("--batch_seeds", type=int, default=0,
                        help="train all seeds of each parm config in one process "
                             "(engine/sweep.py); excludes --jobs > 1")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--rank_path", default="auto", choices=list(RANK_PATHS))
    args = parser.parse_args(argv)
    if args.batch_seeds and args.jobs > 1:
        parser.error("--batch_seeds trains the seeds in one process; --jobs spreads them "
                     "over processes: pick one")
    return args


def split(s):
    return [x for x in s.replace(",", " ").split() if x]


def strip_option(argv, name):
    out, skip = [], False
    for x in argv:
        if skip:
            skip = False
        elif x == name:
            skip = True
        else:
            out.append(x)
    return out


def run_jobs(argv, seeds, parms, jobs: int) -> int:
    """Each (seed, parm) combination in a subprocess of its own, ``jobs`` at
    a time; the highest exit code."""
    base = list(argv)
    for name in ("--jobs", "--random_seeds", "--parm_adjust_configs"):
        base = strip_option(base, name)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))

    def run_one(combo):
        seed, parm = combo
        cmd = [sys.executable, "-m", "laff_tpu_torch.cli.retrieval_task", *base,
               "--jobs", "1", "--random_seeds", seed, "--parm_adjust_configs", parm]
        return subprocess.run(cmd, env=env).returncode

    combos = [(s, p) for s in seeds for p in parms]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        rcs = list(pool.map(run_one, combos))
    return max(rcs) if rcs else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    seeds, parms = split(args.random_seeds), split(args.parm_adjust_configs)
    if args.jobs > 1 and len(seeds) * len(parms) > 1:
        return run_jobs(argv, seeds, parms, args.jobs)
    sweep = SweepOptions(
        trainCollection=args.trainCollection, valCollection=args.valCollection,
        testCollection=args.testCollection, rootpath=os.path.expanduser(args.rootpath),
        config_name=args.config, parm_adjust_configs=parms,
        random_seeds=[int(s) for s in seeds], val_set=args.val_set,
        batch_size=args.batch_size, num_epochs=args.num_epochs, overwrite=args.overwrite,
        model_prefix_base=args.model_prefix_, result_file=args.result_file,
        trainCollection2=args.trainCollection2, save_mean_last=args.save_mean_last,
        pretrained_file_path=args.pretrained_file_path, task3_caption=args.task3_caption,
        avs_query_sets=args.avs_query_sets,
        avs_editions=split(args.avs_editions) if args.avs_editions else None,
        batch_seeds=bool(args.batch_seeds), device=args.device, rank_path=args.rank_path)
    if sweep.avs_query_sets:
        avs_task(sweep)
    else:
        retrieval_task(sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
