#!/usr/bin/env python3
"""Prediction CLI for benchmark collections; the argument surface follows
``laff_tpu.cli.do_predictor`` where the port implements the option.

  python -m laff_tpu_torch.cli.do_predictor <testCollection> <checkpoint> \
      <sim_name> --rootpath <root> --query_sets <capfile> [--rank_path kernel]
"""

import argparse
import sys

from laff_tpu_torch.engine.evaluator import RANK_PATHS
from laff_tpu_torch.engine.predictor import PredictOptions, main as predict_main
from laff_tpu_torch.utils import ROOT_PATH


def parse_args(argv=None) -> PredictOptions:
    parser = argparse.ArgumentParser("LAFF predictor (PyTorch/CUDA port)")
    parser.add_argument("testCollection", type=str)
    parser.add_argument("model_path", type=str,
                        help="port checkpoint, or reference .pth.tar, to load")
    parser.add_argument("sim_name", type=str,
                        help="sub-folder where the rank dump is saved")
    parser.add_argument("--rootpath", type=str, default=ROOT_PATH)
    parser.add_argument("--overwrite", type=int, default=0, choices=[0, 1])
    parser.add_argument("--query_sets", type=str, default="tv16.avs.txt")
    parser.add_argument("--predict_result_file", type=str,
                        default="result_log/result_test.txt")
    parser.add_argument("--batch_size", default=1024, type=int)
    parser.add_argument("--num_workers", default=0, type=int,
                        help="prefetch depth of the host featurizer (batches in flight)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--rank_path", default="auto", choices=list(RANK_PATHS),
                        help="t2v rank path; 'kernel' forces the fused CUDA rank kernel")
    return PredictOptions(**vars(parser.parse_args(argv)))


def main(argv=None) -> int:
    predict_main(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
