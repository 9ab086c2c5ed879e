#!/usr/bin/env python3
"""Prediction CLI for benchmark and AVS collections; the argument surface
is ``laff_tpu.cli.do_predictor``'s (``--data_parallel N`` over two or more
visible cards predicts on min(N, cards) ranks, one process a card, each
embedding its rows of every batch; over fewer it logs ``laff_tpu``'s
warning and predicts on the one device). ``--int8_gallery 1`` holds an AVS
gallery above ``LARGE_GALLERY`` as int8 rows on the device: candidates are
nominated on the int8 product and embedded again for exact scores.

  python -m laff_tpu_torch.cli.do_predictor <testCollection> <checkpoint> \
      <sim_name> --rootpath <root> --query_sets <capfile>[,<capfile>...] \
      [--rank_path kernel] [--task3_caption negation] \
      [--rerank kreciprocal|tkb|concept] [--each_head 1] [--int8_gallery 1]
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
    parser.add_argument("--adjust_weight_predict", type=int, default=0, choices=[0, 1],
                        help="accepted for parity; the reference parses it and never reads it")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="sharded inference over min(N, visible cards) ranks; with fewer "
                             "than two cards visible, a warning and the one device")
    parser.add_argument("--int8_gallery", type=int, default=0, choices=[0, 1],
                        help="an AVS gallery above LARGE_GALLERY held on the device as int8 "
                             "rows: int8 nomination, exact rescoring of the candidates")
    parser.add_argument("--task3_caption", type=str, default="no_task3_caption",
                        help="any other value enables boolean negation scoring of the queries")
    parser.add_argument("--neg_method", type=str, default="sub", choices=["sub", "mul"],
                        help="negation score adjustment method")
    parser.add_argument("--each_head", type=int, default=0, choices=[0, 1],
                        help="also write per-head metrics, score files and perf.txt")
    parser.add_argument("--rerank", type=str, default="none",
                        choices=["none", "kreciprocal", "tkb", "concept"],
                        help="post-processing re-ranking of the score matrix")
    parser.add_argument("--concept_pkl", type=str, default="",
                        help="video <-> concept similarity pkl (rerank=concept)")
    parser.add_argument("--concept_weight", type=float, default=2.0)
    parser.add_argument("--concept_topk", type=int, default=1000)
    parser.add_argument("--concept_bow_counts", type=str, default="",
                        help="vocabulary count file ('word count' per line) for the idf")
    parser.add_argument("--concept_caption", type=str, default="",
                        help="caption file for the idf's substring-count fallback")
    return PredictOptions(**vars(parser.parse_args(argv)))


def main(argv=None) -> int:
    predict_main(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
