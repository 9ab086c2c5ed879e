#!/usr/bin/env python3
"""Score an AVS run: the predictor's score file -> NIST submission XML ->
infAP (the port's counterpart of ``tv_avs_eval/do_eval.py`` with its
``txt2xml`` and ``trec_eval`` steps).

  python -m laff_tpu_torch.cli.avs_eval <testCollection> <edition> <sim_name> \
      [--rootpath R] [--overwrite 0] [--use_perl 0]

Reads ``<root>/<collection>/SimilarityIndex/<edition>.avs.txt/<sim_name>/
id.sent.score.txt``, checks its topics against
``<collection>/TextData/<edition>.avs.txt`` and its shots against
``<collection>/VideoSets/<collection>.txt`` (each when present), writes the
XML beside it (priority 1, etime 1.0), scores it against
``<collection>/TextData/avs.qrels.<edition>`` with the Python xinfAP scorer
(or, with ``--use_perl 1``, the vendored NIST ``sample_eval.pl``), and
prints ``<edition> infAP <value>``.
"""

import argparse
import os
import sys

from laff_tpu_torch.eval.trecvid import evaluate_xml, scores_to_xml
from laff_tpu_torch.utils import ROOT_PATH

DESC = "This run uses the top secret x-component"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("AVS score file -> XML -> infAP (PyTorch/CUDA port)")
    parser.add_argument("testCollection")
    parser.add_argument("topic_set", help="TRECVID edition, e.g. tv18")
    parser.add_argument("sim_name", help="run directory under SimilarityIndex/<topic_set>.avs.txt/")
    parser.add_argument("--rootpath", default=ROOT_PATH)
    parser.add_argument("--overwrite", type=int, default=0)
    parser.add_argument("--use_perl", type=int, default=0)
    args = parser.parse_args(argv)

    coll_dir = os.path.join(os.path.expanduser(args.rootpath), args.testCollection)
    score_file = os.path.join(coll_dir, "SimilarityIndex", f"{args.topic_set}.avs.txt",
                              args.sim_name, "id.sent.score.txt")
    print(score_file)
    if not os.path.exists(score_file):
        print(f"score file not found: {score_file}", file=sys.stderr)
        return 1
    topics_file = os.path.join(coll_dir, "TextData", f"{args.topic_set}.avs.txt")
    shots_file = os.path.join(coll_dir, "VideoSets", f"{args.testCollection}.txt")
    xml = scores_to_xml(
        score_file,
        topics_file=topics_file if os.path.exists(topics_file) else None,
        shots_file=shots_file if os.path.exists(shots_file) else None,
        priority=1, desc=DESC, etime=1.0, overwrite=bool(args.overwrite))
    inf_ap = evaluate_xml(xml, os.path.join(coll_dir, "TextData", f"avs.qrels.{args.topic_set}"),
                          overwrite=bool(args.overwrite), use_perl=bool(args.use_perl))
    print(f"{args.topic_set} infAP {inf_ap}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
