#!/usr/bin/env python3
"""Collection layout checker CLI (``laff_tpu.cli.check_data``; reference
``data/check_data.py``). Exits 1 when anything is missing or broken.

  python -m laff_tpu_torch.cli.check_data <collection> [...] --rootpath <root> \
      --features clip_ft,x3d
"""

import argparse
import sys

from laff_tpu_torch.data.check import check_environment
from laff_tpu_torch.utils import ROOT_PATH


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("collection layout checker")
    parser.add_argument("collections", nargs="+")
    parser.add_argument("--rootpath", default=ROOT_PATH)
    parser.add_argument("--features", default="",
                        help="comma-separated feature dir names to verify")
    args = parser.parse_args(argv)
    feats = [f for f in args.features.split(",") if f]
    return 0 if check_environment(args.rootpath, args.collections, feats) else 1


if __name__ == "__main__":
    sys.exit(main())
