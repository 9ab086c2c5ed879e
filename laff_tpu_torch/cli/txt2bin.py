#!/usr/bin/env python3
"""Text-to-BigFile feature converter CLI (``laff_tpu.cli.txt2bin``;
reference ``txt2bin.py:78-101``). A directory among the inputs stands for
its files, in name order.

  python -m laff_tpu_torch.cli.txt2bin <feat_dim> <file or dir> [...] <result_dir>
"""

import os
import sys
from optparse import OptionParser

from laff_tpu_torch.store import txt2bin


def main(argv=None) -> int:
    parser = OptionParser(usage="usage: %prog [options] feat_dim input_text_file(s) result_dir")
    parser.add_option("--overwrite", default=0, type="int")
    options, args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if len(args) < 3:
        parser.print_help()
        return 1
    input_files = []
    for spec in args[1:-1]:
        if os.path.isdir(spec):
            input_files += [os.path.join(spec, f) for f in sorted(os.listdir(spec))]
        else:
            input_files.append(spec)
    txt2bin(int(args[0]), input_files, args[-1], overwrite=bool(options.overwrite))
    return 0


if __name__ == "__main__":
    sys.exit(main())
