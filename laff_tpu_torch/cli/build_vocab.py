#!/usr/bin/env python3
"""Vocabulary builder CLI (``laff_tpu.cli.build_vocab``; reference
``build_vocab.py:103-134``): writes ``<encoding>_<threshold>.pkl`` and its
word counts ``<encoding>_<threshold>.txt`` under
``<root>/<collection>/TextData/<folder_name>/``.

  python -m laff_tpu_torch.cli.build_vocab <collection> --rootpath <root> \
      --caption_name <collection>.caption.txt --encoding bow --threshold 5
"""

import os
import sys
from optparse import OptionParser

from laff_tpu_torch.text.vocab import build_vocab, save_vocab
from laff_tpu_torch.utils import ROOT_PATH, check_to_skip, get_logger

logger = get_logger(__name__)

TEXT_ENCODINGS = ["bow", "bow_nsw", "gru"]


def process(options, collection: str) -> int:
    vocab_file = os.path.join(options.rootpath, collection, "TextData", options.folder_name,
                              f"{options.encoding}_{options.threshold}.pkl")
    count_file = os.path.join(os.path.dirname(vocab_file),
                              f"{options.encoding}_{options.threshold}.txt")
    if check_to_skip(vocab_file, options.overwrite):
        return 0
    cap_file = os.path.join(options.rootpath, collection, "TextData", options.caption_name)
    vocab, word_counts = build_vocab(cap_file, options.encoding, threshold=options.threshold,
                                     lang=options.language)
    save_vocab(vocab, vocab_file)
    with open(count_file, "w") as fh:
        fh.write("\n".join("%s %d" % x for x in word_counts))
    logger.info("saved word-counts to %s", count_file)
    return 0


def main(argv=None) -> int:
    parser = OptionParser(usage="usage: %prog [options] collection")
    parser.add_option("--overwrite", default=0, type="int")
    parser.add_option("--rootpath", default=ROOT_PATH, type="string")
    parser.add_option("--caption_name", default="train_collection.caption.txt", type="string")
    parser.add_option("--language", default="en", type="choice", choices=["en", "zh"])
    parser.add_option("--encoding", default="bow", type="choice", choices=TEXT_ENCODINGS)
    parser.add_option("--threshold", default=5, type="int")
    parser.add_option("--folder_name", default="vocab", type="string")
    options, args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if len(args) < 1:
        parser.print_help()
        return 1
    return process(options, args[0])


if __name__ == "__main__":
    sys.exit(main())
