"""The TRECVID AVS harness (a copy of ``laff_tpu.eval.trecvid``, which holds no
JAX): score file -> NIST submission XML -> treceval run -> xinfAP, by the
Python scorer or the vendored NIST ``sample_eval.pl``."""

from .infap import sample_eval, parse_infap
from .txt2xml import scores_to_xml
from .trec_eval import evaluate_xml, xml_to_treceval

__all__ = [
    "sample_eval",
    "parse_infap",
    "scores_to_xml",
    "evaluate_xml",
    "xml_to_treceval",
]
