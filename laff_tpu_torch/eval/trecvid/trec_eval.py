"""Submission XML -> treceval run -> xinfAP (reference
``tv_avs_eval/trec_eval.py:28-81``).

The scorer is the Python xinfAP in laff_tpu_torch.eval.trecvid.infap by default;
pass ``use_perl=True`` (with a sample_eval.pl on disk) to shell out to the
official NIST tool instead — the subprocess plumbing matches the reference.
"""

from __future__ import annotations

import os
import subprocess
import xml.etree.ElementTree as ET
from typing import Optional

from ...utils import get_logger
from .infap import format_report, parse_infap, sample_eval

logger = get_logger(__name__)

MAX_SCORE = 9999
TEAM = "RUCMM"


def xml_to_treceval(input_file: str, overwrite: bool = False) -> str:
    """'<qry> 0 <shot> <rank> <score> <team>' lines; query id is '1'+tNum
    (reference trec_eval.py:28-60)."""
    res_file = os.path.splitext(input_file)[0] + ".treceval"
    if os.path.exists(res_file) and not overwrite:
        logger.info("%s exists. skip", res_file)
        return res_file

    root = ET.parse(input_file).getroot()
    lines = []
    for topic_result in root.iter("videoAdhocSearchTopicResult"):
        qry_id = "1" + topic_result.attrib["tNum"]
        for rank, item in enumerate(list(topic_result)):
            assert rank + 1 == int(item.attrib["seqNum"])
            lines.append(
                "%s 0 %s %d %d %s"
                % (qry_id, item.attrib["shotId"], rank + 1, MAX_SCORE - rank, TEAM)
            )
    with open(res_file, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return res_file


def evaluate_xml(
    input_xml_file: str,
    qrels_file: str,
    overwrite: bool = False,
    use_perl: bool = False,
    perl_script: Optional[str] = None,
) -> float:
    """Score a submission XML against qrels; returns mean infAP and writes
    the '<xml>_perf.txt' report next to the input."""
    treceval_file = xml_to_treceval(input_xml_file, overwrite=overwrite)
    res_file = input_xml_file + "_perf.txt"

    if use_perl:
        script = perl_script or os.path.join(
            os.path.dirname(__file__), "sample_eval.pl"
        )
        report = subprocess.run(
            ["perl", script, "-q", qrels_file, treceval_file],
            capture_output=True, text=True, check=True,
        ).stdout
    else:
        results = sample_eval(qrels_file, treceval_file)
        report = format_report(results)

    with open(res_file, "w") as fh:
        fh.write(report)
    inf_ap = parse_infap(report)
    logger.info("infAP: %.4f (%s)", inf_ap, input_xml_file)
    return inf_ap
