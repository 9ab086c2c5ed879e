"""Ranked score file -> NIST videoAdhocSearchResults XML (reference
``tv_avs_eval/txt2xml.py:44-118``): top-1000 shots per topic, monotone
non-increasing score check, DTD header and run attributes preserved."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from ...utils import get_logger

logger = get_logger(__name__)

XML_HEAD = (
    '<!DOCTYPE videoAdhocSearchResults SYSTEM '
    '"https://www-nlpir.nist.gov/projects/tv2018/dtds/'
    'videoAdhocSearchResults.dtd">'
)


def read_topics(topics_file: str) -> List[Tuple[str, str]]:
    out = []
    with open(topics_file) as fh:
        for line in fh:
            line = line.strip()
            if line:
                tnum, query = line.split(" ", 1)
                out.append((tnum, query))
    return out


def _wrap_topic(tnum: str, etime: float, shot_ids: Sequence[str]) -> List[str]:
    lines = [
        '<videoAdhocSearchTopicResult tNum="%s" elapsedTime="%g">' % (tnum, etime)
    ]
    for i, shot_id in enumerate(shot_ids):
        lines.append('<item seqNum="%d" shotId="%s" />' % (i + 1, shot_id))
    lines.append("</videoAdhocSearchTopicResult>")
    return lines


def scores_to_xml(
    input_txt_file: str,
    output_xml_file: Optional[str] = None,
    topics_file: Optional[str] = None,
    shots_file: Optional[str] = None,
    topk: int = 1000,
    trtype: str = "D",
    pclass: str = "F",
    pid: str = "RUCMM",
    priority: int = 1,
    desc: str = "place holder",
    etime: float = 25.0,
    overwrite: bool = False,
) -> str:
    """Convert an ``id.sent.score.txt`` ranking into submission XML."""
    output_xml_file = output_xml_file or input_txt_file + ".xml"
    if os.path.exists(output_xml_file) and not overwrite:
        logger.info("%s exists. skip", output_xml_file)
        return output_xml_file

    tnum_set = None
    if topics_file:
        tnum_set = {t for t, _ in read_topics(topics_file)}
    shot_set = None
    if shots_file:
        with open(shots_file) as fh:
            shot_set = {l.strip() for l in fh if l.strip()}

    with open(input_txt_file) as fh:
        data = [l.strip() for l in fh if l.strip()]
    if tnum_set is not None and len(data) != len(tnum_set):
        raise ValueError(
            f"number of topics does not match: {len(data)} rankings vs "
            f"{len(tnum_set)} topics"
        )

    xml_content: List[str] = []
    for line in data:
        elems = line.split()
        tnum, elems = elems[0], elems[1:]
        k = topk if len(elems) >= 2 * topk else len(elems) // 2
        prev_score = 1e8
        shot_ids = []
        for i in range(0, 2 * k, 2):
            shot_id, score = elems[i], float(elems[i + 1])
            if shot_set is not None and shot_id not in shot_set:
                raise ValueError(f"invalid shot id: {shot_id}")
            if not score < prev_score + 1e-8:
                continue  # unsorted entries skipped (reference behavior)
            prev_score = score
            shot_ids.append(shot_id)
        xml_content += _wrap_topic(tnum, etime, shot_ids)
        xml_content.append("")

    lines = [XML_HEAD, "", "<videoAdhocSearchResults>"]
    lines.append(
        '<videoAdhocSearchRunResult trType="%s" class="%s" pid="%s" '
        'priority="%s" desc="%s">' % (trtype, pclass, pid, priority, desc)
    )
    lines += xml_content
    lines += ["", "</videoAdhocSearchRunResult>", "</videoAdhocSearchResults>"]

    parent = os.path.dirname(output_xml_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(output_xml_file, "w") as fh:
        fh.write("\n".join(lines))
    logger.info("%s -> %s", input_txt_file, output_xml_file)
    return output_xml_file
