"""Settings and a small cell for the benchmark's own tests
(``pytest portbench/tests -q``).

Tests marked ``card`` need a CUDA card and skip without one; whether
there is one is decided inside each test (``need_card``), never while a
module is imported.
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_VOCAB = 100


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _load(rel: str):
    with open(ROOT / rel) as fh:
        return json.load(fh)


def tiny_config(frames: bool = False, dtype: str = "float32") -> dict:
    """A cell configuration at a test's size: a common space of 512 (the
    CLIP rows' width, which the no-transform features tile) in 8 heads of
    64, a GRU of 16, a 100-word vocabulary that keeps every word seen; the
    video and w2v widths stay."""
    cfg = copy.deepcopy(_load("portbench/configs/" + (
        "framelaff-msrvtt.json" if frames else "laffml-msrvtt.json")))
    cfg.update(common_dim=512, vocab_words=TINY_VOCAB, vocab_threshold=1, tower_dtype=dtype)
    for f in cfg["text"]["features"]:
        if f["name"] == "rnn":
            f["dim"] = 16
        if f["name"] == "bow":
            f["dim"] = TINY_VOCAB
    cfg["text"]["gru"]["hidden"] = 16
    from portbench.reference.model import parameter_count

    from portbench.world import FILLERS

    # the GRU's vocabulary adds its 4 specials, "the" and the function words
    cfg["parameters"] = parameter_count(cfg, TINY_VOCAB, TINY_VOCAB + 5 + len(FILLERS))
    return cfg


def caption_words() -> dict:
    """The caption length distribution of the mixes."""
    return _load("portbench/traffic/train.json")["caption_words"]


def shrink_port(monkeypatch, cfg: dict) -> None:
    """The port's ``load_config`` gives the tiny configuration's widths."""
    from laff_tpu_torch.engine import prepare

    real = prepare.load_config

    def load_config(name, parm="None"):
        c = real(name, parm)
        c.vis_fc_layers = ["0", cfg["common_dim"]]
        c.txt_fc_layers = f"0-{cfg['common_dim']}"
        c.rnn_size = cfg["text"]["gru"]["hidden"]
        c.multi_head_attention = dict(c.multi_head_attention,
                                      embed_dim_qkv=cfg["common_dim"] // cfg["heads"])
        c.float16 = cfg["tower_dtype"] == "bfloat16"
        c.threshold = cfg["vocab_threshold"]
        c.eval_batch_size = 64
        return c

    monkeypatch.setattr(prepare, "load_config", load_config)


def tiny_cell(kind: str, frames: bool = False, dtype: str = "float32") -> dict:
    """A cell dict as ``harness.cell`` gives, at a test's size: 48 videos x
    10 captions, B 8 with K 8 for training."""
    bench = _load("BENCHMARK.json")
    name = {"train": "framelaff-msrvtt-train" if frames else "laffml-msrvtt-train",
            "val": "laffml-mvtest3k-val"}[kind]
    w = next(x for x in bench["workloads"] if x["name"] == name)
    traffic = _load(f"portbench/traffic/{w['traffic']}.json")
    traffic.update(videos=48, captions_per_video=10, collection="tiny")
    if kind == "train":
        traffic["batch_size"] = 8
    return {"workload": w, "config": tiny_config(frames, dtype), "traffic": traffic,
            "limits": _load(f"portbench/limits/{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])]}


@pytest.fixture
def tiny(monkeypatch):
    def make(kind: str, frames: bool = False, dtype: str = "float32") -> dict:
        c = tiny_cell(kind, frames, dtype)
        shrink_port(monkeypatch, c["config"])
        return c

    return make
