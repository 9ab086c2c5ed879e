"""The port's spans (``laff_tpu_torch.utils.trace``) on the CPU.

* with no profiler running, ``span`` is one shared null context and makes
  no profiler call; the private torch names it uses exist; under a
  profiler it is a function-scope range named ``laff.<name>``, not a user
  annotation;
* one ``EpochStream`` epoch: a ``train.dispatch`` per dispatch, each
  holding one ``train.feed_wait`` and one ``train.enqueue``, their ids in
  order, and ``finish``'s ``train.loss_read``;
* one ``validate``: ``eval.validate`` holding ``embed_vis``, ``embed_txt``,
  ``ranks`` (with ``gt_index`` and ``readback``) and ``metrics``, each once,
  all with the pass's id;
* ``LAFF_TPU_PROFILE``: a two-epoch ``main`` writes one Chrome trace, which
  holds the dispatch spans.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import EvalFeed, TextSource
from laff_tpu_torch.data.synth import build_collection, build_w2v
from laff_tpu_torch.engine import evaluator as port_evaluator
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.store import write_bigfile
from laff_tpu_torch.utils import trace

TRAIN, VAL = "toytrain", "toyval"
CPU = torch.device("cpu")


def _small(config):
    """The rehearsal headline config cut to test widths, f32 towers."""
    config.vid_feats = ["clip_ft", "x3d"]
    config.vis_fc_layers = ["0", 64]
    config.txt_fc_layers = "0-64"
    config.multi_head_attention = {"dropout": 0.0, "heads": 4, "embed_dim_qkv": 16}
    config.clip_opt = dict(config.clip_opt, size=16)
    config.w2v_dir = "word2vec/toy"
    config.we_dim = 8
    config.rnn_size = 16
    config.threshold = 1
    config.float16 = False
    config.dropout = 0.0
    config.attention_param_each_head = {"with_ave": False, "mul": False, "split_head": True}
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace_world"))
    for coll, n_videos, caps, seed in ((TRAIN, 32, 2, 0), (VAL, 16, 1, 5)):
        build_collection(root, coll, n_videos=n_videos, caps_per_video=caps, seed=seed)
        capfile = os.path.join(root, coll, "TextData", f"{coll}.caption.txt")
        cap_ids = TextSource(capfile).cap_ids
        rows = np.random.default_rng(seed + 11).standard_normal((len(cap_ids), 16))
        write_bigfile(os.path.join(root, coll, "TextData", "clip_synth"), cap_ids,
                      rows.astype(np.float32))
    build_w2v(root)
    return root


@pytest.fixture
def small_config(monkeypatch):
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _small(port_rehearsal.config()))


def _options(root, **kw):
    return port_prepare.Options(trainCollection=TRAIN, valCollection=VAL, rootpath=root,
                                val_set="no", config_name="rehearsal", batch_size=16,
                                device="cpu", **kw)


def _spans(prof):
    """The trace's ``laff.`` spans in order of start: (name, id, start, end)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            out.append((e.name()[len(trace.PREFIX):], e.kwinputs().get("id"), e.start_ns(),
                        e.end_ns()))
    return sorted(out, key=lambda s: s[2])


def _inside(child, parent):
    return parent[2] <= child[2] and child[3] <= parent[3]


def test_span_without_a_profiler_is_one_null_context(monkeypatch):
    def refuse(*args):
        raise AssertionError("a profiler range was made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    first = trace.span("train.dispatch", "epoch=0 dispatch=0")
    assert first is trace.span("eval.metrics") is trace.NULL
    with trace.span("train.enqueue"):
        pass


def test_span_finds_the_profilers_private_names():
    """``span`` leans on two names private to torch; a torch that drops
    either fails here, not in a traced run."""
    assert callable(torch._C._autograd._profiler_enabled)
    assert torch._C._autograd._profiler_enabled() is False
    from torch._C._profiler import _RecordFunctionFast

    assert callable(_RecordFunctionFast)


def test_span_under_a_profiler_is_a_function_scope_range():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with trace.span("eval.validate", "pass=7"):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "laff.eval.validate"]
    assert len(events) == 1
    assert not events[0].is_user_annotation() and events[0].kwinputs() == {"id": "pass=7"}
    assert trace.span("eval.validate") is trace.NULL  # the profiler has stopped


def test_epoch_stream_spans(world, small_config):
    """An epoch of 4 steps in dispatches of 3 (3 + 1) with no loss read
    before ``finish``."""
    pp = port_prepare.prepare(_options(world, model_prefix="trace_stream"))
    model = port_prepare.seeded_model(pp.spec, 0).to(CPU)
    base = port_trainer.TrainStep(model, port_trainer.make_optimizer(pp.config, model), pp.spec)
    multi = port_trainer.MultiStep(base, base, CPU, 3)
    stream = port_trainer.EpochStream(base, pp.train_feed, 2, CPU,
                                      port_trainer.epoch_generator(CPU, 0, 2), multi_step=multi)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        while stream.advance():
            pass
        _, steps = stream.finish()
    assert steps == 4
    spans = _spans(prof)
    dispatches = [s for s in spans if s[0] == "train.dispatch"]
    assert [s[1] for s in dispatches] == ["epoch=2 dispatch=0", "epoch=2 dispatch=1"]
    for d in dispatches:
        inner = [s[0] for s in spans if s is not d and _inside(s, d)]
        assert sorted(inner) == ["train.enqueue", "train.feed_wait"], inner
    reads = [s for s in spans if s[0] == "train.loss_read"]
    assert len(reads) == 1 and reads[0][2] >= dispatches[-1][3]
    assert {s[0] for s in spans} == {"train.dispatch", "train.feed_wait", "train.enqueue",
                                     "train.loss_read"}


def test_validate_spans(world, small_config):
    pp = port_prepare.prepare(_options(world, model_prefix="trace_val"))
    embedder = port_evaluator.Embedder(port_prepare.seeded_model(pp.spec, 3), CPU)
    txt = EvalFeed(pp.val_txt_source.cap_ids, pp.val_txt_batcher, batch_size=6)
    vis = EvalFeed(pp.val_vis_ids, pp.val_vis_batcher, batch_size=5)
    port_evaluator.validate(embedder, txt, vis)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        port_evaluator.validate(embedder, txt, vis)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert sorted(names) == sorted(["eval.validate", "eval.embed_vis", "eval.embed_txt",
                                    "eval.ranks", "eval.gt_index", "eval.readback",
                                    "eval.metrics"]), names
    by = {s[0]: s for s in spans}
    for name in ("embed_vis", "embed_txt", "ranks", "metrics"):
        assert _inside(by[f"eval.{name}"], by["eval.validate"])
        assert by[f"eval.{name}"][1] == "pass=2"
    assert by["eval.validate"][1] == "pass=2" and embedder.passes == 2
    for name in ("gt_index", "readback"):
        assert _inside(by[f"eval.{name}"], by["eval.ranks"])
    assert names.index("eval.embed_vis") < names.index("eval.embed_txt") \
        < names.index("eval.ranks") < names.index("eval.metrics")


def test_profile_env_traces_epoch_1(world, small_config, monkeypatch, tmp_path):
    out = tmp_path / "profile"
    monkeypatch.setenv(port_trainer.PROFILE_ENV, str(out))
    res = port_trainer.main(_options(world, model_prefix="trace_main", num_epochs=2))
    assert res["epochs"] == 2
    files = os.listdir(out)
    assert files == ["epoch_1.rank_0.json"]
    with open(out / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"laff.train.dispatch", "laff.train.enqueue", "laff.eval.validate"} <= names
    ids = [e["args"].get("id") for e in events if e.get("name") == "laff.train.dispatch"]
    assert ids and all(i.startswith("epoch=1 dispatch=") for i in ids), ids
