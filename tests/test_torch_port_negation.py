"""task3, negation-aware retrieval, on the CPU, held against laff_tpu.

* the text helpers (``negation_augmentation``, ``split_negation``): equal;
* ``TextSource(task3=True)`` and ``PairFeed``'s 'false_txt' and
  'task3_mask' over two seeded epochs: equal;
* ``_masked_margin2`` (every margin on or off, single- and multi-head, mask
  values -1, 0 and 1, an epoch before and past ``end_epoch``) and the
  negation losses ``margin_loss``, ``margin2_loss`` and ``kl_loss``: value
  and gradients within 1e-6 relative to the largest magnitude;
* the false-caption forward leaves the text tower's BatchNorm running
  statistics as the main forward left them;
* ``laff_tpu.engine.trainer.main`` against the port's ``main`` with
  ``task3_caption`` from the same init (dropout off, two epochs): each
  epoch's loss within 1e-5 relative, the validation and ``task3_*`` metrics
  equal, the dispatch's choice (visual cache, no text cache, K 1), and
  ``--device_text_cache 1`` refused as laff_tpu refuses it;
* ``--device_text_featurize 1`` with task3 (the false caption's w2v pooled
  on the device) against the dense feed: equal losses.

The world is laff_tpu's small synthetic collections with a false-caption
set in the layout of ``tests/test_task3.py`` (ids '<cap>F<k>p' and
'<cap>Fn') and a validation negation set, built once per module.
"""

import dataclasses
import importlib
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.data.sources import TextSource as JTextSource
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.models.spec import Task3Spec
from laff_tpu.ops import losses as jax_losses
from laff_tpu.text import textlib as jax_textlib
from laff_tpu_torch.configs import tiny as port_tiny
from laff_tpu_torch.data import TextSource
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.ops import losses as port_losses
from laff_tpu_torch.text import textlib as port_textlib

from helpers import WORDS, build_collection, build_w2v

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TRAIN, VAL = "toytrain", "toyval"
LOSS_RTOL = 1e-6  # losses and gradients: max |diff| over the largest magnitude
EPOCH_LOSS_RTOL = 1e-5  # an epoch's mean loss after the steps before it

CAPTIONS = [
    "a man doesn't wear a hat", "the dog does not run", "people don t smile",
    "a car isn't red and can't stop", "a woman without a bag walks",
    "nobody never sleeps", "a cat is not on the table", "no", "plain caption",
    "they won't go but they will not stay", "it couldn't be", "not at the start",
]


def _tiny(config):
    """laff_tpu's tiny config with dropout off (parity is held without
    draws)."""
    config.dropout = 0.0
    config.dropout_task2 = 0.0
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("task3_world"))
    build_collection(root, TRAIN, n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, VAL, n_videos=12, caps_per_video=2, seed=5)
    build_w2v(root)
    cap_path = os.path.join(root, TRAIN, "TextData", f"{TRAIN}.caption.txt")
    # each caption's false captions are its own (a shared one would make
    # identical augmented captions, whose hardest negatives tie within f32
    # rounding and move the two packages apart)
    lines = []
    with open(cap_path) as fh:
        for i, line in enumerate(fh):
            cap_id, caption = line.strip().split(" ", 1)
            word = WORDS[(5 * i) % len(WORDS)]
            if i % 3 == 0:
                lines.append(f"{cap_id}F0p {caption} does not {word}")
                lines.append(f"{cap_id}F1p {caption} doesn't {word}")
            elif i % 3 == 1:
                lines.append(f"{cap_id}Fn the {word} {' '.join(caption.split()[2:])}")
    with open(os.path.join(root, TRAIN, "TextData", f"{TRAIN}.caption.false.txt"), "w") as fh:
        fh.write("\n".join(lines))
    with open(os.path.join(root, VAL, "TextData", f"{VAL}.caption.txt")) as fh:
        val_ids = [line.split(" ", 1)[0] for line in fh if line.strip()]
    with open(os.path.join(root, VAL, "TextData", f"{VAL}.caption.negationset.txt"),
              "w") as fh:
        fh.write("\n".join(f"{c} a negated caption" for c in val_ids[::3]))
    return root


def _opts(root, **kw):
    return dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                config_name="tiny", batch_size=12, task3_caption="false", **kw)


@pytest.fixture
def tiny_configs(monkeypatch):
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _tiny(jax_tiny.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _tiny(port_tiny.config()))


# ---------------------------------------------------------------------------
# text and feeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caption", CAPTIONS)
def test_negation_text_helpers_equal_laff_tpu(caption):
    assert port_textlib.negation_augmentation(caption) == \
        jax_textlib.negation_augmentation(caption)
    assert port_textlib.negation_augumentation is port_textlib.negation_augmentation
    assert port_textlib.split_negation(caption) == jax_textlib.split_negation(caption)


@pytest.mark.parametrize("shuffle_seed", [None, 2])
def test_task3_text_source_equals_laff_tpu(world, shuffle_seed):
    path = os.path.join(world, TRAIN, "TextData", f"{TRAIN}.caption.false.txt")
    j = JTextSource(path, task3=True, shuffle_seed=shuffle_seed)
    p = TextSource(path, task3=True, shuffle_seed=shuffle_seed)
    assert p.cap_ids == j.cap_ids and p.mask_task3 == j.mask_task3
    assert p.captions_multi == j.captions_multi
    assert p.negation_augmented() == j.negation_augmented()
    ids = p.cap_ids + [f"video{i}#1" for i in range(24)]
    rj, rp = random.Random(7), random.Random(7)
    assert [p.false_caption(c, rp) for c in ids] == [j.false_caption(c, rj) for c in ids]
    plain = TextSource(os.path.join(world, TRAIN, "TextData", f"{TRAIN}.caption.txt"))
    assert plain.false_caption(ids[0], rp) == (None, -1)


def test_pair_feed_false_captions_equal_laff_tpu(world, tiny_configs):
    jprep = jax_prepare.prepare(JOptions(model_prefix="feed_j", **_opts(world)))
    pprep = port_prepare.prepare(port_prepare.Options(model_prefix="feed_p", device="cpu",
                                                      **_opts(world)))
    assert pprep.negationset_path == jprep.negationset_path
    assert dataclasses.asdict(pprep.spec.task3) == dataclasses.asdict(jprep.spec.task3)
    for epoch in (0, 1):
        jb = list(jprep.train_feed.epoch(epoch))
        pb = list(pprep.train_feed.epoch(epoch))
        assert len(jb) == len(pb) == 4
        for a, b in zip(jb, pb):
            assert a["cap_ids"] == b["cap_ids"]
            np.testing.assert_array_equal(b["task3_mask"], a["task3_mask"])
            assert set(np.unique(b["task3_mask"])) <= {-1, 0, 1}
            for side in ("txt", "false_txt", "vis"):
                assert set(b[side]) == set(a[side]), side
                for k in a[side]:
                    np.testing.assert_array_equal(b[side][k], a[side][k], err_msg=(side, k))
            # a row without an entry carries an empty false caption
            none = b["task3_mask"] == -1
            assert not b["false_txt"]["bow"][none].any()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _close(port, ref, rtol=LOSS_RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(port - ref).max() <= rtol * scale, (port, ref)


def _check(port_fn, jax_fn, *arrays):
    """Value and the gradient of every float input."""
    ts = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    value = port_fn(*ts)
    value.backward()
    floats = tuple(i for i, a in enumerate(arrays) if a.dtype == np.float32)
    ref, grads = jax.value_and_grad(jax_fn, argnums=floats)(*map(jnp.asarray, arrays))
    _close(value.detach().numpy(), ref)
    for i, g in zip(floats, grads):
        _close(ts[i].grad.numpy(), g)


MARGINS = {
    "all": {},
    "no_bottom": {"bottom_margin": None},
    "no_upper": {"upper_margin": None},
    "no_bottom_t2t": {"bottom_margin_t2t": None},
    "no_upper_t2t": {"upper_margin_t2t": None},
}


@pytest.mark.parametrize("epoch", [0, 7])
@pytest.mark.parametrize("heads", [0, 4])
@pytest.mark.parametrize("margins", sorted(MARGINS))
def test_masked_margin2_matches_laff_tpu(margins, heads, epoch):
    rng = np.random.default_rng(heads + epoch)
    shape = (9, heads, 6) if heads else (9, 6)
    txt, vis, false = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = np.array([-1, 0, 1, 1, 0, -1, 1, 0, 1], np.int32)
    task3 = Task3Spec(neg_weight=2.5, retrieval_weight=0.3, end_epoch=5, **MARGINS[margins])
    _check(lambda t, v, f, m: port_trainer._masked_margin2(t, v, f, m, task3,
                                                           torch.tensor(epoch)),
           lambda t, v, f, m: jax_trainer._masked_margin2(t, v, f, m, task3,
                                                          jnp.asarray(epoch)),
           txt, vis, false, mask)
    if epoch >= task3.end_epoch:
        out = port_trainer._masked_margin2(*map(torch.tensor, (txt, vis, false, mask)),
                                           task3, torch.tensor(epoch))
        assert float(out) == 0.0


@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("measure", ["cosine", "hist"])
def test_negation_losses_match_laff_tpu(measure, cost_style):
    rng = np.random.default_rng(3)
    txt, vis, false = (np.abs(rng.standard_normal((7, 5))).astype(np.float32)
                       for _ in range(3))
    weight = (rng.uniform(size=7) > 0.5).astype(np.float32)
    kw = dict(measure=measure, cost_style=cost_style)
    _check(lambda t, v, f, w: port_losses.margin_loss(t, v, f, w, neg_weight=2.0, **kw),
           lambda t, v, f, w: jax_losses.margin_loss(t, v, f, w, neg_weight=2.0, **kw),
           txt, vis, false, weight)
    m2 = dict(bottom_margin=0.2, upper_margin=None, neg_weight=3.0, **kw)
    _check(lambda t, v, f, w: port_losses.margin2_loss(t, v, f, w, **m2),
           lambda t, v, f, w: jax_losses.margin2_loss(t, v, f, w, **m2),
           txt, vis, false, weight)
    _check(lambda t, v, f, w: port_losses.margin2_loss(t, v, f, w, **kw),
           lambda t, v, f, w: jax_losses.margin2_loss(t, v, f, w, **kw),
           txt, vis, false, weight)
    scores, origin = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    _check(lambda s, o: port_losses.kl_loss(s, o, cost_style),
           lambda s, o: jax_losses.kl_loss(s, o, cost_style), scores, origin)


def test_false_forward_keeps_the_main_forwards_batch_statistics(world, tiny_configs):
    """A task3 step's running statistics are the main forward's update
    alone: the same as a step whose batch has no false caption."""
    prep = port_prepare.prepare(port_prepare.Options(model_prefix="bn", device="cpu",
                                                     **_opts(world)))
    batch = next(iter(prep.train_feed.epoch(0)))
    txt = {k: torch.from_numpy(v) for k, v in port_trainer.step_text(batch).items()}
    vis = {k: torch.from_numpy(v) for k, v in batch["vis"].items()}
    stats = {}
    for with_false in (True, False):
        model = port_prepare.seeded_model(prep.spec, 0)
        step = port_trainer.TrainStep(model, port_trainer.make_optimizer(prep.config, model),
                                      prep.spec)
        main, _, _ = port_trainer.split_task3(txt)
        step.loss(txt if with_false else main, vis)
        stats[with_false] = {k: v.clone() for k, v in model.state_dict().items()
                             if "running" in k}
    assert stats[True].keys() == stats[False].keys() and stats[True]
    for k in stats[True]:
        assert torch.equal(stats[True][k], stats[False][k]), k


# ---------------------------------------------------------------------------
# the trainer against laff_tpu
# ---------------------------------------------------------------------------

def _jax_and_port(world, tmp_path, prefix, **kw):
    jopt = JOptions(model_prefix=f"{prefix}_j", num_epochs=2, **_opts(world, **kw))
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)
    popt = port_prepare.Options(model_prefix=f"{prefix}_p", num_epochs=2, device="cpu",
                                **_opts(world, **kw))
    pprep = port_prepare.prepare(popt)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    return jres, port_trainer.main(popt, prepared=pprep)


def test_task3_trainer_matches_laff_tpu(world, tiny_configs, tmp_path):
    jres, pres = _jax_and_port(world, tmp_path, "t3")
    assert pres["dispatch"]["vis_cache_bytes"] and pres["dispatch"]["txt_cache_bytes"] is None
    assert pres["dispatch"]["steps_per_dispatch"] == 1
    assert len(jres["history"]) == len(pres["history"]) == 2
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
            assert pe[f"task3_{k}"] == je[f"task3_{k}"], (k, pe, je)
    tags = {line.split("\t")[1] for line in open(os.path.join(pres["model_path"],
                                                               "scalars.tsv"))}
    assert {"task3val/r1", "task3val/mir"} <= tags


def test_task3_refuses_a_forced_text_cache_and_skips_a_missing_negationset(
        world, tiny_configs):
    opt = port_prepare.Options(model_prefix="t3_forced", num_epochs=1, device="cpu",
                               device_text_cache=1, **_opts(world))
    with pytest.raises(ValueError, match="incompatible with task3"):
        port_trainer.main(opt)
    assert port_trainer.read_negationset(os.path.join(world, "nowhere.txt")) is None


def test_task3_indexed_text_feed_equals_dense(world, tiny_configs):
    """device_text_featurize pools the false caption's w2v rows as it
    pools the caption's: the same losses as the dense feed."""
    runs = [port_trainer.main(port_prepare.Options(
        model_prefix=f"t3_dtf{d}", num_epochs=2, device="cpu", device_text_featurize=d,
        **_opts(world))) for d in (0, 1)]
    np.testing.assert_allclose([e["loss"] for e in runs[1]["history"]],
                               [e["loss"] for e in runs[0]["history"]], rtol=1e-5)


def test_task3_model_spec_round_trips(world, tiny_configs):
    from laff_tpu_torch.models.spec import spec_from_dict, spec_to_dict

    prep = port_prepare.prepare(port_prepare.Options(model_prefix="rt", device="cpu",
                                                     **_opts(world)))
    assert spec_from_dict(spec_to_dict(prep.spec)) == prep.spec
    assert LAFFModel(prep.spec).task2_vis_head is None
