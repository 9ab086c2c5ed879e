"""The trainer's default dispatch path on the CPU, held against laff_tpu.

* the indexed text feed: ``BowVec`` / ``W2Vec.encode_batch_indexed``, the
  w2v row table and the indexed ``TextBatcher``, array for array;
* the device caches: ``DeviceVisCache`` / ``DeviceTxtCache`` arrays (bf16 on
  and off) and both byte estimates equal laff_tpu's; gathered rows equal
  the fed batch bit for bit;
* ``laff_tpu.engine.trainer.main`` against the port's ``main``, both at the
  default options (both caches, K = 8 capped to the epoch's 4 steps; on the
  CPU the port runs the K steps eagerly), two epochs from the same init with
  dropout off: each epoch's loss within EPOCH_LOSS_RTOL, metrics equal; the
  same with ``device_text_featurize=1``, with ``trainCollection2`` and with
  ``train_strategy='subset'``;
* staged validation against unstaged, within and over the budget; the bf16
  rounding of eval batches on the card against the host's;
* the indexed text feed against the dense one, bit for bit; the
  optimizer's state tensors stay put; the port's bigru against laff_tpu's;
  K eager steps against single steps; ``--resume`` at defaults.
"""

import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.data import TextBatcher as JTextBatcher
from laff_tpu.data import TextSource as JTextSource
from laff_tpu.data.synth import build_collection, build_w2v
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import feature_cache as jax_cache
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.models.gru import GruEncoder as FlaxGru
from laff_tpu.models.spec import GruSpec as JGruSpec
from laff_tpu.store import write_bigfile
from laff_tpu.text.txt2vec import get_txt2vec as jax_txt2vec
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import EvalFeed, TextBatcher, TextSource
from laff_tpu_torch.engine import evaluator as port_evaluator
from laff_tpu_torch.engine import feature_cache as port_cache
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, load_checkpoint, save_checkpoint
from laff_tpu_torch.engine.optim import OptaxChain
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import GruEncoder
from laff_tpu_torch.models.spec import GruSpec
from laff_tpu_torch.text.txt2vec import get_txt2vec

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TRAIN, TRAIN2, VAL = "toytrain", "toytrain2", "toyval"
# an epoch's mean loss, laff_tpu (XLA on the CPU) against the port (torch on
# the CPU) from the same init: f32 sums in another order, four steps deep
# (the bound the trainer test's runs reach)
EPOCH_LOSS_RTOL = 2.6e-7
F32_ATOL = 1e-5  # GRU outputs: f32 recurrences in another order


def _small(config):
    """The rehearsal headline config cut to test widths (as the trainer test
    cuts it), dropout off, f32 towers."""
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
    root = str(tmp_path_factory.mktemp("dispatch_world"))
    for coll, n_videos, caps, seed in ((TRAIN, 32, 2, 0), (TRAIN2, 16, 2, 9), (VAL, 16, 1, 5)):
        build_collection(root, coll, n_videos=n_videos, caps_per_video=caps, seed=seed,
                         feat_dims=(("clip_ft", 16), ("x3d", 12)))
        capfile = os.path.join(root, coll, "TextData", f"{coll}.caption.txt")
        cap_ids = JTextSource(capfile).cap_ids
        rows = np.random.default_rng(seed + 11).standard_normal((len(cap_ids), 16))
        write_bigfile(os.path.join(root, coll, "TextData", "clip_synth"), cap_ids,
                      rows.astype(np.float32))
    build_w2v(root)
    return root


@pytest.fixture
def small_configs(monkeypatch):
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _small(jax_rehearsal.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _small(port_rehearsal.config()))


def _base(root, **kw):
    return dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                config_name="rehearsal", batch_size=16, **kw)


def _captions(root, coll=TRAIN):
    return TextSource(os.path.join(root, coll, "TextData", f"{coll}.caption.txt"))


def _float(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) else \
        a.float().numpy()


# ---------------------------------------------------------------------------
# the indexed text feed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", [0, 2])
def test_indexed_bow_matches_laff_tpu(world, norm):
    from laff_tpu.text import build_vocab as jax_build_vocab
    from laff_tpu_torch.text import build_vocab

    src = _captions(world)
    vocab, _ = build_vocab(src.capfile, "bow_nsw", threshold=1)
    jvocab, _ = jax_build_vocab(src.capfile, "bow_nsw", threshold=1)
    queries = src.captions_for(src.cap_ids[:20]) + ["", "zzz unknown words"]
    ours = get_txt2vec("bow_nsw")(vocab, norm=norm).encode_batch_indexed(queries, 6)
    ref = jax_txt2vec("bow_nsw")(jvocab, norm=norm).encode_batch_indexed(queries, 6)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # scattered back, the pairs give the dense row
    dense = get_txt2vec("bow_nsw")(vocab, norm=norm).encode_batch(queries)
    ids, cnt = ours
    back = np.zeros((len(queries), dense.shape[1] + 1), np.float32)
    np.add.at(back, (np.arange(len(queries))[:, None], ids), cnt)
    np.testing.assert_allclose(back[:, :-1], dense, rtol=1e-6, atol=1e-7)


def test_indexed_w2v_matches_laff_tpu(world):
    src = _captions(world)
    w2v_dir = os.path.join(world, "word2vec", "toy")
    caps = list(src.captions.values())
    ours, ref = get_txt2vec("w2v_nsw")(w2v_dir), jax_txt2vec("w2v_nsw")(w2v_dir)
    np.testing.assert_array_equal(ours.build_row_index(caps), ref.build_row_index(caps))
    queries = caps[:20] + ["", "nothing known here"]
    for a, b in zip(ours.encode_batch_indexed(queries, 7), ref.encode_batch_indexed(queries, 7)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the mean pool of the rows is the host mean, bit for bit
    ids, n = ours.encode_batch_indexed(queries, 7)
    pooled = port_trainer.pool_w2v({"w2v_ids": torch.from_numpy(ids),
                                    "w2v_len": torch.from_numpy(n)},
                                   torch.from_numpy(ours.table))["w2v"]
    np.testing.assert_array_equal(pooled.numpy(), ours.encode_batch(queries))


@pytest.mark.parametrize("indexed_bow,indexed_w2v", [(True, False), (False, True),
                                                     (True, True)])
def test_indexed_text_batcher_matches_laff_tpu(world, small_configs, indexed_bow, indexed_w2v):
    jp = jax_prepare.prepare(JOptions(model_prefix="tb_j", **_base(world)))
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="tb_p", device="cpu",
                                                   **_base(world)))
    caps = list(pp.train_feed.text_batcher.source.captions.values())
    for prep in (jp, pp):
        prep.featurizers["w2v"].build_row_index(caps)
    jb = JTextBatcher(jp.train_feed.text_batcher.source, jp.train_feed.text_batcher.featurizers,
                      max_txtlength=20, indexed_bow=indexed_bow, indexed_w2v=indexed_w2v)
    pb = TextBatcher(pp.train_feed.text_batcher.source, pp.train_feed.text_batcher.featurizers,
                     max_txtlength=20, indexed_bow=indexed_bow, indexed_w2v=indexed_w2v)
    cap_ids = pp.train_feed.cap_ids[:24]
    got, ref = pb(cap_ids), jb(cap_ids)
    assert set(got) == set(ref)
    assert ("bow_ids" in got) == indexed_bow and ("w2v_ids" in got) == indexed_w2v
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the device caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_device_caches_match_laff_tpu(world, small_configs, bf16):
    jp = jax_prepare.prepare(JOptions(model_prefix="c_j", **_base(world)))
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="c_p", device="cpu",
                                                   **_base(world)))
    cpu = torch.device("cpu")
    pairs = [
        (port_cache.DeviceVisCache(pp.train_feed.vis_batcher, cpu, bf16=bf16, chunk=10),
         jax_cache.DeviceVisCache(jp.train_feed.vis_batcher, bf16=bf16, chunk=10)),
        (port_cache.DeviceTxtCache(pp.train_feed.text_batcher, cpu, bf16=bf16, chunk=20),
         jax_cache.DeviceTxtCache(jp.train_feed.text_batcher, bf16=bf16, chunk=20)),
    ]
    for ours, ref in pairs:
        assert ours.row == ref.row and ours.nbytes == ref.nbytes
        assert set(ours.arrays) == set(ref.arrays)
        for k, v in ours.arrays.items():
            r = np.asarray(ref.arrays[k])
            assert v.shape == r.shape, k
            assert (v.dtype == torch.bfloat16) == (bf16 and r.dtype != np.int32), k
            np.testing.assert_array_equal(_float(v), _float(r.astype(np.float32)), err_msg=k)
        ids = list(ours.row)[3:9]
        idx = ours.indices(ids)
        assert idx.dtype == torch.int64 and not idx.is_pinned()
        np.testing.assert_array_equal(idx.numpy(), ref.indices(ids))
    assert port_cache.estimate_vis_cache_bytes(pp.train_feed.vis_batcher, bf16=bf16) == \
        jax_cache.estimate_vis_cache_bytes(jp.train_feed.vis_batcher, bf16=bf16)
    assert port_cache.estimate_txt_cache_bytes(pp.train_feed.text_batcher, bf16=bf16) == \
        jax_cache.estimate_txt_cache_bytes(jp.train_feed.text_batcher, bf16=bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_gathered_batches_equal_fed_batches(world, small_configs, bf16):
    """Rows gathered from the caches equal the fed path's batches (the host
    bf16 cast included) bit for bit, on three batches of two epochs."""
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="g_p", device="cpu",
                                                   **_base(world)))
    feed, cpu = pp.train_feed, torch.device("cpu")
    vis = port_cache.DeviceVisCache(feed.vis_batcher, cpu, bf16=bf16)
    txt = port_cache.DeviceTxtCache(feed.text_batcher, cpu, cap_ids=feed.cap_ids, bf16=bf16)
    for epoch in (0, 1):
        for i, batch in zip(range(3), feed.epoch(epoch)):
            fed = port_trainer.host_batch(batch, pin=False, cast_txt=bf16, cast_vis=bf16)
            for side, cache, ids in (("vis", vis, batch["vis_ids"]),
                                     ("txt", txt, batch["cap_ids"])):
                got = cache.gather(cache.indices(ids))
                assert set(got) == set(fed[side])
                for k, v in got.items():
                    assert v.dtype == fed[side][k].dtype and torch.equal(v, fed[side][k]), k


# ---------------------------------------------------------------------------
# the trainer end to end at defaults, against laff_tpu
# ---------------------------------------------------------------------------

def _run_both(world, tmp_path, prefix, **kw):
    """laff_tpu.engine.trainer.main and the port's main, two epochs from the
    same init, the options given on top of the defaults."""
    base = _base(world, num_epochs=2, **kw)
    jopt = JOptions(model_prefix=f"j_{prefix}", **base)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)
    popt = port_prepare.Options(model_prefix=f"p_{prefix}", device="cpu", **base)
    pprep = port_prepare.prepare(popt)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / f"init_{prefix}.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)
    return jres, pres


def _same_run(jres, pres):
    assert len(jres["history"]) == len(pres["history"]) == 2
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL), (pe, je)
        assert pe["lr"] == je["lr"]
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
    assert pres["best_perf"] == jres["best_perf"]


@pytest.mark.parametrize("variant", ["defaults", "device_text_featurize", "trainCollection2",
                                     "subset"])
def test_trainer_at_defaults_matches_laff_tpu(world, small_configs, tmp_path, variant):
    kw = {"defaults": {}, "device_text_featurize": {"device_text_featurize": 1},
          "trainCollection2": {"trainCollection2": TRAIN2},
          "subset": {"train_strategy": "subset"}}[variant]
    jres, pres = _run_both(world, tmp_path, variant, **kw)
    d = pres["dispatch"]
    assert d["vis_cache_bytes"] and d["txt_cache_bytes"] and d["stage_val_features"]
    steps = pres["history"][0]["steps"]
    assert d["steps_per_dispatch"] == min(8, steps) and not d["graph"]  # eager on the CPU
    _same_run(jres, pres)
    if variant == "trainCollection2":
        assert "toytrain_toytrain2" in pres["model_path"]
        assert pres["history"][0]["steps"] == 4
    if variant == "subset":  # 63 of 64 captions train (3 steps), 1 validates
        assert pres["history"][0]["steps"] == 3


def test_train2_epoch_pools_indexed_w2v(world, small_configs):
    """With trainCollection2 and device_text_featurize=1, the second
    collection's single fed steps pool their w2v row ids too (laff_tpu runs
    them through its unpooled step, which finds no 'w2v'): the run equals
    the dense one."""
    runs = [port_trainer.main(port_prepare.Options(
        model_prefix=f"t2x{dtf}", device="cpu", trainCollection2=TRAIN2, num_epochs=2,
        device_text_featurize=dtf, **_base(world))) for dtf in (0, 1)]
    for dense, indexed in zip(runs[0]["history"], runs[1]["history"]):
        for k in ("loss", "steps", *port_trainer.METRICS):
            assert indexed[k] == dense[k], k


def _dispatch_choice(world, monkeypatch, budget, **kw):
    if budget is not None:
        monkeypatch.setenv(port_trainer.CACHE_BUDGET_ENV, str(budget))
    opt = port_prepare.Options(model_prefix="dc", device="cpu", **_base(world), **kw)
    pp = port_prepare.prepare(opt)
    model = port_prepare.seeded_model(pp.spec, 0)
    base = port_trainer.TrainStep(model, port_trainer.make_optimizer(pp.config, model), pp.spec)
    return port_trainer.setup_dispatch(opt, pp, base, torch.device("cpu"), False, False), \
        pp.train_feed


@pytest.mark.parametrize("case", ["auto", "budget_vis_only", "budget_none", "txt_forced",
                                  "fed_k3"])
def test_dispatch_rules(world, small_configs, monkeypatch, case):
    """laff_tpu's rules: auto caches within LAFF_TPU_CACHE_BUDGET, the text
    cache only beside the visual one unless forced, auto K 8 (capped to the
    epoch) only with both, the prefetch depth, and the feed featurizing only
    the sides no cache holds."""
    vis_bytes = 32 * (16 + 12) * 4  # 32 videos x (clip_ft 16 + x3d 12) f32
    budget, kw, want = {
        "auto": (None, {}, (True, True, 4, 6)),
        "budget_vis_only": (vis_bytes, {}, (True, False, 1, 3)),
        "budget_none": (1, {}, (False, False, 1, 3)),
        "txt_forced": (None, {"device_feature_cache": 0, "device_text_cache": 1},
                       (False, True, 1, 3)),
        "fed_k3": (None, {"device_feature_cache": 0, "steps_per_dispatch": 3},
                   (False, False, 3, 3)),
    }[case]
    d, feed = _dispatch_choice(world, monkeypatch, budget, **kw)
    vis_on, txt_on, k, depth = want
    assert (d["vis_cache"] is not None, d["txt_cache"] is not None) == (vis_on, txt_on)
    assert d["steps_per_dispatch"] == k and (d["multi_step"] is not None) == (k > 1)
    assert d["prefetch_depth"] == depth
    assert (feed.featurize_vis, feed.featurize_txt) == (not vis_on, not txt_on)
    if vis_on:
        assert d["vis_cache"].nbytes == vis_bytes


def test_indexed_text_steps_equal_dense_steps(world, small_configs):
    """An epoch on the indexed text feed (bow densified in the tower, w2v
    pooled in the step) gives the dense feed's losses and parameters bit for
    bit: the same inputs reach the towers."""
    cpu = torch.device("cpu")
    out = []
    for dtf in (0, 1):
        pp = port_prepare.prepare(port_prepare.Options(
            model_prefix=f"ix{dtf}", device="cpu", device_text_featurize=dtf, **_base(world)))
        model = port_prepare.seeded_model(pp.spec, 0)
        base = port_trainer.TrainStep(model, port_trainer.make_optimizer(pp.config, model),
                                      pp.spec)
        step = base
        if dtf:
            assert {"bow_ids", "w2v_ids"} <= set(next(pp.train_feed.epoch(0))["txt"])
            step = port_trainer.make_w2v_pooled_train_step(base, torch.from_numpy(pp.w2v_table))
        loss, _ = port_trainer.train_one_epoch(step, pp.train_feed, 0, cpu,
                                               port_trainer.epoch_generator(cpu, 0, 0))
        out.append((loss, torch.cat([p.detach().flatten() for p in model.parameters()])))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])


def test_k_eager_steps_equal_single_steps(world, small_configs):
    """On the CPU a K-step dispatch is K eager steps: an epoch in groups of
    3 (3 + 1) gives the losses and parameters of an epoch of single steps."""
    opt = port_prepare.Options(model_prefix="k", device="cpu", **_base(world))
    pp = port_prepare.prepare(opt)
    cpu = torch.device("cpu")
    out = []
    for k in (1, 3):
        model = port_prepare.seeded_model(pp.spec, 0).to(cpu)
        base = port_trainer.TrainStep(model, port_trainer.make_optimizer(pp.config, model), pp.spec)
        multi = port_trainer.MultiStep(base, base, cpu, k) if k > 1 else None
        loss, n = port_trainer.train_one_epoch(base, pp.train_feed, 0, cpu,
                                               port_trainer.epoch_generator(cpu, 0, 0),
                                               multi_step=multi, log_every=2)
        out.append((loss, n, torch.cat([p.detach().flatten() for p in model.parameters()])))
    assert out[0][:2] == out[1][:2] and out[0][1] == 4
    assert torch.equal(out[0][2], out[1][2])


def test_resume_at_defaults_repeats_the_run(world, small_configs, monkeypatch):
    """Three epochs straight against two, then a resumed third, at the
    default dispatch (caches, K eager steps) with a short last group and
    dropout on: the same losses and best checkpoint, bit for bit."""
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _dropout(_small(port_rehearsal.config())))
    base = _base(world, device="cpu", steps_per_dispatch=3)
    a = port_trainer.main(port_prepare.Options(num_epochs=3, model_prefix="rdA", **base))
    opt_b = port_prepare.Options(num_epochs=2, model_prefix="rdB", resume=1, **base)
    port_trainer.main(opt_b)
    b = port_trainer.main(dataclasses.replace(opt_b, num_epochs=3))
    assert a["dispatch"]["steps_per_dispatch"] == 3 and a["dispatch"]["txt_cache_bytes"]
    assert [e["loss"] for e in b["history"]] == [e["loss"] for e in a["history"][2:]]
    assert b["best_perf"] == a["best_perf"]
    ca = load_checkpoint(os.path.join(a["model_path"], "model_best.pth.tar"))
    cb = load_checkpoint(os.path.join(b["model_path"], "model_best.pth.tar"))
    assert ca["epoch"] == cb["epoch"]
    for k, v in ca["state_dict"].items():
        assert torch.equal(v, cb["state_dict"][k]), k


def _dropout(config):
    config.dropout = 0.2
    return config


# ---------------------------------------------------------------------------
# staged validation
# ---------------------------------------------------------------------------

class _Counting:
    def __init__(self, batcher):
        self.batcher, self.calls = batcher, 0

    def __call__(self, ids):
        self.calls += 1
        return self.batcher(ids)


@pytest.mark.parametrize("budget", [None, 1])
def test_staged_validation_equals_unstaged(world, small_configs, monkeypatch, budget):
    """Validation from staged batches (the second pass replays them, no
    featurization) gives the unstaged metrics and ranks exactly; over the
    budget the feeds stream unstaged with the same result."""
    if budget is not None:
        monkeypatch.setenv(port_evaluator.STAGE_BUDGET_ENV, str(budget))
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="st", device="cpu",
                                                   **_base(world)))
    model = port_prepare.seeded_model(pp.spec, 3)
    embedder = port_evaluator.Embedder(model, torch.device("cpu"))

    def feeds(stage):
        txt = EvalFeed(pp.val_txt_source.cap_ids, _Counting(pp.val_txt_batcher), batch_size=6)
        vis = EvalFeed(pp.val_vis_ids, _Counting(pp.val_vis_batcher), batch_size=5)
        txt.stage_on_device = vis.stage_on_device = stage
        return txt, vis

    ref = port_evaluator.validate(embedder, *feeds(False))
    txt, vis = feeds(True)
    for rnd in range(2):
        got = port_evaluator.validate(embedder, txt, vis)
        for k in port_trainer.METRICS:
            assert got[k] == ref[k], (k, rnd)
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        assert got["txt_ids"] == ref["txt_ids"] and got["vis_ids"] == ref["vis_ids"]
    staged = budget is None
    assert (txt.staged is not None) == staged and (vis.staged is not None) == staged
    assert txt.batcher.calls == (3 if staged else 6)  # 16 captions in batches of 6
    assert vis.batcher.calls == (4 if staged else 8)  # 16 videos in batches of 5


@pytest.mark.parametrize("stage", [False, True])
def test_card_cast_equals_host_cast(world, small_configs, monkeypatch, stage):
    """bf16 towers: rounding the eval batches after the upload (host_cast
    off) stages the same bf16 tensors and gives the embeddings and ranks of
    rounding them on the host."""
    def bf16(config):
        config.float16 = True
        return config

    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": bf16(_small(port_rehearsal.config())))
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="cc", device="cpu",
                                                   **_base(world)))
    assert pp.spec.txt.compute_dtype == "bfloat16"
    model = port_prepare.seeded_model(pp.spec, 3).eval()  # no BatchNorm updates
    out = []
    for host_cast in (True, False):
        embedder = port_evaluator.Embedder(model, torch.device("cpu"), host_cast=host_cast)
        txt = EvalFeed(pp.val_txt_source.cap_ids, pp.val_txt_batcher, batch_size=6)
        vis = EvalFeed(pp.val_vis_ids, pp.val_vis_batcher, batch_size=5)
        txt.stage_on_device = vis.stage_on_device = stage
        res = port_evaluator.validate(embedder, txt, vis)
        if stage:
            for _, items in (txt.staged, vis.staged):
                for data, _, _ in items:
                    assert all(v.dtype != torch.float32 for v in data.values())
        out.append((embedder.embed_txt(txt)[0], embedder.embed_vis(vis)[0], res["ranks"]))
    for a, b in zip(*out):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------------------------------
# the optimizer's state, the bigru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_optimizer_state_stays_in_place(kind):
    """A captured graph writes the tensors it saw: step and load_state_dict
    update count, moments and lr in place."""
    params = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.zeros(2, 3))]
    opt = OptaxChain(params, kind, 1e-2, grad_clip=2, skip_nonfinite=True)
    names = ["count", "nu", "lr"] + (["mu"] if kind == "adam" else [])
    ptrs = {n: getattr(opt, n).data_ptr() for n in names}
    for i in range(3):
        for p in params:
            p.grad.fill_(float(i + 1))
        opt.step()
    state = opt.state_dict()
    assert int(state["count"]) == 3
    opt.step()
    assert int(opt.count) == 4 and int(state["count"]) == 3  # the state dict is a copy
    opt.load_state_dict(state)
    assert int(opt.count) == 3
    assert {n: getattr(opt, n).data_ptr() for n in names} == ptrs
    assert torch.equal(opt.nu, state["nu"])


@pytest.mark.parametrize("pooling,layers", [("mean", 1), ("last", 2), ("mean_last", 2)])
def test_bigru_matches_laff_tpu(pooling, layers):
    """The bidirectional GRU, its reverse direction run over each caption's
    reversed valid prefix on the device, against laff_tpu's masked scan, in
    training mode and with lengths from 1 to T."""
    rng = np.random.default_rng(4)
    spec = JGruSpec(vocab_size=30, we_dim=8, rnn_size=16, rnn_layer=layers, pooling=pooling,
                    bidirectional=True)
    ids = rng.integers(1, 30, (7, 10)).astype(np.int32)
    lengths = np.asarray([10, 7, 3, 1, 9, 5, 2], np.int32)
    ids[np.arange(10)[None, :] >= lengths[:, None]] = 0
    flax_mod = FlaxGru(spec)
    variables = flax_mod.init(jax.random.key(5), ids, lengths)
    ref = np.asarray(flax_mod.apply(variables, ids, lengths))
    ours = GruEncoder(GruSpec(**dataclasses.asdict(spec))).train()
    sd = from_jax_variables({"gru": jax.tree_util.tree_map(np.asarray, variables["params"])})
    ours.load_state_dict({k[len("gru."):]: v for k, v in sd.items()})
    out = ours(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=F32_ATOL, rtol=0)
    out.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in ours.parameters())
