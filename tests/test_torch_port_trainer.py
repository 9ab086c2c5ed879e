"""The training slice on the CPU, held against laff_tpu on the same inputs.

* losses: value and gradient against ``laff_tpu.ops.losses`` and
  ``laff_tpu.engine.trainer.make_loss_fn`` (``jax.grad``), within 1e-5 of
  the largest magnitude (f32 sums in another order);
* the optimizer: Adam and RMSprop against the optax chain of
  ``laff_tpu.engine.trainer.make_optimizer``, the clip triggered and not,
  and a non-finite step that must leave everything as it was;
* BatchNorm's training forward and running statistics against flax's;
* the trainer end to end: ``laff_tpu.engine.trainer.main`` and the port's
  ``main`` for two epochs of a ``laff_tpu.data.synth`` world from the same
  init (the flax variables carried over by ``from_jax_variables``), with
  dropout off, Adam without and RMSprop with ``with_ave``;
* the CLI on the CPU, its checkpoint scored by the port's predictor,
  resume, the options that raise, and the no-card case.
"""

import dataclasses
import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.data import TextSource as JTextSource
from laff_tpu.data.synth import build_collection, build_w2v
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import load_checkpoint as jax_load
from laff_tpu.models.layers import TransformNet as FlaxTransformNet
from laff_tpu.ops import losses as jax_losses
from laff_tpu.store import write_bigfile
from laff_tpu_torch.cli import do_trainer
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.engine import predictor as port_predictor
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import (average_states, checkpoint_payload,
                                              load_checkpoint, save_checkpoint)
from laff_tpu_torch.engine.optim import OptaxChain
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models.attention import MultiHeadGateAttention
from laff_tpu_torch.models.layers import TransformNet
from laff_tpu_torch.ops import losses as port_losses

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TRAIN, VAL = "toytrain", "toyval"
LOSS_RTOL = 1e-5  # losses and gradients: max |diff| over the largest magnitude
EPOCH_LOSS_RTOL = 1e-4  # an epoch's mean loss after the steps before it
PARAM_ATOL = 1e-5  # parameters and BN statistics after two epochs (moves ~1e-4 a step)


def _small(config, optimizer="adam", with_ave=False, dropout=0.0):
    """The rehearsal headline config cut to test widths, as the slice test
    cuts it, with dropout set and the optimizer and with_ave chosen."""
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
    config.dropout = dropout
    config.optimizer = optimizer
    config.attention_param_each_head = {"with_ave": with_ave, "mul": False,
                                        "split_head": True}
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_world"))
    for coll, n_videos, caps, seed in ((TRAIN, 32, 2, 0), (VAL, 16, 1, 5)):
        build_collection(root, coll, n_videos=n_videos, caps_per_video=caps, seed=seed,
                         feat_dims=(("clip_ft", 16), ("x3d", 12)))
        capfile = os.path.join(root, coll, "TextData", f"{coll}.caption.txt")
        cap_ids = JTextSource(capfile).cap_ids
        rows = np.random.default_rng(seed + 11).standard_normal((len(cap_ids), 16))
        write_bigfile(os.path.join(root, coll, "TextData", "clip_synth"), cap_ids,
                      rows.astype(np.float32))
    build_w2v(root)
    return root


def _base(root, **kw):
    return dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                config_name="rehearsal", batch_size=16, **kw)


def _port_config(monkeypatch, **variant):
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _small(port_rehearsal.config(), **variant))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _embs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(port - ref).max() <= LOSS_RTOL * scale, (port, ref)


def _value_and_grads(port_fn, jax_fn, txt, vis):
    pt = torch.tensor(txt, requires_grad=True)
    pv = torch.tensor(vis, requires_grad=True)
    value = port_fn(pt, pv)
    value.backward()
    ref, (gt, gv) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(txt),
                                                                jnp.asarray(vis))
    _close(value.detach().numpy(), ref)
    _close(pt.grad.numpy(), gt)
    _close(np.zeros_like(vis) if pv.grad is None else pv.grad.numpy(), gv)


@pytest.mark.parametrize("direction", ["t2i", "i2t", "bidir"])
@pytest.mark.parametrize("cost_style", ["sum", "mean"])
@pytest.mark.parametrize("max_violation", [True, False])
def test_triplet_losses_match_laff_tpu(direction, cost_style, max_violation):
    kw = dict(margin=0.2, direction=direction, max_violation=max_violation,
              cost_style=cost_style)
    txt, vis = _embs(1, (8, 4, 16))
    _value_and_grads(lambda t, v: port_losses.triplet_loss_multi_space(t, v, **kw),
                     lambda t, v: jax_losses.triplet_loss_multi_space(t, v, **kw), txt, vis)
    _value_and_grads(lambda t, v: port_losses.triplet_loss(t, v, **kw),
                     lambda t, v: jax_losses.triplet_loss(t, v, **kw), txt[:, 0], vis[:, 0])
    scores = np.random.default_rng(2).uniform(-1, 1, (8, 8)).astype(np.float32)
    _value_and_grads(lambda s, _: port_losses.triplet_loss_from_scores(s, **kw),
                     lambda s, _: jax_losses.triplet_loss_from_scores(s, **kw),
                     scores, scores)


@pytest.mark.parametrize("loss", ["mrl", "dsl", "CELoss"])
@pytest.mark.parametrize("multi_space", [True, False])
def test_loss_fn_matches_laff_tpu(loss, multi_space):
    """make_loss_fn: one criterion per head summed (multi_space), else the
    criterion on the head-mean score matrix."""
    spec = types.SimpleNamespace(loss=loss, multi_space=multi_space, measure="cosine",
                                 margin=0.2, direction="t2i", max_violation=True,
                                 cost_style="sum")
    txt, vis = _embs(3, (8, 4, 16))
    _value_and_grads(port_trainer.make_loss_fn(spec), jax_trainer.make_loss_fn(spec),
                     txt, vis)
    txt, vis = _embs(4, (8, 16))  # single-head embeddings
    _value_and_grads(port_trainer.make_loss_fn(spec), jax_trainer.make_loss_fn(spec),
                     txt, vis)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
@pytest.mark.parametrize("clip_triggered", [True, False])
def test_optimizer_matches_optax_chain(kind, clip_triggered):
    """Four updates against laff_tpu's optax chain (global-norm clip at 2,
    then adam eps 1e-4 or rmsprop), the LR changed between steps. The third
    step's gradients hold a NaN: the port must keep the parameters, the
    moments and the count (laff_tpu's bf16 skip); the chain skips it too."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scale = 10.0 if clip_triggered else 0.01
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    grads[2]["a"][1, 2] = np.nan
    lrs = [1e-2, 1e-2, 5e-3, 5e-3]

    config = types.SimpleNamespace(optimizer=kind, lr=lrs[0], grad_clip=2)
    tx = jax_trainer.make_optimizer(config)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)

    tparams = [torch.nn.Parameter(torch.tensor(params[k])) for k in shapes]
    opt = OptaxChain(tparams, kind, lrs[0], grad_clip=2, skip_nonfinite=True)
    sizes = [p.numel() for p in tparams]
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        if i != 2:
            assert (norm >= 2) == clip_triggered
        opt.set_learning_rate(lr)
        opt.zero_grad()
        for p, k in zip(tparams, shapes):
            p.grad.copy_(torch.tensor(g[k]))
        before = [p.detach().clone() for p in tparams], opt.nu.clone(), opt.count.clone()
        opt.step()
        if i == 2:  # non-finite: nothing moves
            for p, b in zip(tparams, before[0]):
                assert torch.equal(p.detach(), b)
            assert torch.equal(opt.nu, before[1]) and torch.equal(opt.count, before[2])
            continue
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, k in zip(tparams, shapes):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7)
    inner = state.inner_state[1][0]  # the scale_by_adam / scale_by_rms state
    moments = {"nu": inner.nu} if kind == "rmsprop" else {"nu": inner.nu, "mu": inner.mu}
    for name, ref in moments.items():
        for got, k in zip(getattr(opt, name).split(sizes), shapes):
            np.testing.assert_allclose(got.view(shapes[k]).numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-9)
    if kind == "adam":
        assert int(opt.count) == int(inner.count) == 3


def test_optimizer_state_round_trips():
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = OptaxChain(p, "adam", 1e-3, grad_clip=2)
    p[0].grad.fill_(0.5)
    opt.step()
    state = opt.state_dict()
    q = [torch.nn.Parameter(torch.ones(3))]
    other = OptaxChain(q, "adam", 1.0, grad_clip=2)
    other.load_state_dict(state)
    assert torch.equal(other.mu, opt.mu) and torch.equal(other.nu, opt.nu)
    assert int(other.count) == 1 and float(other.lr) == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="rmsprop"):
        OptaxChain([torch.nn.Parameter(torch.ones(3))], "rmsprop", 1.0).load_state_dict(state)


# ---------------------------------------------------------------------------
# BatchNorm, noise, the gate rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_transformnet_training_batchnorm_matches_flax(bf16):
    """Three training-mode forwards: outputs and running statistics as
    flax's (biased batch variance, momentum 0.9). nn.BatchNorm1d's own
    update (unbiased variance) would be off by the B/(B-1) factor."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((16, 12)).astype(np.float32) for _ in range(3)]
    dtype = jnp.bfloat16 if bf16 else None
    flax_net = FlaxTransformNet(dim_out=8, dropout=0.0, batch_norm=True, dtype=dtype)
    variables = flax_net.init(jax.random.key(0), jnp.asarray(xs[0]))
    params, stats = variables["params"], variables["batch_stats"]
    net = TransformNet(12, 8, dropout=0.0, batch_norm=True,
                       compute_dtype=torch.bfloat16 if bf16 else None)
    net.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                                           jax.tree_util.tree_map(np.asarray, stats)))
    net.train()
    out_tol, stat_tol = (2e-2, 2e-3) if bf16 else (1e-5, 1e-6)
    for x in xs:
        ref, upd = flax_net.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        np.testing.assert_allclose(net(torch.tensor(x)).detach().numpy(), np.asarray(ref),
                                   atol=out_tol)
    np.testing.assert_allclose(net.bn1.running_mean.numpy(), np.asarray(stats["bn1"]["mean"]),
                               atol=stat_tol)
    np.testing.assert_allclose(net.bn1.running_var.numpy(), np.asarray(stats["bn1"]["var"]),
                               atol=stat_tol)
    if not bf16:  # the hazard: nn.BatchNorm1d blends in the unbiased variance
        fresh = TransformNet(12, 8, dropout=0.0, batch_norm=True).train()
        x = torch.tensor(xs[0])
        fresh(x)
        h = torch.tanh(fresh.fc1(x)).detach()
        torch.testing.assert_close(fresh.bn1.running_var,
                                   0.9 + 0.1 * h.var(0, unbiased=False), rtol=0, atol=1e-6)
        assert (fresh.bn1.running_var - (0.9 + 0.1 * h.var(0, unbiased=True))).abs().max() > 1e-4


def _tiny_model(with_ave=False):
    from laff_tpu_torch.models import LAFFModel
    from laff_tpu_torch.models.spec import AttentionSpec, GruSpec, LAFFSpec, TowerSpec

    att = AttentionSpec(heads=2, with_ave=with_ave)
    txt = TowerSpec(features=(("bow", 6),), common_dim=8, attention=att, batch_norm=True,
                    dropout=0.0, gru=GruSpec())
    vis = TowerSpec(features=(("f1", 5), ("f2", 3)), common_dim=8, attention=att,
                    batch_norm=True, dropout=0.0)
    model = LAFFModel(LAFFSpec(txt=txt, vis=vis))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def test_zero_visual_feature_batches_become_noise_in_training():
    """A visual feature batch that is zero everywhere reaches its transform
    as standard normal noise from the generator, in training only; other
    batches and the text tower pass unchanged."""
    model = _tiny_model().train()
    vis = {"f1": torch.zeros(8, 5), "f2": torch.randn(8, 3, generator=torch.Generator()
                                                       .manual_seed(1))}
    txt = {"bow": torch.zeros(8, 6)}
    seen = {}
    for name in ("transform_f1", "transform_f2"):
        getattr(model.vis_net, name).register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args[0].clone()))
    model.txt_net.transform_bow.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("bow", args[0].clone()))

    def run(seed):
        model(txt, vis, torch.Generator().manual_seed(seed))
        return {k: v.clone() for k, v in seen.items()}

    a, b, c = run(3), run(3), run(4)
    assert float(a["transform_f1"].std()) > 0.5  # noise, not zeros
    assert torch.equal(a["transform_f1"], b["transform_f1"])  # from the generator
    assert not torch.equal(a["transform_f1"], c["transform_f1"])
    assert torch.equal(a["transform_f2"], vis["f2"])  # a non-zero batch is kept
    assert torch.equal(a["bow"], txt["bow"])  # no noise on the text side
    model.eval()
    with torch.no_grad():
        model.encode_vis(vis)
    assert torch.equal(seen["transform_f1"], vis["f1"])  # none in eval


def test_gate_kernel_only_without_grad():
    """The forward-only gate kernel serves a card tensor with grad off; with
    grad on (the train step) the module takes the plain path."""
    module = MultiHeadGateAttention(8, 2, with_ave=False)
    on_card = types.SimpleNamespace(is_cuda=True)
    assert module._kernel_applies(on_card, None, None) is False
    with torch.no_grad():
        assert module._kernel_applies(on_card, None, None) is True
        assert module._kernel_applies(types.SimpleNamespace(is_cuda=False), None, None) is False


# ---------------------------------------------------------------------------
# feed, checkpoint helpers
# ---------------------------------------------------------------------------

def test_pair_feed_batches_equal_laff_tpu(world, monkeypatch):
    """Both packages see the same batches in the same order, each epoch."""
    _port_config(monkeypatch)
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _small(jax_rehearsal.config()))
    jp = jax_prepare.prepare(JOptions(model_prefix="feed_j", **_base(world)))
    pp = port_prepare.prepare(port_prepare.Options(model_prefix="feed_p", device="cpu",
                                                   **_base(world)))
    assert pp.train_feed.steps_per_epoch() == jp.train_feed.steps_per_epoch() == 4
    for epoch in (0, 1):
        for jb, pb in zip(jp.train_feed.epoch(epoch), pp.train_feed.epoch(epoch)):
            assert pb["cap_ids"] == jb["cap_ids"] and pb["vis_ids"] == jb["vis_ids"]
            for side in ("txt", "vis"):
                assert set(pb[side]) == set(jb[side])
                for k in pb[side]:
                    np.testing.assert_array_equal(pb[side][k], jb[side][k])


def test_average_states_matches_laff_tpu():
    from laff_tpu.engine.checkpoint import average_states as jax_average

    rng = np.random.default_rng(0)
    states = [{"w": rng.standard_normal((3, 2)).astype(np.float32)} for _ in range(3)]
    ours = average_states([{k: torch.tensor(v) for k, v in s.items()} for s in states])
    np.testing.assert_array_equal(ours["w"].numpy(), np.asarray(jax_average(states)["w"]))


# ---------------------------------------------------------------------------
# the trainer end to end against laff_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,with_ave", [("adam", False), ("rmsprop", True)])
def test_trainer_matches_laff_tpu(world, monkeypatch, tmp_path, optimizer, with_ave):
    """Two epochs of laff_tpu.engine.trainer.main and of the port's main from
    the same init, dropout off: each epoch's loss (within 1e-4), LR and
    validation metrics (equal), and the best checkpoint's parameters, BN
    statistics and annealed global_emb_weight (within PARAM_ATOL)."""
    variant = dict(optimizer=optimizer, with_ave=with_ave)
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _small(jax_rehearsal.config(), **variant))
    _port_config(monkeypatch, **variant)
    base = _base(world, num_epochs=2)
    jopt = JOptions(model_prefix=f"jax_{optimizer}", **base)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep)

    popt = port_prepare.Options(model_prefix=f"port_{optimizer}", device="cpu", **base)
    pprep = port_prepare.prepare(popt)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)

    assert len(jres["history"]) == len(pres["history"]) == 2
    for je, pe in zip(jres["history"], pres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=EPOCH_LOSS_RTOL)
        assert pe["lr"] == je["lr"]
        for k in port_trainer.METRICS:
            assert pe[k] == je[k], (k, pe, je)
    assert pres["best_perf"] == jres["best_perf"]

    jck = jax_load(os.path.join(jres["model_path"], "model_best.pth.tar"))
    pck = load_checkpoint(os.path.join(pres["model_path"], "model_best.pth.tar"))
    assert pck["epoch"] == jck["epoch"]
    ref = from_jax_variables(jck["params"], jck["batch_stats"], jck["schedule"])
    got = pck["state_dict"]
    assert set(got) == set(ref)
    for k in ref:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL,
                                       err_msg=k)
    weights = [k for k in got if k.endswith("global_emb_weight")]
    assert len(weights) == (2 if with_ave else 0)
    for k in weights:  # annealed at the start of each epoch: 1 -> 0.8 -> 0.6
        expect = 1.0 + pck["epoch"] * (0.8 - 1.0)
        assert float(got[k]) == pytest.approx(expect) == float(ref[k])


# ---------------------------------------------------------------------------
# the CLI, resume, options, no card
# ---------------------------------------------------------------------------

def _cli(root, prefix, *extra):
    return ["toytrain", "toyval", "--rootpath", root, "--val_set", "no", "--config_name",
            "rehearsal", "--batch_size", "16", "--device", "cpu", "--model_prefix", prefix,
            *extra]


def test_cli_trains_on_cpu_and_predictor_scores_the_checkpoint(world, monkeypatch):
    _port_config(monkeypatch, dropout=0.2)
    assert do_trainer.main(_cli(world, "cli", "--num_epochs", "2")) == 0
    opt = do_trainer.parse_args(_cli(world, "cli"))
    model_dir = port_prepare.model_dir_for(opt)
    for name in ("model_best.pth.tar", "val_perf_hist.txt", "val_perf.txt", "scalars.tsv"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    assert not os.path.exists(os.path.join(model_dir, "model_temp_best.pth.tar"))
    best = os.path.join(model_dir, "model_best.pth.tar")
    ckpt = load_checkpoint(best)
    popt = port_predictor.PredictOptions(
        testCollection=VAL, model_path=best, sim_name="trained", rootpath=world,
        query_sets=f"{VAL}.caption.txt", overwrite=1, device="cpu",
        predict_result_file=os.path.join(world, "result_log", "trained.txt"))
    res = port_predictor.main(popt)[f"{VAL}.caption.txt"]
    # the predictor ranks the validation set as the trainer's validate did
    assert res["t2v"][5] == pytest.approx(ckpt["best_perf"], rel=0, abs=1e-12)
    tags = {line.split("\t")[1] for line in open(os.path.join(model_dir, "scalars.tsv"))}
    assert {"train/Loss", "train/learning_rate", "val/mir"} <= tags


def test_resume_gives_the_uninterrupted_result(world, monkeypatch):
    """Three epochs straight against two epochs, then a resumed third (the
    optimizer state, LR controller and counters from model_resume.pth.tar),
    with dropout on: the same best checkpoint, bit for bit."""
    _port_config(monkeypatch, dropout=0.2, optimizer="rmsprop", with_ave=True)
    base = _base(world, device="cpu")
    a = port_trainer.main(port_prepare.Options(num_epochs=3, model_prefix="resA", **base))
    opt_b = port_prepare.Options(num_epochs=2, model_prefix="resB", resume=1, **base)
    port_trainer.main(opt_b)
    b = port_trainer.main(dataclasses.replace(opt_b, num_epochs=3))
    assert [e["loss"] for e in b["history"]] == [e["loss"] for e in a["history"][2:]]
    assert b["best_perf"] == a["best_perf"]
    ca = load_checkpoint(os.path.join(a["model_path"], "model_best.pth.tar"))
    cb = load_checkpoint(os.path.join(b["model_path"], "model_best.pth.tar"))
    assert ca["epoch"] == cb["epoch"]
    for k, v in ca["state_dict"].items():
        assert torch.equal(v, cb["state_dict"][k]), k


@pytest.mark.parametrize("option,value", [("data_parallel", 4)])
def test_options_not_ported_raise(world, monkeypatch, option, value):
    """data_parallel, which raised over several cards until the port ran it,
    now launches min(N, cards) ranks of ``main`` (the launcher patched here;
    tests/test_torch_port_parallel.py runs them); a prepared run cannot be
    handed to the ranks, which prepare their own, and raises."""
    monkeypatch.setattr(port_prepare, "visible_devices", lambda device: 2)
    calls = []
    monkeypatch.setattr(port_trainer, "launch",
                        lambda n, target, opt, device: calls.append((n, opt)) or {})
    opt = port_prepare.Options(device="cpu", **_base(world), **{option: value})
    assert port_trainer.main(opt) == {"model": None}
    assert calls == [(2, opt)]
    with pytest.raises(ValueError, match="prepares in each rank"):
        port_trainer.main(opt, prepared=object())


DISPATCH_OPTIONS = ("steps_per_dispatch", "device_feature_cache", "device_text_cache",
                    "device_text_featurize", "stage_val_features")


@pytest.mark.parametrize("where", ["Options", "cli"])
@pytest.mark.parametrize("option", DISPATCH_OPTIONS)
def test_dispatch_defaults_equal_laff_tpu(option, where):
    """The port's Options and its CLI default every dispatch option as
    laff_tpu's Options and CLI do."""
    from laff_tpu.cli import do_trainer as jax_cli

    if where == "Options":
        got, ref = port_prepare.Options(), JOptions()
    else:
        got, ref = do_trainer.parse_args(["a", "b"]), jax_cli.parse_args(["a", "b"])
    assert getattr(got, option) == getattr(ref, option)


@pytest.mark.parametrize("change", [
    {"model_name": "End2EndClip"},
    {"text_encoding": dict(port_rehearsal.config.text_encoding,
                           bert_encoding={"name": "bert-base-uncased"}),
     "bert_vocab_file": "<vocab.txt>"}])
def test_config_features_not_ported_raise(world, monkeypatch, tmp_path, change):
    """An End2EndClip config (ported: engine.end2end) is sent there by the
    LAFF trainer; a BERT text tower (ported) prepares: an in-graph BERT-base
    spec, its tokenizer in the feed (the vocabulary from the config's
    bert_vocab_file, no checkout), its token arrays in a batch."""
    change = dict(change)
    if "bert_vocab_file" in change:
        words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "dog"]
        change["bert_vocab_file"] = str(tmp_path / "vocab.txt")
        (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")

    def load(name, parm="None"):
        config = _small(port_rehearsal.config())
        for k, v in change.items():
            setattr(config, k, v)
        return config

    monkeypatch.setattr(port_prepare, "load_config", load)
    opt = port_prepare.Options(device="cpu", **_base(world))
    if "model_name" in change:
        with pytest.raises(ValueError, match="engine.end2end.main"):
            port_prepare.prepare(opt)
        return
    prepared = port_prepare.prepare(opt)
    bert = prepared.spec.txt.bert
    assert bert is not None and bert.max_length == 64 and bert.config_kwargs == ()
    assert dict(prepared.spec.txt.features)["bert"] == 768
    batch = next(iter(prepared.train_feed.epoch(0)))["txt"]
    assert batch["bert_ids"].shape == (16, 64) and batch["bert_ids"].dtype == np.int32


def test_trainer_needs_a_card_unless_told_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = do_trainer.parse_args(_cli(world, "nocard")[:-4])  # without --device cpu
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_trainer.main(opt)
