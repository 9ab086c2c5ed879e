"""The BERT text tower on the CPU, held against laff_tpu and transformers:

* ``models.bert.BertModel`` against transformers' ``FlaxBertModule`` (what
  ``laff_tpu`` builds) with the tiny config's ``bert_config_kwargs``, on
  seeded padded batches, the flax init carried by ``engine.weights``: the
  pooler output and the last hidden state within 1e-5;
* ``WordPieceTokenizer`` against transformers' ``BertTokenizer`` on captions
  with punctuation, accents, CJK characters, control characters, unknown
  and over-long words, truncated: equal ids and masks;
* a checkout written from a seeded transformers BERT (``save_pretrained``
  as safetensors and as ``pytorch_model.bin``, with the flax weights saved
  beside them): ``laff_tpu``'s ``import_bert_params`` and the port's give
  equal pooler outputs, and so do the two frozen ``LiveBertTextFeaturizer``;
  a directory with neither file raises, a name that is no directory gives
  None;
* the backbone update ratio 1/20 (``tests/test_bert_live.py::
  test_backbone_lr_scaling``) in both optimizers;
* ``tiny_bert`` (dropout off): the first step's loss and gradients against
  ``laff_tpu``'s from the same weights; two epochs of the port's
  ``do_trainer`` CLI against ``laff_tpu.engine.trainer.main`` from the same
  init (losses, metrics, parameters), then both predictors on the trained
  checkpoints (equal metrics) and the text embeddings of the test captions;
* a reference checkpoint with precomputed BERT rows: ``convert_state_dict``
  imports its ``transform_bert`` as ``laff_tpu``'s does.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny_bert as jax_tiny_bert
from laff_tpu.data.synth import WORDS, build_collection, build_w2v
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import load_checkpoint as jax_load
from laff_tpu.engine.predictor import PredictOptions as JPredictOptions
from laff_tpu.engine.predictor import main as jax_predict
from laff_tpu.engine.torch_import import convert_state_dict as jax_convert
from laff_tpu.models import LAFFModel as JModel
from laff_tpu.models import bert as jax_bert
from laff_tpu.models.spec import BertSpec as JBertSpec
from laff_tpu.models.spec import TransformSpec as JTransformSpec
from laff_tpu_torch.cli import do_predictor, do_trainer
from laff_tpu_torch.configs import tiny_bert as port_tiny_bert
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, load_checkpoint, save_checkpoint
from laff_tpu_torch.engine.optim import make_optimizer
from laff_tpu_torch.engine.torch_import import convert_state_dict
from laff_tpu_torch.engine.weights import _flatten, bert_param_name, from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.models import bert as port_bert
from laff_tpu_torch.models.spec import spec_from_dict
from test_torch_import import reference_style_state_dict, small_spec

transformers = pytest.importorskip("transformers")

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TOL = 1e-5
TINY = dict(jax_tiny_bert.config.bert_config_kwargs)
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PIECES = ["the", "a", "on", "in", "##s", "##ing", "##ed", "un", "##know", "##n", "cafe",
          "resume", "naive", ",", ".", "!", "?", "'", "-", "(", ")", "中", "文"]


def write_vocab(path, size=64):
    words = SPECIALS + WORDS + PIECES
    words += [f"unused{i}" for i in range(size - len(words))]
    with open(path, "w") as fh:
        fh.write("\n".join(words) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("bert_vocab") / "vocab.txt")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _bert_state_dict(params):
    """A flax BERT tree -> the port's BertModel state dict."""
    out = {}
    for path, value in _flatten(_host(params)):
        key, value = bert_param_name(path, value)
        out[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))
    return out


def _tokens(rng, b=4, length=9, vocab_size=64):
    ids = rng.integers(5, vocab_size, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    for row, n in enumerate([length, 6, 3, 1][:b]):
        mask[row, n:] = 0
        ids[row, n:] = 0
    types = (rng.random((b, length)) < 0.3).astype(np.int32)
    return ids, mask, types


@pytest.mark.parametrize("with_types", [False, True])
def test_bert_model_matches_flax(with_types):
    from transformers import BertConfig
    from transformers.models.bert.modeling_flax_bert import FlaxBertModule

    rng = np.random.default_rng(0)
    ids, mask, types = _tokens(rng)
    kw = dict(TINY, num_hidden_layers=2)
    flax = FlaxBertModule(config=BertConfig(**kw))
    variables = flax.init(jax.random.key(1), jnp.asarray(ids), jnp.asarray(mask))
    out = flax.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                     token_type_ids=jnp.asarray(types) if with_types else None,
                     deterministic=True)
    model = port_bert.BertModel(port_bert.BertConfig.from_kwargs(kw))
    model.load_state_dict(_bert_state_dict(variables["params"]))
    with torch.no_grad():
        hidden, pooled = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask),
                                      torch.from_numpy(types) if with_types else None)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(out.last_hidden_state), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(out.pooler_output), atol=TOL, rtol=0)
    # training mode draws its dropout from the generator passed, and only there
    model.train()
    gen = torch.Generator().manual_seed(3)
    default = torch.random.get_rng_state()
    a = model(torch.from_numpy(ids), torch.from_numpy(mask), generator=gen)[1]
    b = model(torch.from_numpy(ids), torch.from_numpy(mask),
              generator=torch.Generator().manual_seed(3))[1]
    assert torch.equal(a, b) and not torch.allclose(a, pooled)
    assert torch.equal(torch.random.get_rng_state(), default)


CAPTIONS = [
    "A dog runs in the park!",
    "the cat's ball, red and BLUE (big)...",
    "Café résumé naïve runs",
    "unknown dogs sitting on tables",
    "zzqx " + "x" * 101 + " dog",
    "中文 man中woman",
    "tab\there\x00 ctrl\x07 man woman",
    "   ",
    "man woman car ball runs jumps sits eats red blue big small park road water table dog cat",
    "a-b?c!d",
]


@pytest.mark.parametrize("max_length", [16, 6])
def test_tokenizer_matches_bert_tokenizer(vocab, max_length):
    from transformers import BertTokenizer

    ref = BertTokenizer(vocab_file=vocab, do_lower_case=True)
    enc = ref(CAPTIONS, return_tensors="np", padding="max_length", truncation=True,
              max_length=max_length)
    out = port_bert.BertTokensFeaturizer("unused-name", max_length=max_length,
                                         vocab_file=vocab).encode_tokens(CAPTIONS)
    np.testing.assert_array_equal(out["bert_ids"], enc["input_ids"])
    np.testing.assert_array_equal(out["bert_mask"], enc["attention_mask"])
    np.testing.assert_array_equal(out["bert_type"], enc["token_type_ids"])
    assert {v.dtype for v in out.values()} == {np.dtype(np.int32)}
    # laff_tpu's featurizer gives the same arrays
    theirs = jax_bert.BertTokensFeaturizer("unused-name", max_length=max_length,
                                           vocab_file=vocab).encode_tokens(CAPTIONS)
    for k in theirs:
        np.testing.assert_array_equal(out[k], theirs[k])


def test_tokenizer_needs_a_local_vocabulary(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        port_bert.BertTokensFeaturizer("bert-base-uncased")
    write_vocab(tmp_path / "vocab.txt")
    feats = port_bert.BertTokensFeaturizer(str(tmp_path), max_length=8)
    assert feats.encode_tokens(["dog runs"])["bert_mask"][0].sum() == 4


def write_checkout(path, safe=True, **kw):
    """A seeded transformers BERT saved as the port reads it (safetensors or
    pytorch_model.bin), its flax weights and its vocab.txt beside it."""
    from transformers import BertConfig, BertModel, FlaxBertModel

    torch.manual_seed(7)
    BertModel(BertConfig(**{**TINY, **kw})).save_pretrained(path, safe_serialization=safe)
    FlaxBertModel.from_pretrained(path, from_pt=True).save_pretrained(path)
    write_vocab(os.path.join(path, "vocab.txt"))
    expect = "model.safetensors" if safe else "pytorch_model.bin"
    assert expect in os.listdir(path) and "flax_model.msgpack" in os.listdir(path)
    return path


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def checkout(request, tmp_path_factory):
    return write_checkout(str(tmp_path_factory.mktemp(f"checkout_{request.param}")),
                          safe=request.param == "safetensors")


def test_checkout_loads_to_laff_tpu_outputs(checkout):
    from transformers import BertConfig
    from transformers.models.bert.modeling_flax_bert import FlaxBertModule

    rng = np.random.default_rng(2)
    ids, mask, _ = _tokens(rng)
    params = jax_bert.import_bert_params(checkout)
    ref = FlaxBertModule(config=BertConfig(**TINY)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), deterministic=True)
    sd = port_bert.import_bert_params(checkout)
    model = port_bert.BertModel(port_bert.checkout_config(checkout))
    model.load_state_dict(sd)
    with torch.no_grad():
        _, pooled = model.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref.pooler_output), atol=TOL, rtol=0)
    # the frozen live featurizers of both packages give the same rows
    ours = port_bert.LiveBertTextFeaturizer(checkout, max_length=16, device="cpu")
    theirs = jax_bert.LiveBertTextFeaturizer(checkout, max_length=16)
    np.testing.assert_allclose(ours.encode_batch(CAPTIONS).numpy(),
                               theirs.encode_batch(CAPTIONS), atol=TOL, rtol=0)
    assert ours.rows == len(CAPTIONS)


def test_checkout_names_that_import_nothing_or_raise(tmp_path):
    assert port_bert.import_bert_params("bert-base-uncased") is None
    assert jax_bert.import_bert_params("bert-base-uncased") is None
    with pytest.raises(FileNotFoundError, match="neither"):
        port_bert.import_bert_params(str(tmp_path))


def test_backbone_lr_scaling():
    """BERT-subtree updates come out 1/20 of an identical non-backbone
    parameter's update, in the port's chain as in laff_tpu's."""
    class Cfg:
        grad_clip = 0
        optimizer = "adam"
        lr = 1e-3

    class Spec:
        class txt:  # noqa: N801
            bert = JBertSpec()

    params = {"txt_net": {"bert": {"w": jnp.ones((4,))}, "transform_bow": {"w": jnp.ones((4,))}}}
    tx = jax_trainer.make_optimizer(Cfg(), Spec())
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.ones_like, params), tx.init(params),
                           params)
    ref = np.asarray(updates["txt_net"]["bert"]["w"] / updates["txt_net"]["transform_bow"]["w"])

    model = torch.nn.Module()
    model.txt_net = torch.nn.Module()
    model.txt_net.transform_bow = torch.nn.Linear(2, 2)
    model.txt_net.bert = torch.nn.Linear(2, 2)
    model.vis_net = torch.nn.Linear(2, 2)
    with torch.no_grad():  # from zero, the parameters after the step are the updates
        for p in model.parameters():
            p.zero_()
    opt = make_optimizer(Cfg(), model)
    opt.grad.fill_(1.0)
    opt.step()
    moved = {k: v.detach() for k, v in model.named_parameters()}
    ratio = moved["txt_net.bert.weight"] / moved["txt_net.transform_bow.weight"]
    np.testing.assert_allclose(ratio.numpy(), 1.0 / 20.0, rtol=1e-6)
    np.testing.assert_allclose(ref, 1.0 / 20.0, rtol=1e-6)
    assert torch.equal(moved["vis_net.weight"], moved["txt_net.transform_bow.weight"])


# ---------------------------------------------------------------------------
# tiny_bert end to end
# ---------------------------------------------------------------------------

TRAIN, VAL, TEST = "btrain", "bval", "btest"
NO_DROPOUT = dict(TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _no_dropout(config, batch_norm=True):
    config.dropout = 0.0
    config.bert_config_kwargs = dict(NO_DROPOUT)
    config.batch_norm = config.bert_transform_batch_norm = batch_norm
    return config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bert_world"))
    build_collection(root, TRAIN, n_videos=24, caps_per_video=2, seed=0)
    build_collection(root, VAL, n_videos=12, caps_per_video=1, seed=5)
    build_collection(root, TEST, n_videos=12, caps_per_video=2, seed=9)
    build_w2v(root)
    return root


def _tiny_configs(world, vocab, monkeypatch, batch_norm=True):
    monkeypatch.setenv("LAFF_TPU_TEST_BERT_VOCAB", vocab)
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _no_dropout(jax_tiny_bert.config(), batch_norm))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _no_dropout(port_tiny_bert.config(),
                                                              batch_norm))
    return world


def _base(root, **kw):
    return dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                config_name="tiny_bert", batch_size=12, **kw)


def _init(root, prefix):
    """laff_tpu's prepared run and initial state, and the port's prepared
    run with the same weights in an init checkpoint."""
    jopt = JOptions(model_prefix=f"jax_{prefix}", num_epochs=2, **_base(root))
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(JModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    popt = port_prepare.Options(model_prefix=f"port_{prefix}", device="cpu", num_epochs=2,
                                **_base(root))
    pprep = port_prepare.prepare(popt)
    sd = from_jax_variables(_host(init.params), _host(init.batch_stats), _host(init.schedule))
    return jopt, jprep, init, popt, pprep, sd


def test_tiny_bert_first_step_matches_laff_tpu(world, vocab, monkeypatch):
    """BatchNorm off: this world's features saturate the transforms' tanh,
    and BatchNorm's training forward then divides by a batch variance of
    about 3e-5, which flax takes as E[x^2] - E[x]^2 and torch in another
    way: a difference of 1e-7 comes out near 1e-5, in every tower."""
    jopt, jprep, init, popt, pprep, sd = _init(
        _tiny_configs(world, vocab, monkeypatch, batch_norm=False), "step")
    assert pprep.spec.txt.bert is not None and dict(pprep.spec.txt.bert.config_kwargs) == \
        dict(jprep.spec.txt.bert.config_kwargs)
    jbatch = next(iter(jprep.train_feed.epoch(0)))
    pbatch = next(iter(pprep.train_feed.epoch(0)))
    assert jbatch["cap_ids"] == pbatch["cap_ids"]
    for k, v in jbatch["txt"].items():
        np.testing.assert_array_equal(pbatch["txt"][k], v, err_msg=k)
    assert {"bert_ids", "bert_mask", "bert_type"} <= set(pbatch["txt"])

    jmodel = JModel(jprep.spec)
    loss_fn = jax_trainer.make_loss_fn(jprep.spec)

    def jloss(params):
        (t, v), _ = jmodel.apply({"params": params, "batch_stats": init.batch_stats},
                                 {k: jnp.asarray(x) for k, x in jbatch["txt"].items()},
                                 {k: jnp.asarray(x) for k, x in jbatch["vis"].items()},
                                 train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
        return loss_fn(t, v)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(init.params)
    model = LAFFModel(pprep.spec)
    model.load_state_dict(sd)
    optimizer = make_optimizer(pprep.config, model)
    step = port_trainer.TrainStep(model, optimizer, pprep.spec)
    loss = step.loss({k: torch.from_numpy(v) for k, v in pbatch["txt"].items()},
                     {k: torch.from_numpy(v) for k, v in pbatch["vis"].items()},
                     torch.Generator())
    loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=TOL)
    ref = from_jax_variables(_host(ref_grads))
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    grads = dict(model.named_parameters())
    assert any(k.startswith("txt_net.bert.") for k in grads)
    for k, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), atol=TOL * scale, err_msg=k)
    # BERT's parameters are the chain's only scaled run of the flat buffers
    sizes = [p.numel() for p in optimizer.params]
    names = [k for k, _ in model.named_parameters()]
    bert = [i for i, k in enumerate(names) if k.startswith("txt_net.bert.")]
    start = sum(sizes[:bert[0]])
    assert optimizer.scaled_segments == [(start, start + sum(sizes[i] for i in bert))]


def test_tiny_bert_trains_and_predicts_through_the_clis(world, vocab, monkeypatch, tmp_path):
    """BatchNorm off, as in the first step's test."""
    root = _tiny_configs(world, vocab, monkeypatch, batch_norm=False)
    jopt, jprep, init, popt, pprep, sd = _init(root, "cli")
    jres = jax_trainer.main(jopt, prepared=jprep)
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(sd, pprep.spec, pprep.config, pprep.featurizers, {}),
                    init_path)
    argv = [TRAIN, VAL, "--rootpath", root, "--val_set", "no", "--config_name", "tiny_bert",
            "--batch_size", "12", "--num_epochs", "2", "--device", "cpu", "--model_prefix",
            "port_cli", "--pretrained_file_path", init_path]
    assert do_trainer.main(argv) == 0
    model_dir = port_prepare.model_dir_for(do_trainer.parse_args(argv))
    for row in open(os.path.join(model_dir, "val_perf_hist.txt")).read().split("epoch_")[1:]:
        assert "Text2Video" in row
    pck = load_checkpoint(os.path.join(model_dir, "model_best.pth.tar"))
    jck = jax_load(os.path.join(jres["model_path"], "model_best.pth.tar"))
    assert pck["epoch"] == jck["epoch"] and pck["best_perf"] == pytest.approx(
        jres["best_perf"], abs=1e-9)
    ref = from_jax_variables(jck["params"], jck["batch_stats"], jck["schedule"])
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(pck["state_dict"][k].numpy(), v.numpy(), atol=TOL,
                                       err_msg=k)

    # both predictors on their trained checkpoints
    query = f"{TEST}.caption.txt"
    jres_p = jax_predict(JPredictOptions(
        testCollection=TEST, model_path=os.path.join(jres["model_path"], "model_best.pth.tar"),
        sim_name="jax_bert", rootpath=root, query_sets=query, batch_size=12,
        predict_result_file=os.path.join(root, "result_log", "jax_bert.txt")))[query]
    assert do_predictor.main([TEST, os.path.join(model_dir, "model_best.pth.tar"), "port_bert",
                              "--rootpath", root, "--query_sets", query, "--batch_size", "12",
                              "--device", "cpu", "--predict_result_file",
                              os.path.join(root, "result_log", "port_bert.txt")]) == 0
    rows = open(os.path.join(root, "result_log", "TextToVideo", "port_bert.txt")).read()
    jrows = open(os.path.join(root, "result_log", "TextToVideo", "jax_bert.txt")).read()
    assert rows.split("\t")[3:10] == jrows.split("\t")[3:10]
    assert [round(x, 3) for x in jres_p["t2v"]] == [float(x) for x in rows.split("\t")[3:10]]

    # the text embeddings of the test captions from the same trained weights
    from laff_tpu_torch.engine.predictor import rebuild_featurizers
    caps = [line.split(" ", 1)[1] for line in open(os.path.join(
        root, TEST, "TextData", query)).read().splitlines()]
    batch = rebuild_featurizers(pck, root, "cpu")["bert"].encode_tokens(caps)
    bow = pprep.featurizers["bow"].encode_batch(caps)
    txt = {**batch, "bow": bow}
    jt = JModel(jprep.spec).apply({"params": jck["params"], "batch_stats": jck["batch_stats"]},
                                  {k: jnp.asarray(v) for k, v in txt.items()},
                                  method=JModel.encode_txt)
    model = LAFFModel(pprep.spec)
    model.load_state_dict(pck["state_dict"])
    with torch.no_grad():
        pt = model.eval().encode_txt({k: torch.from_numpy(v) for k, v in txt.items()})
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=TOL, rtol=0)


def test_reference_checkpoint_with_precomputed_bert_rows():
    """A reference file whose config has precomputed BERT rows (no in-graph
    tower) imports its transform_bert as laff_tpu's importer does."""
    jspec = small_spec()
    bert = JTransformSpec(dim_in=12, dim_out=32, fc=True, activation="tanh", dropout=0.0,
                          batch_norm=True)
    jspec = dataclasses.replace(jspec, txt=dataclasses.replace(
        jspec.txt, features=jspec.txt.features + (("bert", 12),),
        transform_overrides=(("bert", bert),)))
    rng = np.random.default_rng(4)
    sd = reference_style_state_dict(rng)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa
    pre = "txt_net.transform_layer.bert_encoder_transform."
    sd[pre + "fc1.weight"], sd[pre + "fc1.bias"] = t(32, 12), t(32)
    sd[pre + "bn1.weight"], sd[pre + "bn1.bias"] = t(32).abs(), t(32)
    sd[pre + "bn1.running_mean"], sd[pre + "bn1.running_var"] = t(32), t(32).abs() + 0.5
    sd[pre + "bn1.num_batches_tracked"] = torch.tensor(2)
    spec = spec_from_dict(dataclasses.asdict(jspec))
    got = convert_state_dict(sd, spec)
    ref = from_jax_variables(*jax_convert(sd, jspec))
    assert "txt_net.transform_bert.fc1.weight" in got and set(got) == set(ref)
    for k in ref:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], ref[k].reshape(got[k].shape)), k
    model = LAFFModel(spec)
    model.load_state_dict(got)
    assert model.txt_net.bert is None


def test_frozen_bert_trains_as_laff_tpu(world, vocab, monkeypatch, tmp_path):
    """A frozen BERT of a local checkout (``bert_frozen=True``): its pooler
    rows, computed by ``LiveBertTextFeaturizer``, ride the feed and the text
    cache (as tensors, concatenated there) and train the towers as
    laff_tpu's trainer does from the same init: each epoch's loss within
    1e-4, the metrics equal. The checkout has 64 positions, since the frozen
    featurizer tokenizes to 64 in both packages."""
    path = write_checkout(str(tmp_path / "frozen"), max_position_embeddings=64)

    def frozen(config):
        config = _no_dropout(config, batch_norm=False)
        config.bert_frozen = True
        config.text_encoding = dict(config.text_encoding, bert_encoding={"name": path})
        return config

    monkeypatch.setattr(jax_prepare, "load_config", lambda name: frozen(jax_tiny_bert.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": frozen(port_tiny_bert.config()))
    jopt, jprep, init, popt, pprep, sd = _init(world, "frozen")
    assert isinstance(pprep.featurizers["bert"], port_bert.LiveBertTextFeaturizer)
    assert pprep.spec.txt.bert is None and "txt_net.bert.embeddings.word_embeddings.weight" \
        not in sd
    jres = jax_trainer.main(jopt, prepared=jprep)
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(sd, pprep.spec, pprep.config, pprep.featurizers, {}),
                    init_path)
    popt.pretrained_file_path = init_path
    pres = port_trainer.main(popt, prepared=pprep)
    assert pres["dispatch"]["txt_cache_bytes"] and pres["dispatch"]["steps_per_dispatch"] > 1
    for je, pe in zip(jres["history"], pres["history"], strict=True):
        assert pe["loss"] == pytest.approx(je["loss"], rel=1e-4)
        assert [pe[k] for k in port_trainer.METRICS] == [je[k] for k in port_trainer.METRICS]
