"""The single-space models on the CPU, held against laff_tpu on the same
inputs and weights (flax variables carried by ``from_jax_variables``):

* every remaining attention kind of the zoo (2, 3, 4, 5, 6, 10, 16, and
  11 under each output type), with and without a token mask, within 1e-5;
* NetVLAD and its token feed;
* whole towers: each zoo kind, 'concat' fusion, cross-tower tied
  transforms (a feature pair and the '__concat__' tie) and the NetVLAD
  text feature, eval embeddings and the training-mode loss with its
  gradients;
* the 'hist' measure: the similarity, the losses, the score matrix and the
  ranks;
* the registry, and dropout inside the zoo drawing from the caller's
  generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.data.feed import TextBatcher as JTextBatcher
from laff_tpu.engine import evaluator as jax_evaluator
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.models import attention as JA
from laff_tpu.models import spec as jspec_mod
from laff_tpu.models.laff import LAFFModel as JModel
from laff_tpu.ops.similarity import hist_sim as jax_hist_sim
from laff_tpu_torch.data.feed import TextBatcher
from laff_tpu_torch.engine import evaluator as port_evaluator
from laff_tpu_torch.engine import trainer as port_trainer
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import attention as PA
from laff_tpu_torch.models import registry
from laff_tpu_torch.models.clip import ClipTextConfig, ClipVisionConfig
from laff_tpu_torch.models.end2end_clip import End2EndClip
from laff_tpu_torch.models.laff import LAFFModel
from laff_tpu_torch.models.spec import spec_from_dict
from laff_tpu_torch.ops import hist_scores, hist_sim

TOL = 1e-5
B, L, D = 5, 4, 32
OUTPUT_TYPES = ("mean", "max", "first", "last", "cls_embedding", "concat", "max_embedding",
                "mean_embedding", "random", "second", "third", "Attention_1")
ZOO = [(k, None) for k in (2, 3, 4, 5, 6, 10, 16)] + [(11, ot) for ot in OUTPUT_TYPES]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _carry(variables):
    return from_jax_variables(_host(variables.get("params", {})),
                              _host(variables.get("batch_stats", {})),
                              _host(variables.get("schedule", {})))


def _attn_kwargs(kind, output_type=None):
    kw = dict(kind=JA.ATTENTION_TYPES[kind], heads=4, embed_dim_qkv=8, dropout=0.0)
    if output_type is not None:
        kw["output_type"] = output_type
    return kw


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind,output_type", ZOO, ids=[f"{k}-{o}" for k, o in ZOO])
def test_zoo_kind_matches_flax(kind, output_type, masked):
    rng = np.random.default_rng(kind)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[0, 2:] = 0
    mask[3, 1:] = 0
    m = mask if masked else None
    kw = _attn_kwargs(kind, output_type)
    flax_layer = JA.get_attention_layer(kw["kind"], L, jspec_mod.AttentionSpec(**kw))
    variables = flax_layer.init(jax.random.PRNGKey(kind), jnp.asarray(x))
    ref = np.asarray(flax_layer.apply(variables, jnp.asarray(x),
                                      mask=None if m is None else jnp.asarray(m)))
    layer = PA.get_attention_layer(kw["kind"], D, PA.AttentionSpec(**kw), L)
    layer.load_state_dict(_carry(variables))
    got = layer.eval()(torch.from_numpy(x),
                       mask=None if m is None else torch.from_numpy(m)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_netvlad_matches_flax(masked):
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((B, 6, 12)).astype(np.float32)
    mask = (rng.random((B, 6)) > 0.3).astype(np.float32) if masked else None
    flax_layer = JA.NetVLAD(num_clusters=4)
    variables = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    ref = np.asarray(flax_layer.apply(variables, jnp.asarray(tokens),
                                      None if mask is None else jnp.asarray(mask)))
    layer = PA.NetVLAD(12, 4)
    layer.load_state_dict(_carry(variables))
    got = layer(torch.from_numpy(tokens),
                None if mask is None else torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


class _Source:
    def __init__(self, captions):
        self.captions = captions

    def captions_for(self, cap_ids):
        return [self.captions[c] for c in cap_ids]


def test_netvlad_token_feed_equals_laff_tpu(tmp_path):
    """The port pads the per-token vectors to max_txtlength, laff_tpu to the
    batch's longest caption: the same tokens and mask, then zeros."""
    from laff_tpu.store import write_bigfile
    from laff_tpu.text.txt2vec import W2VecNSW as JW2Vec
    from laff_tpu_torch.text.txt2vec import W2VecNSW

    words = [f"w{i}" for i in range(10)]
    write_bigfile(str(tmp_path / "w2v"), words,
                  np.random.default_rng(3).standard_normal((10, 6)).astype(np.float32))
    caps = {"v#0": "w1 w2 the w3", "v#1": "w9", "v#2": "nothing known here", "v#3": "w4 " * 5}
    ids = list(caps)
    ref = JTextBatcher(_Source(caps), {"netvlad": JW2Vec(str(tmp_path / "w2v"))},
                       max_txtlength=8)(ids)
    got = TextBatcher(_Source(caps), {"netvlad": W2VecNSW(str(tmp_path / "w2v"))},
                      max_txtlength=8)(ids)
    t = ref["netvlad_tokens"].shape[1]
    assert got["netvlad_tokens"].shape == (4, 8, 6) and t <= 8
    np.testing.assert_array_equal(got["netvlad_tokens"][:, :t], ref["netvlad_tokens"])
    np.testing.assert_array_equal(got["netvlad_mask"][:, :t], ref["netvlad_mask"])
    assert not got["netvlad_tokens"][:, t:].any() and not got["netvlad_mask"][:, t:].any()


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

TXT = (("rnn", 8), ("bow", 20), ("w2v", 10))
VIS = (("clip_ft", 16), ("x3d", 12), ("w2v_like", 10))


def _spec(kind="Multi_head_MyApply_Attention", output_type="mean", tied=(), netvlad=False,
          vis=VIS, measure="cosine", multi_space=True):
    attn = jspec_mod.AttentionSpec(kind=kind, heads=4, with_ave=True, embed_dim_qkv=8,
                                   dropout=0.0, output_type=output_type)
    txt = TXT + ((("netvlad", 6 * 4),) if netvlad else ())
    return jspec_mod.LAFFSpec(
        txt=jspec_mod.TowerSpec(features=txt, common_dim=32, attention=attn, batch_norm=True,
                                dropout=0.0, netvlad_clusters=4,
                                gru=jspec_mod.GruSpec(vocab_size=30, we_dim=6, rnn_size=8)),
        vis=jspec_mod.TowerSpec(features=vis, common_dim=32, attention=attn, batch_norm=True,
                                dropout=0.0),
        tied_transforms=tied, measure=measure, multi_space=multi_space)


def _batches(rng, netvlad=False, vis=VIS, b=6):
    txt = {"rnn_ids": rng.integers(1, 30, (b, 5)).astype(np.int32),
           "rnn_len": np.array([5, 3, 4, 1, 2, 5][:b], np.int32),
           "bow": rng.standard_normal((b, 20)).astype(np.float32),
           "w2v": rng.standard_normal((b, 10)).astype(np.float32)}
    if netvlad:
        txt["netvlad_tokens"] = rng.standard_normal((b, 7, 6)).astype(np.float32)
        mask = np.ones((b, 7), np.float32)
        mask[1, 3:] = 0
        txt["netvlad_mask"] = mask
    vis = {n: rng.standard_normal((b, d)).astype(np.float32) for n, d in vis}
    return txt, vis


def _pair(jspec, netvlad=False, vis=VIS):
    """The flax model initialized, the port model carrying its variables,
    and a batch of each."""
    rng = np.random.default_rng(0)
    txt, vis_b = _batches(rng, netvlad, vis)
    jmodel = JModel(jspec)
    variables = jmodel.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                            {k: jnp.asarray(v) for k, v in txt.items()},
                            {k: jnp.asarray(v) for k, v in vis_b.items()})
    model = LAFFModel(spec_from_dict(dataclasses.asdict(jspec)))
    model.load_state_dict(_carry(variables))
    return jmodel, variables, model, txt, vis_b


TOWERS = {
    **{f"kind{k}": dict(kind=JA.ATTENTION_TYPES[k]) for k in (2, 4, 5, 6, 10, 11, 16)},
    "concat": dict(kind="concat"),
    "tied_pair": dict(tied=(("w2v", "w2v_like"),)),
    "tied_concat": dict(kind="concat", tied=(("__concat__", "__concat__"),),
                        vis=(("clip_ft", 16), ("x3d", 12), ("filler", 10))),
    "netvlad": dict(netvlad=True),
}


@pytest.mark.parametrize("name", list(TOWERS))
def test_towers_match_flax(name):
    """Eval embeddings, then the training-mode loss (BatchNorm on batch
    statistics, dropout off) and its gradients, against flax."""
    kw = dict(TOWERS[name])
    netvlad, vis = kw.pop("netvlad", False), kw.get("vis", VIS)
    jspec = _spec(netvlad=netvlad, **kw)
    jmodel, variables, model, txt, vis_b = _pair(jspec, netvlad, vis)
    jt, jv = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in txt.items()},
                          {k: jnp.asarray(v) for k, v in vis_b.items()})
    pt = {k: torch.from_numpy(v) for k, v in txt.items()}
    pv = {k: torch.from_numpy(v) for k, v in vis_b.items()}
    model.eval()
    with torch.no_grad():
        t, v = model(pt, pv)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL, rtol=0)

    jloss_fn = jax_trainer.make_loss_fn(jspec)

    def jloss(params):
        (a, b), _ = jmodel.apply({**variables, "params": params},
                                 {k: jnp.asarray(x) for k, x in txt.items()},
                                 {k: jnp.asarray(x) for k, x in vis_b.items()}, train=True,
                                 rngs={"dropout": jax.random.PRNGKey(3)},
                                 mutable=["batch_stats"])
        return jloss_fn(a, b)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(variables["params"])
    model.train()
    loss = port_trainer.make_loss_fn(model.spec)(*model(pt, pv, torch.Generator()))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=TOL, abs=TOL)
    ref = {k: v for k, v in from_jax_variables(_host(ref_grads)).items()
           if not k.endswith("num_batches_tracked")}
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref)
    scale = max(1.0, float(ref_loss))
    for k, g in grads.items():
        np.testing.assert_allclose(np.zeros(ref[k].shape) if g is None else g.numpy(),
                                   ref[k].numpy(), atol=TOL * scale, err_msg=k)


def test_tied_fc_is_owned_once_and_shared():
    model = LAFFModel(spec_from_dict(dataclasses.asdict(_spec(tied=(("w2v", "w2v_like"),)))))
    keys = [k for k in model.state_dict() if "fc1" in k or "tied" in k]
    assert "tied_fc_w2v_w2v_like.weight" in keys
    assert not any(k.startswith(("txt_net.transform_w2v.fc1", "vis_net.transform_w2v_like.fc1"))
                   for k in keys)
    shared = model.tied_fc_w2v_w2v_like
    assert model.txt_net.transform_w2v.shared_fc is shared is model.vis_net.transform_w2v_like.shared_fc
    assert sum(p is shared.weight for p in model.parameters()) == 1
    with pytest.raises(ValueError, match="dims do not match"):
        LAFFModel(spec_from_dict(dataclasses.asdict(_spec(
            kind="concat", tied=(("__concat__", "__concat__"),), vis=(("clip_ft", 16),)))))


@pytest.mark.parametrize("kind", [5, 11])
def test_zoo_dropout_draws_from_the_generator(kind):
    """Dropout inside the zoo draws only from the generator passed in: the
    same seed gives the same output, the default generator is untouched."""
    kw = dict(_attn_kwargs(kind), dropout=0.5)
    layer = PA.get_attention_layer(kw["kind"], D, PA.AttentionSpec(**kw), L).train()
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(B, L, D, generator=torch.Generator().manual_seed(1))
    state = torch.get_rng_state()
    a = layer(x, generator=torch.Generator().manual_seed(5))
    b = layer(x, generator=torch.Generator().manual_seed(5))
    c = layer(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_registry():
    spec = spec_from_dict(dataclasses.asdict(_spec(kind="concat")))
    assert isinstance(registry.get_model("W2VVPP", spec), LAFFModel)
    with pytest.raises(ValueError, match="concat fusion"):
        registry.get_model("W2VVPP", spec_from_dict(dataclasses.asdict(_spec())))
    tiny = dict(text_config=ClipTextConfig(vocab_size=100, context_length=8, width=16, heads=2,
                                           layers=1, embed_dim=8),
                vision_config=ClipVisionConfig(image_size=32, patch_size=16, width=16, heads=2,
                                               layers=1, embed_dim=8))
    assert isinstance(registry.get_model("End2EndClip", spec, **tiny), End2EndClip)
    with pytest.raises(KeyError):
        registry.get_model("nope", spec)
    assert registry.MODEL_NAMES == __import__("laff_tpu.models.registry",
                                              fromlist=["x"]).MODEL_NAMES


# ---------------------------------------------------------------------------
# the 'hist' measure
# ---------------------------------------------------------------------------

def test_hist_sim_matches_laff_tpu():
    rng = np.random.default_rng(2)
    a = np.abs(rng.standard_normal((7, 24))).astype(np.float32)
    b = rng.standard_normal((9, 24)).astype(np.float32)
    ref = np.asarray(jax_hist_sim(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(hist_sim(torch.from_numpy(a), torch.from_numpy(b)).numpy(), ref,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(hist_scores(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("heads", [1, 4])
def test_hist_scores_and_ranks_match_laff_tpu(heads):
    """The score matrix and the ranks, blocked over text rows, with exact
    duplicate videos (ties: the larger index first)."""
    rng = np.random.default_rng(heads)
    shape = (lambda n: (n, heads, 8)) if heads > 1 else (lambda n: (n, 32))
    txt = np.abs(rng.standard_normal(shape(40))).astype(np.float32)
    vis = np.abs(rng.standard_normal(shape(12))).astype(np.float32)
    vis[5] = vis[2]
    vis_ids = [f"v{i}" for i in range(12)]
    txt_ids = [f"v{i % 12}#{i // 12}" for i in range(40)]
    ref_scores = jax_evaluator.score_matrix(jnp.asarray(txt), jnp.asarray(vis), measure="hist")
    ref_ranks = jax_evaluator.t2v_ranks(jnp.asarray(txt), jnp.asarray(vis), txt_ids, vis_ids,
                                        measure="hist")
    t, v = torch.from_numpy(txt), torch.from_numpy(vis)
    np.testing.assert_allclose(port_evaluator.score_matrix(t, v, block=16, measure="hist"),
                               ref_scores, atol=TOL, rtol=0)
    for path in ("auto", "kernel"):  # 'hist' never takes the rank kernel
        ranks = port_evaluator.t2v_ranks(t, v, txt_ids, vis_ids, block=16, measure="hist",
                                         rank_path=path)
        np.testing.assert_array_equal(ranks, ref_ranks)
    assert port_evaluator.rank_path_for(16, 12, torch.bfloat16, "cuda", "kernel",
                                        "hist") == "blockwise"


@pytest.mark.parametrize("multi_space", [True, False])
@pytest.mark.parametrize("loss", ["mrl", "dsl"])
def test_hist_loss_matches_laff_tpu(loss, multi_space):
    jspec = dataclasses.replace(_spec(measure="hist", multi_space=multi_space), loss=loss)
    rng = np.random.default_rng(4)
    txt = rng.standard_normal((8, 4, 8)).astype(np.float32)
    vis = rng.standard_normal((8, 4, 8)).astype(np.float32)
    ref, (gt, gv) = jax.value_and_grad(jax_trainer.make_loss_fn(jspec), argnums=(0, 1))(
        jnp.asarray(txt), jnp.asarray(vis))
    pt = torch.tensor(txt, requires_grad=True)
    pv = torch.tensor(vis, requires_grad=True)
    value = port_trainer.make_loss_fn(spec_from_dict(dataclasses.asdict(jspec)))(pt, pv)
    value.backward()
    scale = max(abs(float(ref)), 1.0)
    assert abs(float(value) - float(ref)) <= TOL * scale
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gt), atol=TOL * scale)
    np.testing.assert_allclose(pv.grad.numpy(), np.asarray(gv), atol=TOL * scale)
