"""laff_tpu_torch models, featurizers and checkpoints on the CPU, held
against laff_tpu's flax modules with weights carried by
``from_jax_variables`` and the same seeded numpy inputs.

Tolerances: f32 module outputs to 1e-5 (the two frameworks sum in other
orders); bf16 towers to 4e-2 absolute on unit-scale activations, i.e. a few
bf16 ulps, because the two frameworks round the bf16 intermediates
(linear, bias, tanh) at different places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.models.attention import MultiHeadGateAttention as FlaxGate
from laff_tpu.models.gru import GruEncoder as FlaxGru
from laff_tpu.models.laff import LAFFModel as FlaxLAFF
from laff_tpu.models.layers import TransformNet as FlaxTransform
from laff_tpu.models.spec import AttentionSpec, GruSpec, LAFFSpec, TowerSpec, TransformSpec
from laff_tpu_torch.engine.checkpoint import (checkpoint_payload, load_checkpoint,
                                              save_checkpoint)
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import GruEncoder, LAFFModel, MultiHeadGateAttention, TransformNet
from laff_tpu_torch.models import spec as port_spec

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=4e-2)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), jax.device_get(tree))


def _randomize_bn(params, stats, rng):
    """Non-trivial BatchNorm scale/bias and running stats, so eval-mode BN
    is exercised rather than the identity init."""
    params, stats = _np_tree(params), _np_tree(stats)

    def walk(p, s):
        for key in p:
            if key == "bn1":
                n = p[key]["scale"].shape[0]
                p[key]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[key]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[key]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(p[key], dict) and key in s:
                walk(p[key], s[key])

    walk(params, stats)
    return params, stats


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fc", [True, False])
def test_transform_net_matches_flax(rng, fc, bf16):
    x = rng.standard_normal((8, 20 if fc else 32)).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else None
    flax_mod = FlaxTransform(dim_out=32, fc=fc, activation="tanh" if fc else None,
                             dropout=0.2 if fc else 0.0, batch_norm=True, dtype=dtype)
    variables = flax_mod.init(jax.random.key(1), jnp.asarray(x))
    params, stats = _randomize_bn(variables["params"], variables["batch_stats"], rng)
    ref = np.asarray(flax_mod.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x)))
    ours = TransformNet(20, 32, fc=fc, activation="tanh" if fc else None,
                        dropout=0.2 if fc else 0.0, batch_norm=True,
                        compute_dtype=torch.bfloat16 if bf16 else None)
    ours.load_state_dict(from_jax_variables(params, stats))
    ours.eval()
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert out.dtype == torch.float32  # the f32 output cast of layers.py:66
    np.testing.assert_allclose(out.numpy(), ref, **(BF16_TOL if bf16 else F32_TOL))


@pytest.mark.parametrize("pooling,bidirectional,layers", [
    ("mean", False, 1), ("last", False, 1), ("mean_last", False, 2),
    ("mean", True, 1), ("mean_last", True, 1),
])
def test_gru_encoder_matches_flax(rng, pooling, bidirectional, layers):
    spec = GruSpec(vocab_size=30, we_dim=8, rnn_size=16, rnn_layer=layers,
                   pooling=pooling, bidirectional=bidirectional)
    ids = rng.integers(1, 30, (6, 10)).astype(np.int32)
    lengths = np.asarray([10, 7, 3, 2, 9, 5], np.int32)
    ids[np.arange(10)[None, :] >= lengths[:, None]] = 0
    flax_mod = FlaxGru(spec)
    variables = flax_mod.init(jax.random.key(2), jnp.asarray(ids), jnp.asarray(lengths))
    ref = np.asarray(flax_mod.apply(variables, jnp.asarray(ids), jnp.asarray(lengths)))
    ours = GruEncoder(port_spec.GruSpec(**dataclasses.asdict(spec)))
    sd = from_jax_variables({"gru": _np_tree(variables["params"])})
    ours.load_state_dict(_strip(sd, "gru."))
    with torch.no_grad():
        out = ours(torch.from_numpy(ids), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


_GATE_CASES = {
    "laff_with_ave": dict(with_ave=True),
    "laff_plain": dict(with_ave=False),
    "mul": dict(with_ave=True, mul=True),
    "no_split": dict(with_ave=True, split_head=False),
    "l2norm_each_head": dict(with_ave=False, l2norm_each_head=True),
    "layer_norm": dict(with_ave=True, pre_layer_norm=True, ave_style="one_minus_g"),
    "distinct_fc": dict(with_ave=True, distinct_fc=True),
    "fusion_mix": dict(fusion_mix=True),
    "masked": dict(with_ave=True, mask=True),
}


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
def test_gate_module_matches_flax(rng, case):
    opts = dict(_GATE_CASES[case])
    use_mask = opts.pop("mask", False)
    b, l, dim, heads = 5, 4, 32, 4
    x = rng.standard_normal((b, l, dim)).astype(np.float32)
    mask = None
    if use_mask:
        mask = np.ones((b, l), np.float32)
        mask[1, 2:] = 0
        mask[3, 1:] = 0
    flax_mod = FlaxGate(heads=heads, **opts)
    jmask = None if mask is None else jnp.asarray(mask)
    variables = flax_mod.init(jax.random.key(3), jnp.asarray(x), mask=jmask)
    variables = _np_tree(variables)
    if "schedule" in variables:
        variables["schedule"]["global_emb_weight"] = np.float32(0.6)
    ref = np.asarray(flax_mod.apply(variables, jnp.asarray(x), mask=jmask))
    ours = MultiHeadGateAttention(dim, heads, **opts)
    sd = from_jax_variables({"attention": variables["params"]},
                            schedule={"attention": variables.get("schedule", {})})
    ours.load_state_dict(_strip(sd, "attention."))
    with torch.no_grad():
        out = ours(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def _small_spec(with_ave=False, bf16=False, experts=False):
    attn = AttentionSpec(kind="Multi_head_MyApply_Attention", heads=4,
                         with_ave=with_ave, mul=False, split_head=True)
    dtype = "bfloat16" if bf16 else "float32"
    txt = TowerSpec(
        features=(("rnn", 16), ("bow", 30), ("w2v", 8), ("clip", 8)), common_dim=32,
        attention=attn, no_transform=("clip",),
        transform_overrides=(("clip", TransformSpec(dim_in=8, dim_out=32, fc=False,
                                                    activation=None, dropout=0.0,
                                                    batch_norm=True)),),
        batch_norm=True, gru=GruSpec(vocab_size=25, we_dim=8, rnn_size=16),
        compute_dtype=dtype)
    vis = TowerSpec(features=(("clip_ft", 12), ("x3d", 20)), common_dim=32,
                    attention=attn, batch_norm=True, expert_embedding=experts,
                    expert_l2norm=experts, feat_add_concat=experts, compute_dtype=dtype)
    return LAFFSpec(txt=txt, vis=vis)


def _tower_inputs(rng, b=6, sparse_bow=False):
    ids = rng.integers(1, 25, (b, 9)).astype(np.int32)
    lengths = rng.integers(2, 10, (b,)).astype(np.int32)
    bow = rng.poisson(0.3, (b, 30)).astype(np.float32)
    txt = {"rnn_ids": ids, "rnn_len": lengths,
           "w2v": rng.standard_normal((b, 8)).astype(np.float32),
           "clip": rng.standard_normal((b, 8)).astype(np.float32)}
    if sparse_bow:
        bow_ids = np.full((b, 12), 30, np.int32)
        bow_cnt = np.zeros((b, 12), np.float32)
        for i in range(b):
            nz = np.nonzero(bow[i])[0][:12]
            bow_ids[i, :nz.size] = nz
            bow_cnt[i, :nz.size] = bow[i, nz]
        txt.update(bow_ids=bow_ids, bow_cnt=bow_cnt)
    else:
        txt["bow"] = bow
    vis = {"clip_ft": rng.standard_normal((b, 12)).astype(np.float32),
           "x3d": rng.standard_normal((b, 20)).astype(np.float32)}
    return txt, vis


@pytest.mark.parametrize("with_ave,bf16,experts,sparse_bow", [
    (False, False, False, False),
    (True, False, True, True),
    (False, True, False, True),
])
def test_laff_towers_match_flax(rng, with_ave, bf16, experts, sparse_bow):
    spec = _small_spec(with_ave, bf16, experts)
    txt, vis = _tower_inputs(rng, sparse_bow=sparse_bow)
    jtxt = {k: jnp.asarray(v) for k, v in txt.items()}
    jvis = {k: jnp.asarray(v) for k, v in vis.items()}
    flax_model = FlaxLAFF(spec)
    variables = flax_model.init({"params": jax.random.key(4), "dropout": jax.random.key(5)},
                                jtxt, jvis)
    params, stats = _randomize_bn(variables["params"], variables["batch_stats"], rng)
    schedule = _np_tree(variables.get("schedule", {}))
    for tower in schedule.values():
        tower["attention"]["global_emb_weight"] = np.float32(0.75)
    jvars = {"params": params, "batch_stats": stats, "schedule": schedule}
    ref_t = np.asarray(flax_model.apply(jvars, jtxt, method=flax_model.encode_txt))
    ref_v = np.asarray(flax_model.apply(jvars, jvis, method=flax_model.encode_vis))

    ours = LAFFModel(port_spec.spec_from_dict(dataclasses.asdict(spec)))
    ours.load_state_dict(from_jax_variables(params, stats, schedule))
    ours.eval()
    with torch.no_grad():
        out_t = ours.encode_txt({k: torch.from_numpy(v) for k, v in txt.items()})
        out_v = ours.encode_vis({k: torch.from_numpy(v) for k, v in vis.items()})
    tol = BF16_TOL if bf16 else F32_TOL
    assert out_t.shape == (6, 4, 8) and out_v.shape == (6, 4, 8)
    np.testing.assert_allclose(out_t.numpy(), ref_t, **tol)
    np.testing.assert_allclose(out_v.numpy(), ref_v, **tol)


def test_seeded_init_is_deterministic_and_in_bounds():
    spec = port_spec.spec_from_dict(dataclasses.asdict(_small_spec(with_ave=True)))
    a, b = LAFFModel(spec), LAFFModel(spec)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.vis_net.transform_x3d.fc1.weight
    assert w.abs().max() <= (6.0 / (20 + 32)) ** 0.5
    assert float(a.txt_net.attention.global_emb_weight) == 1.0
    assert a.txt_net.attention.gate_kernel.abs().max() <= 1 / 8 ** 0.5


def test_checkpoint_round_trip(tmp_path, rng):
    from laff_tpu_torch.text.textlib import Vocabulary
    from laff_tpu_torch.text.txt2vec import BowVecNSW, IndexVec

    spec = port_spec.spec_from_dict(dataclasses.asdict(_small_spec()))
    model = LAFFModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    vocab = Vocabulary("bow_nsw")
    for w in ("dog", "runs", "park"):
        vocab.add(w)
    gru_vocab = Vocabulary("gru")
    for w in ("<pad>", "<start>", "<end>", "<unk>", "dog"):
        gru_vocab.add(w)
    config = {"text_encoding": {"bow_encoding": {"name": "bow_nsw"}}, "max_txtlength": 77}
    payload = checkpoint_payload(model.state_dict(), spec, config,
                                 {"bow": BowVecNSW(vocab), "rnn": IndexVec(gru_vocab),
                                  "clip": None}, {"config_name": "x"})
    path = str(tmp_path / "ck.pt")
    save_checkpoint(payload, path)
    loaded = load_checkpoint(path)  # weights_only: no class of either package
    assert loaded["spec"] == spec
    assert loaded["config"].max_txtlength == 77
    assert loaded["vocab"]["bow"]["words"] == ["dog", "runs", "park"]
    assert loaded["vocab"]["bow"]["class"] == "BowVecNSW"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded["state_dict"][k], v), k


def test_text_featurizers_match_laff_tpu(tmp_path):
    from laff_tpu.store import write_bigfile as jwrite
    from laff_tpu.text import build_vocab as jbuild
    from laff_tpu.text.txt2vec import BowVecNSW as JBow, IndexVec as JIdx, W2VecNSW as JW2v
    from laff_tpu_torch.text import build_vocab
    from laff_tpu_torch.text.txt2vec import BowVecNSW, IndexVec, W2VecNSW

    caps = ["vid0#0 A dog runs in the park.", "vid0#1 the dog, the ball!",
            "vid1#0 A man eats at a red table", "vid1#1 man runs on the road"]
    capfile = tmp_path / "c.caption.txt"
    capfile.write_text("\n".join(caps))
    rng = np.random.default_rng(0)
    words = ["dog", "runs", "park", "ball", "man", "eats", "red", "table", "road"]
    jwrite(str(tmp_path / "w2v"), words, rng.standard_normal((9, 6)).astype(np.float32))
    queries = [c.split(" ", 1)[1] for c in caps] + ["unknown words only", ""]
    for enc in ("bow_nsw", "gru"):
        ours, _ = build_vocab(str(capfile), enc, threshold=1)
        ref, _ = jbuild(str(capfile), enc, threshold=1)
        assert ours.word2idx == ref.word2idx
    bow_v, _ = build_vocab(str(capfile), "bow_nsw", threshold=1)
    jbow_v, _ = jbuild(str(capfile), "bow_nsw", threshold=1)
    np.testing.assert_array_equal(BowVecNSW(bow_v).encode_batch(queries),
                                  JBow(jbow_v).encode_batch(queries))
    gru_v, _ = build_vocab(str(capfile), "gru", threshold=1)
    jgru_v, _ = jbuild(str(capfile), "gru", threshold=1)
    for a, b in zip(IndexVec(gru_v).encode_batch_padded(queries, 12),
                    JIdx(jgru_v).encode_batch_padded(queries, 12)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(W2VecNSW(str(tmp_path / "w2v")).encode_batch(queries),
                                  JW2v(str(tmp_path / "w2v")).encode_batch(queries))
