"""The port's live CLIP towers on the CPU, held against laff_tpu on the same
seeded inputs and weights:

* the BPE tokenizer on 200 captions (unicode, HTML entities, repeated
  whitespace, over-long ones) at contexts 77 and 16: bit-equal matrices;
* the text, ViT and ResNet towers on synthetic OpenAI-layout state dicts
  (laff_tpu's importers on one side, the port's strict loads on the other),
  and on flax-initialized parameters carried by ``engine.weights``: outputs
  within 1e-5 of the largest value;
* ``infer_clip_config`` and ``build_towers`` on ViT, ResNet and text-only
  state dicts: equal configs, equal outputs;
* ``load_state_dict`` on a plain state dict, a wrapped one and a
  ``torch.jit.script`` archive, ``load`` by path and by a released name
  whose file is already in place (no network: the download is patched to
  fail), and the sha256 re-download path's errors.
"""

import dataclasses
import hashlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.models import clip as J
from laff_tpu_torch.engine import weights as W
from laff_tpu_torch.models import clip as P

WORDS = ["a", "dog", "runs", "on", "the", "grass", "Café", "naïve", "Zürich", "東京", "🙂",
         "&amp;", "&lt;b&gt;", "&#39;s", "don't", "42", "3.14", "!!!", "HELLO", "résumé",
         "  ", "\t", "co-operate", "I'll", "we've", "x1y2", "ßtraße", "Ωmega", "…"]


def _captions(n=200, seed=0):
    rng = np.random.default_rng(seed)
    caps = []
    for i in range(n):
        k = int(rng.integers(1, 12)) if i % 10 else int(rng.integers(60, 120))  # over-long
        caps.append(" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), k)))
    return caps


@pytest.mark.parametrize("context", [77, 16])
def test_tokenizer_equals_laff_tpu(context):
    caps = _captions()
    ours, ref = P.tokenize(caps, context), J.tokenize(caps, context)
    assert ours.dtype == ref.dtype and ours.shape == (200, context)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == 49406).all() and (ours.max(axis=1) == 49407).all()
    assert P.get_tokenizer().decode(P.get_tokenizer().encode("a dog runs")) == "a dog runs "
    with pytest.raises(ValueError, match="too long"):
        P.tokenize("word " * 100, context, truncate=False)


def _randomized(module: torch.nn.Module, prefix: str = "", seed: int = 0):
    """The module's state dict with seeded values (BatchNorm variances
    positive), under ``prefix``, as an OpenAI file would hold it."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=gen) + 0.5
        else:
            v = v + 0.05 * torch.randn(v.shape, generator=gen)
        sd[prefix + k] = v
    return sd


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, float(np.abs(b).max())))


TEXT = P.ClipTextConfig(vocab_size=49408, context_length=77, width=64, heads=1, layers=2,
                        embed_dim=32)
VIT = P.ClipVisionConfig(image_size=32, patch_size=8, width=64, heads=2, layers=2,
                         embed_dim=32)
RN = P.ClipResNetConfig(layers=(2, 1, 1, 2), width=16, heads=4, image_size=32, embed_dim=32)
RN_1111 = dataclasses.replace(RN, layers=(1, 1, 1, 1))


def _images(n=3, size=32, seed=1):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _ids():
    return P.tokenize(_captions(6, seed=3))


def _port(tower, x):
    with torch.no_grad():
        return tower(torch.from_numpy(x)).numpy()


def test_text_tower_matches_laff_tpu():
    sd = _randomized(P.ClipTextTower(TEXT))
    tower = P.ClipTextTower(TEXT)
    tower.load_state_dict(P.text_state_dict(sd, TEXT.layers))
    params = jax.tree.map(jnp.asarray, J.import_text_tower(sd, layers=TEXT.layers))
    ref = J.ClipTextTower(J.ClipTextConfig(**dataclasses.asdict(TEXT))).apply(
        {"params": params}, jnp.asarray(_ids()))
    _close(_port(tower, _ids()), ref)


def test_vit_tower_matches_laff_tpu():
    sd = _randomized(P.ClipVisionTower(VIT), "visual.")
    tower = P.ClipVisionTower(VIT)
    tower.load_state_dict(P.vision_state_dict(sd, VIT.layers))
    params = J.import_vision_tower(sd, layers=VIT.layers)
    ref = J.ClipVisionTower(J.ClipVisionConfig(**dataclasses.asdict(VIT))).apply(
        {"params": params}, jnp.asarray(_images()))
    _close(_port(tower, _images()), ref)


def test_resnet_tower_matches_laff_tpu():
    sd = _randomized(P.ModifiedResNetTower(RN), "visual.")
    for k in [k for k in sd if k.endswith("running_var")]:  # as torch's BatchNorm2d saves
        sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    tower = P.ModifiedResNetTower(RN)
    tower.load_state_dict(P.resnet_state_dict(sd, RN))
    jcfg = J.ClipResNetConfig(**dataclasses.asdict(RN))
    ref = jax.jit(J.ModifiedResNetTower(jcfg).apply)(J.import_resnet_tower(sd, jcfg),
                                                     jnp.asarray(_images()))
    _close(_port(tower, _images()), ref)


@pytest.mark.parametrize("kind", ["text", "vit", "resnet"])
def test_flax_variables_carry_over(kind):
    """laff_tpu's flax-initialized towers, carried by engine.weights: the
    port's strict load gives the flax outputs."""
    key = jax.random.key(7)
    if kind == "text":
        jt, pt, x = J.ClipTextTower(J.ClipTextConfig(**dataclasses.asdict(TEXT))), \
            P.ClipTextTower(TEXT), _ids()
        variables = jt.init(key, jnp.asarray(x))
        sd = W.clip_text_from_jax(jax.tree.map(np.asarray, variables["params"]))
    elif kind == "vit":
        jt, pt, x = J.ClipVisionTower(J.ClipVisionConfig(**dataclasses.asdict(VIT))), \
            P.ClipVisionTower(VIT), _images()
        variables = jt.init(key, jnp.asarray(x))
        sd = W.clip_vision_from_jax(jax.tree.map(np.asarray, variables["params"]))
    else:
        jt, pt, x = J.ModifiedResNetTower(J.ClipResNetConfig(**dataclasses.asdict(RN_1111))), \
            P.ModifiedResNetTower(RN_1111), _images(1)
        variables = jax.tree.map(np.asarray, jax.jit(jt.init)(key, jnp.asarray(x)))
        rng = np.random.default_rng(2)  # statistics away from the init's 0 / 1
        variables["batch_stats"] = jax.tree.map(
            lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.min() > 0.5
                       else rng.normal(0, 0.1, v.shape)).astype(np.float32),
            variables["batch_stats"])
        sd = W.clip_resnet_from_jax(variables)
    pt.load_state_dict(sd)
    _close(_port(pt, x), jax.jit(jt.apply)(variables, jnp.asarray(x)))


def _full_sd(vision: str):
    sd = _randomized(P.ClipTextTower(P.ClipTextConfig(
        vocab_size=100, context_length=16, width=64, heads=1, layers=2, embed_dim=24)))
    sd["logit_scale"] = torch.tensor(4.6)
    if vision == "vit":
        sd.update(_randomized(P.ClipVisionTower(P.ClipVisionConfig(
            image_size=16, patch_size=8, width=64, heads=1, layers=2, embed_dim=24)),
            "visual.", seed=1))
    elif vision == "resnet":
        sd.update(_randomized(P.ModifiedResNetTower(P.ClipResNetConfig(
            layers=(1, 1, 1, 1), width=16, heads=8, image_size=32, embed_dim=24)),
            "visual.", seed=1))
    return sd


def _tiny_ids():
    ids = np.zeros((2, 16), np.int32)
    ids[:, 0] = 97
    ids[0, 1], ids[0, 2] = 5, 99
    ids[1, 1], ids[1, 2], ids[1, 3] = 7, 99, 99  # the first maximum pools
    return ids


@pytest.mark.parametrize("vision", ["vit", "resnet", "none"])
def test_infer_and_build_towers_match_laff_tpu(vision):
    sd = _full_sd(vision)
    arch, ref_arch = P.infer_clip_config(sd), J.infer_clip_config(sd)
    assert dataclasses.asdict(arch.text) == dataclasses.asdict(ref_arch.text)
    assert arch.vit == ref_arch.vit == (vision == "vit")
    if vision == "none":
        assert arch.vision is None and ref_arch.vision is None
    else:
        assert dataclasses.asdict(arch.vision) == dataclasses.asdict(ref_arch.vision)
    text, vis = P.build_towers(sd)
    jt, jtv, jv, jvv = J.build_towers(sd)
    _close(_port(text, _tiny_ids()), jt.apply(jtv, jnp.asarray(_tiny_ids())))
    if vision == "none":
        assert vis is None and jv is None
        return
    imgs = _images(2, arch.vision.image_size)
    _close(_port(vis, imgs), jax.jit(jv.apply)(jvv, jnp.asarray(imgs)))


def _jit_archive(sd, path):
    """A flat state dict packed as a TorchScript archive in the nested
    module layout of the released CLIP .pt files, with their non-weight
    buffers."""
    root = torch.nn.Module()
    for k, v in sd.items():
        parts, m = k.split("."), root
        for p in parts[:-1]:
            if not hasattr(m, p):
                m.add_module(p, torch.nn.Module())
            m = getattr(m, p)
        if v.is_floating_point():
            m.register_parameter(parts[-1], torch.nn.Parameter(v.clone()))
        else:
            m.register_buffer(parts[-1], v.clone())
    for name, value in (("input_resolution", 16), ("context_length", 16), ("vocab_size", 100)):
        root.register_buffer(name, torch.tensor(value))
    torch.jit.save(torch.jit.script(root), str(path))


@pytest.mark.parametrize("container", ["jit", "state_dict", "checkpoint"])
def test_load_state_dict_matches_laff_tpu(tmp_path, container):
    sd = _full_sd("vit")
    path = tmp_path / "tiny.pt"
    if container == "jit":
        _jit_archive(sd, path)
    else:
        torch.save(sd if container == "state_dict" else {"state_dict": sd}, path)
    got, ref = P.load_state_dict(str(path)), J.load_state_dict(str(path))
    assert set(got) == set(ref) == set(sd)
    for k in sd:
        assert torch.equal(got[k], ref[k]) and torch.equal(got[k], sd[k])
    loaded = P.load(str(path))
    assert loaded.input_resolution == 16 and loaded.arch.vit
    jl = J.load(str(path))
    _close(_port(loaded.text_tower, _tiny_ids()),
           jl.text_tower.apply(jl.text_vars, jnp.asarray(_tiny_ids())))
    imgs = _images(2, 16)
    _close(_port(loaded.vision_tower, imgs), jl.vision_tower.apply(jl.vision_vars,
                                                                   jnp.asarray(imgs)))


def test_load_by_name_offline(tmp_path, monkeypatch):
    load_mod = importlib.import_module("laff_tpu_torch.models.clip.load")

    def no_network(url):
        raise OSError("no network in tests")

    monkeypatch.setattr(load_mod.urllib.request, "urlopen", no_network)
    assert P.available_models() == J.available_models()
    path = tmp_path / "Tiny.pt"
    torch.save(_full_sd("vit"), path)
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    monkeypatch.setitem(load_mod._MODELS, "Tiny", f"https://example.invalid/clip/{sha}/Tiny.pt")
    loaded = P.load("Tiny", download_root=str(tmp_path))
    assert loaded.arch.vit and loaded.input_resolution == 16
    with pytest.raises(RuntimeError, match="available models"):
        P.load("NoSuchModel", download_root=str(tmp_path))
    monkeypatch.setitem(load_mod._MODELS, "Tiny2",
                        f"https://example.invalid/clip/{'0' * 64}/Tiny2.pt")
    (tmp_path / "Tiny2.pt").write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="place the released checkpoint"):
        with pytest.warns(UserWarning, match="SHA256"):
            P.load("Tiny2", download_root=str(tmp_path))
    assert (tmp_path / "Tiny2.pt").read_bytes() == b"garbage"
    assert not list(tmp_path.glob("*.tmp.*"))
