"""Experiment orchestration (``laff_tpu_torch.engine.orchestrate``, its CLIs)
and the two public names of ROADMAP item 7, on the CPU, held against
laff_tpu.

* ``retrieval_task`` with ``batch_seeds`` (two seeds) and without it (one
  seed), one parm, and ``avs_task`` on two TRECVID editions, one epoch
  each, in both packages from one
  flax init carried into the port (``pretrained_file_path``), dropout off,
  each package on its own copy of one world: the same model directories,
  the same result-file rows (the root and the time stamp aside), the same
  result keys, and for AVS the same infAP per edition;
* ``cli/retrieval_task.py --jobs 2`` (one subprocess a seed) and
  ``cli/all_run.py`` (two dataset triples into one result file) through
  ``main(argv)`` with ``--device cpu``: the model directories and the
  result rows' keys (checkpoint, collection, parm) that ``laff_tpu``'s
  ``model_dir_for`` gives for the same grid (these train from the port's
  own seeded init, so their metrics are not compared; the tests above
  compare ``retrieval_task``'s numbers); ``--jobs`` > 1 with
  ``--batch_seeds`` is refused;
* ``models.laff.get_attention_weights`` against ``laff_tpu``'s on carried
  weights within 1e-6, (B, L, H) for the LAFF gate and (B, L) for the
  single-head gate, the model's mode kept; ``store.StreamFile`` yields
  ``laff_tpu``'s sequence on one BigFile.

The orchestration world is ``laff_tpu_torch.data.synth``'s: train, val and
test collections and a 40-shot iacc.3 with two editions of three topics,
over one 60-word vocabulary, under the rehearsal config cut to test widths;
the CLI world is ``tests/test_orchestrate.py``'s under 'tiny'.
"""

import importlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import rehearsal as jax_rehearsal
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import save_checkpoint as jax_save
from laff_tpu.engine.orchestrate import SweepOptions as JSweepOptions
from laff_tpu.models import AttentionSpec, LAFFSpec, TowerSpec
from laff_tpu.models import LAFFModel as FlaxLAFF
from laff_tpu.models.laff import get_attention_weights as jax_attention_weights
from laff_tpu.store import StreamFile as JStreamFile
from laff_tpu_torch.cli import all_run, retrieval_task as retrieval_cli
from laff_tpu_torch.configs import rehearsal as port_rehearsal
from laff_tpu_torch.data import synth
from laff_tpu_torch.engine import orchestrate as port_orchestrate
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables
from laff_tpu_torch.models import LAFFModel
from laff_tpu_torch.models.laff import get_attention_weights
from laff_tpu_torch.store import StreamFile, write_bigfile

from helpers import build_collection, build_w2v

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
jax_orchestrate = importlib.import_module("laff_tpu.engine.orchestrate")

TRAIN, VAL, TEST, AVS = "otrain", "oval", "otest", "iacc.3"
N_VOCAB = 60
EDITIONS = ("tv16", "tv17")
ATTN_ATOL = 1e-6


def _small(config):
    """The rehearsal config at test widths (``tests/test_torch_port_avs.py``'s
    cut), dropout off."""
    config.vid_feats = ["clip_ft", "x3d"]
    config.vis_fc_layers = ["0", synth.CLIP_DIM]
    config.txt_fc_layers = f"0-{synth.CLIP_DIM}"
    config.multi_head_attention = {"dropout": 0.0, "heads": 8, "embed_dim_qkv": 64}
    config.rnn_size = 16
    config.threshold = 1
    config.float16 = False
    config.dropout = 0.0
    return config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny tensors, so that the workers
    of a parallel test run do not spin against each other; put back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The collections, and the two packages' copies of one flax init (its
    spec from laff_tpu's prepare on the train collection)."""
    root = str(tmp_path_factory.mktemp("orchestrate_world"))
    synth.build_world(root, TRAIN, n_videos=30, caps_per_video=2, n_vocab=N_VOCAB, seed=1)
    synth.build_world(root, VAL, n_videos=12, caps_per_video=2, n_vocab=N_VOCAB, seed=4)
    synth.build_world(root, TEST, n_videos=16, caps_per_video=2, n_vocab=N_VOCAB, seed=3)
    synth.build_avs_world(root, AVS, n_videos=40, editions=EDITIONS, topics_per_edition=3,
                          n_vocab=N_VOCAB, seed=2, relevant=(2, 5))
    ckpts = str(tmp_path_factory.mktemp("orchestrate_init"))
    mp = pytest.MonkeyPatch()
    try:
        _small_configs(mp)
        common = dict(trainCollection=TRAIN, valCollection=VAL, rootpath=root, val_set="no",
                      config_name="rehearsal", batch_size=16, model_prefix="init")
        jprep = jax_prepare.prepare(JOptions(**common))
        init = jax_trainer.init_state(
            jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
            jax_trainer.make_optimizer(jprep.config, jprep.spec), seed=2)
        host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        jax_ckpt = os.path.join(ckpts, "init.pth.tar")
        jax_save({"params": host(init.params), "batch_stats": host(init.batch_stats),
                  "schedule": host(init.schedule), "config": jprep.config, "spec": jprep.spec,
                  "opt": {}}, jax_ckpt)
        pprep = port_prepare.prepare(port_prepare.Options(device="cpu", **common))
        port_ckpt = os.path.join(ckpts, "init.pt")
        save_checkpoint(checkpoint_payload(
            from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
            pprep.spec, pprep.config, pprep.featurizers, {}), port_ckpt)
    finally:
        mp.undo()
    shutil.rmtree(os.path.join(root, TRAIN, "w2vvpp_train"))  # the init runs' model dirs
    return {"root": root, "jax_ckpt": jax_ckpt, "port_ckpt": port_ckpt}


def _small_configs(monkeypatch):
    monkeypatch.setattr(jax_prepare, "load_config",
                        lambda name: _small(jax_rehearsal.config()))
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _small(port_rehearsal.config()))


def _copies(src, dst):
    """Two copies of the world, at ``dst``/jax and ``dst``/port."""
    return [shutil.copytree(src, os.path.join(dst, who)) for who in ("jax", "port")]


def _model_dirs(root):
    out = []
    for dirpath, _, files in os.walk(root):
        if "model_best.pth.tar" in files:
            out.append(os.path.relpath(dirpath, root))
    return sorted(out)


def _rows(root):
    """{result file: its rows with the root made relative and the time stamp
    dropped} under ``root``/result_log."""
    out = {}
    base = os.path.join(root, "result_log")
    for dirpath, _, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path) as fh:
                rows = [line.rstrip("\n").split("\t", 1)[1].replace(root + os.sep, "")
                        for line in fh if line.strip()]
            out[os.path.relpath(path, base)] = rows
    return out


def _sweeps(jroot, proot, ckpts, **kw):
    common = dict(trainCollection=TRAIN, valCollection=VAL, config_name="rehearsal",
                  parm_adjust_configs=["None"], val_set="no", batch_size=16, num_epochs=1,
                  overwrite=1, **kw)
    j = JSweepOptions(rootpath=jroot, pretrained_file_path=ckpts["jax_ckpt"],
                      result_file=os.path.join(jroot, "result_log", "r.txt"), **common)
    p = port_orchestrate.SweepOptions(rootpath=proot, pretrained_file_path=ckpts["port_ckpt"],
                                      result_file=os.path.join(proot, "result_log", "r.txt"),
                                      device="cpu", **common)
    return j, p


def _assert_same_results(jres, pres):
    assert pres.keys() == jres.keys()
    for key in jres:
        assert pres[key].keys() == jres[key].keys()
        assert pres[key]["predict_all"].keys() == jres[key]["predict_all"].keys()
        assert pres[key]["train"].get("skipped") == jres[key]["train"].get("skipped")
        assert pres[key]["train"].get("batched") == jres[key]["train"].get("batched")


@pytest.mark.parametrize("seeds,batch_seeds", [([2], False), ([2, 7], True)])
def test_retrieval_task_matches_laff_tpu(world, monkeypatch, tmp_path, seeds, batch_seeds):
    _small_configs(monkeypatch)
    jroot, proot = _copies(world["root"], str(tmp_path))
    j, p = _sweeps(jroot, proot, world, testCollection=TEST, random_seeds=seeds,
                   batch_seeds=batch_seeds)
    jres = jax_orchestrate.retrieval_task(j)
    pres = port_orchestrate.retrieval_task(p)
    _assert_same_results(jres, pres)
    assert set(pres) == {f"runs_None_seed_{s}" for s in seeds}
    assert all(r["train"].get("batched", False) == batch_seeds for r in pres.values())
    assert _model_dirs(proot) == _model_dirs(jroot) != []
    rows = _rows(proot)
    assert rows == _rows(jroot) and sum(len(v) for v in rows.values()) >= 2 * len(seeds)


def test_avs_task_matches_laff_tpu(world, monkeypatch, tmp_path):
    _small_configs(monkeypatch)
    jroot, proot = _copies(world["root"], str(tmp_path))
    sets = ",".join(f"{e}.avs.txt" for e in EDITIONS)
    j, p = _sweeps(jroot, proot, world, testCollection=AVS, random_seeds=[2],
                   avs_query_sets=sets, avs_editions=list(EDITIONS))
    jres = jax_orchestrate.avs_task(j)
    pres = port_orchestrate.avs_task(p)
    _assert_same_results(jres, pres)
    got, want = pres["runs_None_seed_2"], jres["runs_None_seed_2"]
    assert set(got["infAP"]) == set(EDITIONS)
    assert got["infAP"] == want["infAP"] and got["infAP_all"] == want["infAP_all"]
    assert _model_dirs(proot) == _model_dirs(jroot)
    for qs in sets.split(","):
        assert os.path.exists(got["predict"][qs]["score_file"] + ".xml")


@pytest.fixture(scope="module")
def toy_world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orchestrate_toy"))
    for name, n, caps, seed in (("dsAtrain", 24, 2, 0), ("dsAval", 12, 1, 5),
                                ("dsAtest", 12, 1, 9), ("dsBtrain", 24, 2, 1),
                                ("dsBval", 12, 1, 6), ("dsBtest", 12, 1, 8)):
        build_collection(root, name, n_videos=n, caps_per_video=caps, seed=seed)
    build_w2v(root)
    return root


def _row_keys(root):
    """Each result file's rows reduced to their (checkpoint, collection, parm)
    keys, sorted."""
    return {f: sorted(tuple(r.split("\t")[:2] + r.split("\t")[9:]) for r in rows)
            for f, rows in _rows(root).items()}


def _laff_tpu_layout(root, triples, seeds):
    """The model directories and row keys ``laff_tpu``'s retrieval_task gives
    the grid, from its own ``model_dir_for``."""
    dirs, keys = [], []
    for train, val, test in triples:
        for s in seeds:
            d = jax_prepare.model_dir_for(JOptions(
                trainCollection=train, valCollection=val, rootpath=root, val_set="no",
                config_name="tiny", model_prefix=f"runs_None_seed_{s}"))
            dirs.append(os.path.relpath(d, root))
            keys.append((os.path.join(dirs[-1], "model_best.pth.tar"), test, "None"))
    return sorted(dirs), {os.path.join(side, "r.txt"): sorted(keys)
                          for side in ("TextToVideo", "VideoToText")}


def test_retrieval_task_cli_jobs(toy_world, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # two jobs at once on a shared host
    root = shutil.copytree(toy_world, str(tmp_path / "port"))
    rc = retrieval_cli.main(["--rootpath", root, "--trainCollection", "dsAtrain",
                             "--valCollection", "dsAval", "--testCollection", "dsAtest",
                             "--config", "tiny", "--random_seeds", "2,3", "--num_epochs", "1",
                             "--batch_size", "12", "--jobs", "2", "--device", "cpu",
                             "--result_file", os.path.join(root, "result_log", "r.txt")])
    assert rc == 0
    dirs, keys = _laff_tpu_layout(root, [("dsAtrain", "dsAval", "dsAtest")], [2, 3])
    assert _model_dirs(root) == dirs and len(dirs) == 2
    assert _row_keys(root) == keys


def test_all_run_cli(toy_world, tmp_path):
    root = shutil.copytree(toy_world, str(tmp_path / "port"))
    triples = [("dsAtrain", "dsAval", "dsAtest"), ("dsBtrain", "dsBval", "dsBtest")]
    rc = all_run.main(["--rootpath", root, "--datasets", ",".join(":".join(t) for t in triples),
                       "--config", "tiny", "--parm_adjust_configs", "None", "--num_epochs", "1",
                       "--batch_size", "12", "--device", "cpu",
                       "--result_file", os.path.join(root, "result_log", "r.txt")])
    assert rc == 0
    dirs, keys = _laff_tpu_layout(root, triples, [2])
    assert _model_dirs(root) == dirs and len(dirs) == 2
    assert _row_keys(root) == keys


def test_jobs_exclude_batch_seeds(capsys):
    with pytest.raises(SystemExit):
        retrieval_cli.parse_args(["--trainCollection", "a", "--valCollection", "b",
                                  "--testCollection", "c", "--config", "tiny", "--jobs", "2",
                                  "--batch_seeds", "1"])
    assert "--batch_seeds" in capsys.readouterr().err


def _gate_spec(kind):
    attn = AttentionSpec(kind=kind, heads=4, with_ave=True)
    return LAFFSpec(txt=TowerSpec(features=(("bow", 16), ("clip", 12), ("w2v", 10)),
                                  common_dim=32, attention=attn),
                    vis=TowerSpec(features=(("f1", 10), ("f2", 12)), common_dim=32,
                                  attention=attn))


@pytest.mark.parametrize("kind,heads", [("Multi_head_MyApply_Attention", (4,)),
                                        ("attention_noAverageMul_Ave", ())])
def test_get_attention_weights_matches_laff_tpu(kind, heads):
    rng = np.random.default_rng(0)
    spec = _gate_spec(kind)
    txt = {n: rng.standard_normal((6, d)).astype(np.float32) for n, d in spec.txt.features}
    vis = {n: rng.standard_normal((6, d)).astype(np.float32) for n, d in spec.vis.features}
    flax = FlaxLAFF(spec)
    variables = flax.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                          {k: jnp.asarray(v) for k, v in txt.items()},
                          {k: jnp.asarray(v) for k, v in vis.items()})
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    model = LAFFModel(spec)
    model.load_state_dict(from_jax_variables(host(variables["params"]),
                                             host(variables.get("batch_stats", {})),
                                             host(variables.get("schedule", {}))))
    model.train()
    for side, inputs in (("txt", txt), ("vis", vis)):
        want = jax_attention_weights(flax, variables, {k: jnp.asarray(v)
                                                       for k, v in inputs.items()}, side=side)
        got = get_attention_weights(model, {k: torch.from_numpy(v) for k, v in inputs.items()},
                                    side=side)
        n_locals = len(getattr(spec, side).features)
        assert got.shape == want.shape == (6, n_locals, *heads)
        np.testing.assert_allclose(got, want, atol=ATTN_ATOL)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    assert model.training


def test_stream_file_matches_laff_tpu(tmp_path):
    rng = np.random.default_rng(3)
    names = [f"v{i}" for i in range(7)]
    write_bigfile(str(tmp_path / "feat"), names, rng.standard_normal((7, 5)).astype(np.float32))
    got, want = StreamFile(str(tmp_path / "feat")), JStreamFile(str(tmp_path / "feat"))
    assert (got.names, got.ndims) == (want.names, want.ndims) == (names, 5)
    got.open()
    want.open()
    assert list(got) == list(want)
    assert list(got) == []  # exhausted until opened again
    got.open()
    assert next(got) == next(iter(JStreamFile(str(tmp_path / "feat"))))
    got.close()
