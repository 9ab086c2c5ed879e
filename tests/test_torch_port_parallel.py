"""The port's multi-rank paths on the CPU: 2-rank gloo groups started by the
port's launcher (``laff_tpu_torch.parallel.launch``, its ``FileStore``
under ``tmp_path``, one torch thread a rank), held against ``laff_tpu``'s
2-device mesh (``tests/conftest.py`` gives JAX 8 CPU devices) and against
the port's own single-process runs.

* ``parallel.sim_engine`` on V = 203 with duplicated rows straddling the
  shard boundary: ranks exactly equal to ``laff_tpu``'s; top k (bf16 and
  int8) within 1e-6 of ``laff_tpu``'s values, indices equal outside ties,
  and ties in the port's order (decreasing index), exactly the port's
  one-process order;
* a data-parallel train step (BatchNorm on) against the port's
  one-process step on the global batch, with dropout on (the loss within
  1e-6 relative, gradients within 1e-5 of the largest, the parameters and
  the running statistics after the update) and against ``laff_tpu``'s
  sharded step with dropout off (1e-4, as ``tests/test_parallel.py``);
* ``trainer.main(mesh=)`` over 2 ranks against ``laff_tpu``'s ``main(opt,
  mesh=data_parallel_mesh(2))`` from one init: epoch losses within 1e-4,
  only rank 0 writing files, and its checkpoint loading on one device with
  rank 0's weights;
* the predictor's data-parallel run against a single one, the gallery
  embedded whole and streamed (``LARGE_GALLERY`` passed to the ranks: a
  monkeypatch here does not reach them), its rows written once and rank 1's
  result empty (rank 0 alone ranks), and the AVS int8 stream and negation
  scoring (streamed and whole) writing a single run's score files;
* ``RetrievalService(mesh=)`` against one device: bf16 and int8 searches,
  ingest across the slab boundary, and the snapshot written by rank 0,
  restored over the mesh and by a one-device service.

The ranks' targets are module-level functions of this file, which imports
no JAX at its top: the spawned ranks import it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from laff_tpu_torch.parallel import launch, shard_batch
from laff_tpu_torch.parallel import sim_engine as port_sim

RANKS = 2
TOL = 1e-6


def _run(tmp_path, target, *args):
    out = launch(RANKS, target, *args, device="cpu", workdir=str(tmp_path))
    assert not dist.is_initialized()  # no group left behind in this process
    return out


# ---------------------------------------------------------------------------
# sim_engine
# ---------------------------------------------------------------------------

def _sim_rank(mesh, txt, vis, gt, vis_q, vis_s, k):
    torch.set_num_threads(1)
    t = torch.from_numpy(txt)
    local, v = port_sim.shard_gallery(torch.from_numpy(vis), mesh)
    q_local, _ = port_sim.shard_gallery(torch.from_numpy(vis_q), mesh)
    s_local, _ = port_sim.shard_gallery(torch.from_numpy(vis_s), mesh)
    return {"ranks": port_sim.sharded_t2v_ranks(t, local, gt, mesh, v),
            "topk": port_sim.sharded_topk(t, local, k, mesh, v),
            "int8": port_sim.sharded_int8_topk(t, q_local, s_local, k, mesh, v),
            "shard": local.shape[0]}


def _port_order(vals, idx, tol):
    """A top-k list with each run of equal values (within ``tol``) put in
    decreasing index, the port's tie order, and the length of the list
    before its last run: a run cut by k may hold other members of the tie
    (the port keeps the largest indices, ``lax.top_k`` the smallest)."""
    out = idx.copy()
    start = 0
    while start < len(vals):
        stop = start + 1
        while stop < len(vals) and abs(vals[stop] - vals[start]) <= tol:
            stop += 1
        out[start:stop] = np.sort(idx[start:stop])[::-1]
        if stop == len(vals):
            return out, start
        start = stop
    return out, len(vals)


def test_sharded_sim_engine_matches_laff_tpu(tmp_path):
    import jax
    import jax.numpy as jnp

    from laff_tpu.ops import quantized as jax_quantized
    from laff_tpu.ops.pallas_kernels import flatten_heads as jax_flatten
    from laff_tpu.parallel import data_parallel_mesh as jax_mesh
    from laff_tpu.parallel import sim_engine as jax_sim
    from laff_tpu_torch.engine.evaluator import ordered_topk
    from laff_tpu_torch.ops import flatten_heads, int8_scores, quantize_rows

    rng = np.random.default_rng(0)
    t, v, h, d, k = 40, 203, 2, 16, 15
    vis = rng.standard_normal((v, h, d)).astype(np.float32)
    vis[98:106] = vis[5]  # duplicates on both sides of the shard boundary (102)
    txt = rng.standard_normal((t, h, d)).astype(np.float32)
    txt[:4] = vis[5]  # queries whose top rows are the duplicates: exact ties
    gt = rng.integers(0, v, (t,)).astype(np.int32)
    gt[4:10] = [5, 99, 101, 102, 103, 105]  # ground truths among the duplicates
    vq, vs = quantize_rows(flatten_heads(torch.from_numpy(vis)))
    got = _run(tmp_path, _sim_rank, txt, vis, gt, vq.numpy(), vs.numpy(), k)
    assert got["shard"] == 102

    mesh = jax_mesh(RANKS)
    assert mesh.devices.size == RANKS and len(jax.devices()) >= RANKS
    ref_ranks = jax_sim.sharded_t2v_ranks(jnp.asarray(txt), jnp.asarray(vis), jnp.asarray(gt),
                                          mesh)
    np.testing.assert_array_equal(got["ranks"], ref_ranks)
    assert (got["ranks"][4:10] > 1).any()  # tied ground truths rank behind their copies

    jq, js = jax_quantized.quantize_rows(jax_flatten(jnp.asarray(vis)))
    np.testing.assert_array_equal(np.asarray(jq), vq.numpy())  # one quantization
    refs = {"topk": jax_sim.sharded_topk(jnp.asarray(txt), jnp.asarray(vis), k, mesh),
            "int8": jax_sim.sharded_int8_topk(jnp.asarray(txt), jq, js, k, mesh)}
    tn = flatten_heads(torch.from_numpy(txt))
    tq, ts = quantize_rows(tn)
    port_scores = {"topk": tn @ flatten_heads(torch.from_numpy(vis)).T,
                   "int8": int8_scores(tq, ts, vq, vs)}
    for name, (ref_vals, ref_idx) in refs.items():
        vals, idx = got[name]
        assert vals.shape == idx.shape == (t, k)
        np.testing.assert_allclose(vals, ref_vals, rtol=0, atol=TOL)
        ties = 0
        for q in range(t):
            ref_q, cut = _port_order(ref_vals[q], ref_idx[q], TOL)
            np.testing.assert_array_equal(idx[q][:cut], ref_q[:cut])
            ties += int((np.diff(ref_vals[q]) == 0).sum())
        assert ties > 0, name  # the duplicates tie in every list of queries 0-3
        # exactly the port's one-process order over the whole gallery
        one_vals, one_idx = ordered_topk(port_scores[name], k)
        np.testing.assert_array_equal(idx, one_idx.numpy())
        np.testing.assert_allclose(vals, one_vals.numpy(), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

def _jax_spec(dropout):
    from laff_tpu.models import AttentionSpec, GruSpec, LAFFSpec, TowerSpec

    attn = AttentionSpec(kind="Multi_head_MyApply_Attention", heads=4, with_ave=False,
                         mul=False, split_head=True)
    txt = TowerSpec(features=(("rnn", 16), ("bow", 30), ("w2v", 8)), common_dim=32,
                    attention=attn, batch_norm=True, dropout=dropout,
                    gru=GruSpec(vocab_size=25, we_dim=8, rnn_size=16))
    vis = TowerSpec(features=(("clip_ft", 12), ("x3d", 20)), common_dim=32, attention=attn,
                    batch_norm=True, dropout=dropout)
    return LAFFSpec(txt=txt, vis=vis)


def _step_batch(rng, b=16):
    txt = {"rnn_ids": rng.integers(1, 25, (b, 9)).astype(np.int32),
           "rnn_len": rng.integers(2, 10, (b,)).astype(np.int32),
           "bow": rng.poisson(0.3, (b, 30)).astype(np.float32),
           "w2v": rng.standard_normal((b, 8)).astype(np.float32)}
    vis = {"clip_ft": rng.standard_normal((b, 12)).astype(np.float32),
           "x3d": rng.standard_normal((b, 20)).astype(np.float32)}
    return txt, vis


def _step(spec_dict, state_dict, txt, vis, mesh=None):
    """One optimizer step (``trainer.TrainStep`` over ``OptaxChain``): the
    loss, the summed gradients by name, the parameters and BatchNorm
    statistics after it. With a mesh, on this rank's rows."""
    from laff_tpu_torch.engine.optim import OptaxChain
    from laff_tpu_torch.engine.trainer import TrainStep
    from laff_tpu_torch.models import LAFFModel
    from laff_tpu_torch.models.spec import spec_from_dict

    model = LAFFModel(spec_from_dict(spec_dict))
    model.load_state_dict(state_dict)
    opt = OptaxChain(model.parameters(), "adam", 1e-3, mesh=mesh)
    step = TrainStep(model, opt, model.spec, mesh=mesh)
    txt = {k: torch.from_numpy(v) for k, v in txt.items()}
    vis = {k: torch.from_numpy(v) for k, v in vis.items()}
    if mesh is not None:
        txt, vis = (shard_batch(x, mesh, from_global=True) for x in (txt, vis))
    loss = step(txt, vis, torch.Generator().manual_seed(11))
    return {"loss": float(loss),
            "grads": {n: p.grad.clone().numpy() for n, p in model.named_parameters()},
            "state": {n: v.detach().clone().numpy() for n, v in model.state_dict().items()}}


def _step_rank(mesh, cases):
    torch.set_num_threads(1)
    return [_step(*case, mesh=mesh) for case in cases]


def test_data_parallel_step_matches_global_batch_and_laff_tpu(tmp_path):
    import jax
    import jax.numpy as jnp

    from laff_tpu.engine.trainer import make_loss_fn as jax_loss_fn
    from laff_tpu.models import LAFFModel as FlaxLAFF
    from laff_tpu.parallel import data_parallel_mesh as jax_mesh
    from laff_tpu.parallel import shard_batch as jax_shard
    from laff_tpu_torch.engine.weights import from_jax_variables

    rng = np.random.default_rng(3)
    txt, vis = _step_batch(rng)
    cases, jax_grads = [], None
    for dropout in (0.2, 0.0):
        spec = _jax_spec(dropout)
        flax_model = FlaxLAFF(spec)
        jtxt = {k: jnp.asarray(v) for k, v in txt.items()}
        jvis = {k: jnp.asarray(v) for k, v in vis.items()}
        variables = flax_model.init({"params": jax.random.key(4), "dropout": jax.random.key(5)},
                                    jtxt, jvis)
        host = jax.tree_util.tree_map(np.asarray, variables)
        sd = from_jax_variables(host["params"], host["batch_stats"], host.get("schedule"))
        cases.append((dataclasses.asdict(spec), sd, txt, vis))
        if dropout == 0.0:  # laff_tpu's sharded gradient, batch statistics over the mesh
            loss_fn = jax_loss_fn(spec)

            def loss(params, t, v):
                (te, ve), _ = flax_model.apply(
                    {**variables, "params": params}, t, v, train=True,
                    rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
                return loss_fn(te, ve)

            mesh = jax_mesh(RANKS)
            grads = jax.jit(jax.grad(loss))(variables["params"], jax_shard(jtxt, mesh),
                                            jax_shard(jvis, mesh))
            jax_grads = from_jax_variables(jax.tree_util.tree_map(np.asarray, grads))

    got = _run(tmp_path, _step_rank, cases)
    for case, dp in zip(cases, got):
        one = _step(*case)
        assert abs(dp["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
        largest = max(float(np.abs(g).max()) for g in one["grads"].values())
        for name, g in one["grads"].items():  # (a bias before BatchNorm has none)
            assert float(np.abs(dp["grads"][name] - g).max()) <= 1e-5 * largest, name
        for name, value in one["state"].items():
            # Adam's first step moves each parameter by about lr = 1e-3 whatever its
            # gradient's size, and a small gradient's 1e-5 difference moves it by
            # up to about 1e-5 of that; the running statistics come from the forward
            tol = 1e-5 if name in one["grads"] else 1e-6
            if value.dtype.kind == "f":
                np.testing.assert_allclose(dp["state"][name], value, rtol=0, atol=tol,
                                           err_msg=name)
    assert jax_grads is not None
    assert set(got[1]["grads"]) <= set(jax_grads)
    for name, g in got[1]["grads"].items():
        np.testing.assert_allclose(g, jax_grads[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# trainer.main, the predictor and the service over the mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from laff_tpu.data.synth import build_collection, build_w2v

    root = str(tmp_path_factory.mktemp("dp_world"))
    for coll, n, caps, seed in (("toytrain", 32, 2, 0), ("toyval", 16, 1, 5)):
        build_collection(root, coll, n_videos=n, caps_per_video=caps, seed=seed)
    build_w2v(root)
    return root


def _quiet_config(config):
    config.dropout = 0.0  # the two packages draw dropout from other generators
    return config


def _train_rank(mesh, opt):
    torch.set_num_threads(1)
    from laff_tpu_torch.engine import prepare, trainer

    load = prepare.load_config
    prepare.load_config = lambda name, parm="None": _quiet_config(load(name, parm))
    opt = dataclasses.replace(opt, model_prefix=f"{opt.model_prefix}_rank{mesh.rank}")
    result = trainer.main(opt, mesh=mesh)
    return {"history": result["history"], "model_path": result["model_path"],
            "state": {k: v.clone() for k, v in result["model"].state_dict().items()}}


def test_trainer_main_over_two_ranks_matches_laff_tpu(world, tmp_path, monkeypatch):
    import importlib

    import jax

    from laff_tpu.engine import Options as JOptions
    from laff_tpu.engine import trainer as jax_trainer
    from laff_tpu.parallel import data_parallel_mesh as jax_mesh
    from laff_tpu_torch.engine import prepare as port_prepare
    from laff_tpu_torch.engine.checkpoint import (checkpoint_payload, load_checkpoint,
                                                  save_checkpoint)
    from laff_tpu_torch.engine.weights import from_jax_variables
    from laff_tpu_torch.models import LAFFModel

    jax_prepare = importlib.import_module("laff_tpu.engine.prepare")
    jload = jax_prepare.load_config
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: _quiet_config(jload(name)))
    pload = port_prepare.load_config
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": _quiet_config(pload(name, parm)))
    base = dict(trainCollection="toytrain", valCollection="toyval", rootpath=world,
                val_set="no", config_name="tiny", num_epochs=2, batch_size=16)
    jopt = JOptions(model_prefix="jax_dp", **base)
    jprep = jax_prepare.prepare(jopt)
    init = jax_trainer.init_state(jax_trainer.LAFFModel(jprep.spec), jprep.spec, jprep,
                                  jax_trainer.make_optimizer(jprep.config, jprep.spec),
                                  seed=jopt.random_seed)
    jres = jax_trainer.main(jopt, prepared=jprep, mesh=jax_mesh(RANKS))

    pprep = port_prepare.prepare(port_prepare.Options(model_prefix="init", device="cpu", **base))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_path = str(tmp_path / "init.pt")
    save_checkpoint(checkpoint_payload(
        from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule)),
        pprep.spec, pprep.config, pprep.featurizers, {}), init_path)
    popt = port_prepare.Options(model_prefix="port_dp", device="cpu",
                                pretrained_file_path=init_path, **base)
    got = _run(tmp_path, _train_rank, popt)
    assert len(got["history"]) == len(jres["history"]) == 2
    for pe, je in zip(got["history"], jres["history"]):
        assert pe["loss"] == pytest.approx(je["loss"], rel=1e-4)
        assert pe["lr"] == je["lr"]
    main_dir = got["model_path"]
    assert main_dir.endswith("port_dp_rank0")
    assert {"model_best.pth.tar", "val_perf.txt", "val_perf_hist.txt",
            "scalars.tsv"} <= set(os.listdir(main_dir))
    assert os.listdir(main_dir[:-1] + "1") == []  # rank 1 wrote nothing
    # the checkpoint loads on one device and holds rank 0's weights (the last
    # epoch is the best one here)
    ckpt = load_checkpoint(os.path.join(main_dir, "model_best.pth.tar"))
    assert ckpt["epoch"] == 2
    LAFFModel(ckpt["spec"]).load_state_dict(ckpt["state_dict"])
    for k, v in got["state"].items():
        assert torch.equal(ckpt["state_dict"][k], v), k


def _predict_opts(root, ckpt, sim, tmp_path):
    from laff_tpu_torch.engine.predictor import PredictOptions

    return PredictOptions(testCollection="toyval", model_path=ckpt, sim_name=sim,
                          rootpath=root, query_sets="toyval.caption.txt", batch_size=8,
                          overwrite=1, device="cpu",
                          predict_result_file=str(tmp_path / "result_log" / f"{sim}.txt"))


def _predict_rank(mesh, runs):
    torch.set_num_threads(1)
    from laff_tpu_torch.engine import predictor

    out = []
    for opt, large in runs:
        predictor.LARGE_GALLERY = large
        res = predictor.main(opt, mesh=mesh)
        # rank 0 alone ranks: rank 1's result is empty
        out.append((res.get("toyval.caption.txt"), mesh.broadcast_object(res == {}, src=1)))
    return out


def test_predictor_data_parallel_matches_single(world, tmp_path, monkeypatch):
    from laff_tpu_torch.engine import predictor
    from laff_tpu_torch.engine.checkpoint import save_checkpoint
    from laff_tpu_torch.engine.prepare import init_checkpoint

    ckpt = str(tmp_path / "init.pt")
    save_checkpoint(init_checkpoint("tiny", world, "toytrain", 3), ckpt)
    large = {"whole": predictor.LARGE_GALLERY, "streamed": 10}  # toyval has 16 videos
    runs = [(_predict_opts(world, ckpt, f"dp_{name}", tmp_path), n) for name, n in large.items()]
    got = _run(tmp_path, _predict_rank, runs)
    for (opt, n), (dp, rank1_empty) in zip(runs, got):
        assert rank1_empty
        monkeypatch.setattr(predictor, "LARGE_GALLERY", n)
        one = predictor.main(dataclasses.replace(
            opt, sim_name=opt.sim_name + "_one",
            predict_result_file=opt.predict_result_file.replace(".txt", "_one.txt")))
        one = one["toyval.caption.txt"]
        assert ("v2t_ranks" in dp) == (n == 10)  # the streamed branch
        np.testing.assert_array_equal(dp["t2v_ranks"], one["t2v_ranks"])
        np.testing.assert_allclose(dp["t2v"], one["t2v"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(dp["v2t"], one["v2t"], rtol=0, atol=1e-5)
        for side in ("TextToVideo", "VideoToText"):  # written once, by rank 0
            path = os.path.join(os.path.dirname(opt.predict_result_file), side,
                                os.path.basename(opt.predict_result_file))
            assert len(open(path).read().splitlines()) == 1


@pytest.fixture(scope="module")
def avs_world(tmp_path_factory):
    """An AVS collection of 40 shots over a 30-video train collection's
    vocabulary, with a query set whose first topic carries a negated
    clause."""
    from laff_tpu.data.synth import build_w2v
    from laff_tpu_torch.data import synth

    root = str(tmp_path_factory.mktemp("dp_avs_world"))
    synth.build_world(root, "dptrain", n_videos=30, caps_per_video=2, n_vocab=60, seed=1)
    build_w2v(root, word_pool=[f"w{i:05d}" for i in range(60)])  # the tiny config's table
    synth.build_avs_world(root, "iacc.3", n_videos=40, editions=("tv16",), topics_per_edition=3,
                          n_vocab=60, seed=2, relevant=(2, 5))
    tdir = os.path.join(root, "iacc.3", "TextData")
    topics = open(os.path.join(tdir, "tv16.avs.txt")).read().splitlines()
    with open(os.path.join(tdir, "neg.avs.txt"), "w") as fh:
        fh.write("\n".join([topics[0] + " not w00007", *topics[1:]]))
    return root


def _avs_rank(mesh, runs):
    torch.set_num_threads(1)
    from laff_tpu_torch.engine import predictor

    empty = []
    for opt, large in runs:
        predictor.LARGE_GALLERY = large
        empty.append(mesh.broadcast_object(predictor.main(opt, mesh=mesh) == {}, src=1))
    return empty


def test_predictor_data_parallel_avs_int8_and_negation(avs_world, tmp_path, monkeypatch):
    """The AVS paths whose other ranks follow rank 0 through their own
    collectives (the int8 stream's union broadcast, the negation clauses'
    embeddings over a streamed and a whole gallery) write the score files of
    a single run."""
    from laff_tpu_torch.engine import predictor
    from laff_tpu_torch.engine.checkpoint import save_checkpoint
    from laff_tpu_torch.engine.prepare import init_checkpoint

    ckpt = str(tmp_path / "avs.pt")
    save_checkpoint(init_checkpoint("tiny", avs_world, "dptrain", 3), ckpt)
    cases = {"int8": ("tv16.avs.txt", 5, {"int8_gallery": 1}),
             "neg_streamed": ("neg.avs.txt", 5, {"task3_caption": "negation"}),
             "neg_whole": ("neg.avs.txt", predictor.LARGE_GALLERY, {"task3_caption": "negation"})}

    def opt_of(name, who):
        query_set, _, extra = cases[name]
        return predictor.PredictOptions(
            testCollection="iacc.3", model_path=ckpt, sim_name=f"{who}_{name}",
            rootpath=avs_world, query_sets=query_set, batch_size=8, overwrite=1, device="cpu",
            predict_result_file=str(tmp_path / "result_log" / f"{who}_{name}.txt"), **extra)

    got = _run(tmp_path, _avs_rank, [(opt_of(name, "dp"), cases[name][1]) for name in cases])
    assert all(got)  # rank 1 returned nothing
    for name, (query_set, large, _) in cases.items():
        monkeypatch.setattr(predictor, "LARGE_GALLERY", large)
        predictor.main(opt_of(name, "one"))
        rows = {}
        for who in ("dp", "one"):
            path = os.path.join(avs_world, "iacc.3", "SimilarityIndex", query_set,
                                f"{who}_{name}", "id.sent.score.txt")
            rows[who] = [line.split() for line in open(path).read().splitlines()]
        assert len(rows["dp"]) == len(rows["one"]) == 3
        for a, b in zip(rows["dp"], rows["one"]):
            assert a[0] == b[0] and a[1::2] == b[1::2], name  # the query, its shots in order
            np.testing.assert_allclose(np.asarray(a[2::2], float), np.asarray(b[2::2], float),
                                       rtol=0, atol=1e-5, err_msg=name)


def _extra(rng, n):
    return ([f"new{i}" for i in range(n)],
            {"clip_ft": rng.standard_normal((n, 16)).astype(np.float32),
             "x3d": rng.standard_normal((n, 12)).astype(np.float32)})


def _service_session(svc, queries, extra):
    """Searches, an ingest, searches again (rank 0 of a mesh drives)."""
    out = {"before": svc.search(queries, k=7)}
    svc.add_videos(*extra)
    out["after"] = svc.search(queries, k=30)
    return out


def _serve_rank(mesh, ckpt, root, queries, extra, snap):
    torch.set_num_threads(1)
    from laff_tpu_torch.engine.service import RetrievalService

    out = {}
    for dtype in ("bf16", "int8"):
        cache = snap if dtype == "bf16" else None
        for name in (("first", "restored") if cache else ("first",)):
            svc = RetrievalService(ckpt, root, "toyval", gallery_dtype=dtype, capacity=40,
                                   gallery_cache=cache, mesh=mesh)
            if mesh.is_main:
                out[(dtype, name)] = _service_session(svc, queries, extra)
                out[(dtype, name, "slab")] = svc.slab
                svc.close()
            else:
                svc.follow()
    return out


def test_service_over_mesh_matches_one_device(world, tmp_path):
    from laff_tpu_torch.engine.checkpoint import save_checkpoint
    from laff_tpu_torch.engine.prepare import init_checkpoint
    from laff_tpu_torch.engine.service import RetrievalService

    ckpt = str(tmp_path / "serve.pt")
    save_checkpoint(init_checkpoint("tiny", world, "toytrain", 4), ckpt)
    capfile = os.path.join(world, "toyval", "TextData", "toyval.caption.txt")
    queries = [line.split(" ", 1)[1].strip() for line in open(capfile)][:6]
    extra = _extra(np.random.default_rng(8), 6)  # live rows 16-21: slots of both slabs
    snap = str(tmp_path / "gallery.npz")
    got = _run(tmp_path, _serve_rank, ckpt, world, queries, extra, snap)
    assert got[("bf16", "first", "slab")] == 20

    def same(a, b):
        for row_a, row_b in zip(a, b):
            assert [i for i, _ in row_a] == [i for i, _ in row_b]
            np.testing.assert_allclose([s for _, s in row_a], [s for _, s in row_b], rtol=0,
                                       atol=TOL)

    for dtype in ("bf16", "int8"):
        one = RetrievalService(ckpt, world, "toyval", gallery_dtype=dtype, capacity=40,
                               device="cpu")
        want = _service_session(one, queries, extra)
        for key in [k for k in got if k[0] == dtype and len(k) == 2]:
            for when in ("before", "after"):
                same(got[key][when], want[when])
        assert any(i.startswith("new") for row in want["after"] for i, _ in row)
    # the mesh's snapshot is the one-card file: a one-device service restores it
    restored = RetrievalService(ckpt, world, "toyval", capacity=40, gallery_cache=snap,
                                device="cpu")
    same(restored.search(queries, k=7), got[("bf16", "first")]["before"])


# ---------------------------------------------------------------------------
# the mesh's host helpers
# ---------------------------------------------------------------------------

def test_shard_batch_and_single_process_mesh(monkeypatch):
    """shard_batch(from_global=True) keeps this rank's contiguous rows of
    every array (laff_tpu's process-major slice) and raises where the batch
    does not divide; from_global=False leaves a process's own rows as they
    are. initialize_multihost is a no-op in one process (no torchrun
    environment) and reports one process, as laff_tpu's."""
    from laff_tpu_torch.parallel import Mesh, initialize_multihost

    mesh = Mesh(rank=1, size=2, device=torch.device("cpu"))
    batch = {"a": np.arange(8).reshape(4, 2), "b": torch.arange(4)}
    got = shard_batch(batch, mesh, from_global=True)
    np.testing.assert_array_equal(got["a"], [[4, 5], [6, 7]])
    assert got["b"].tolist() == [2, 3]
    stacked = shard_batch(np.zeros((3, 4, 5)), mesh, axis_index=1, from_global=True)
    assert stacked.shape == (3, 2, 5)
    assert shard_batch(batch, mesh) is batch
    with pytest.raises(ValueError, match="must divide by 2 ranks"):
        shard_batch(np.zeros((3, 2)), mesh, from_global=True)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == 1
    assert not dist.is_initialized()
