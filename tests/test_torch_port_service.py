"""The retrieval service and its HTTP server on the CPU, held against
laff_tpu's (``tests/test_service.py``'s cases).

One laff_tpu training run of the tiny config gives a checkpoint; its
weights, carried by ``from_jax_variables``, make the port's. Each case puts
laff_tpu's ``RetrievalService`` and the port's over the same gallery and
asks both the same: ids equal and scores within 1e-5 on this tie-free
data, for the bf16 gallery (also scored in blocks of 7 rows, which merges
the blocks' top k), the int8 one (and its warning), live ingest into the
capacity slots and back-to-back padded writes, the HTTP endpoints with and
without micro-batching (and ``do_server``'s own service), a FrameLAFF
checkpoint, the ``MicroBatcher`` against direct calls, the gallery
snapshot's round trip, and the metrics. The rejections (measure 'hist',
also over a mesh, and a precomputed-only text modality), ``--mesh_devices``
handing its ranks to the launcher, and the tie order, which differs on
purpose: on tied gallery rows the port lists equal scores in decreasing
gallery index, ``lax.top_k`` in increasing.
"""

import importlib
import json
import logging
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.configs import tiny as jax_tiny
from laff_tpu.configs import tiny_frame as jax_tiny_frame
from laff_tpu.data.synth import build_collection, build_w2v
from laff_tpu.engine import Options as JOptions
from laff_tpu.engine import service as jax_service
from laff_tpu.engine import trainer as jax_trainer
from laff_tpu.engine.checkpoint import load_checkpoint as jax_load
from laff_tpu.store.bigfile import BigFile
from laff_tpu_torch import parallel as port_parallel
from laff_tpu_torch.cli import do_server
from laff_tpu_torch.configs import tiny as port_tiny
from laff_tpu_torch.configs import tiny_frame as port_tiny_frame
from laff_tpu_torch.engine import prepare as port_prepare
from laff_tpu_torch.engine import service as port_service
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint
from laff_tpu_torch.engine.weights import from_jax_variables

jax_prepare = importlib.import_module("laff_tpu.engine.prepare")

TOL = 1e-5
TEST = "toytest"


def _carry(root, jres, config_name, port_config, path, monkeypatch):
    """The port's checkpoint of laff_tpu's trained weights."""
    monkeypatch.setattr(port_prepare, "load_config",
                        lambda name, parm="None": port_config.config())
    pprep = port_prepare.prepare(port_prepare.Options(
        trainCollection="toytrain", valCollection="toyval", rootpath=root, val_set="no",
        config_name=config_name, model_prefix="port_carry", device="cpu"))
    jck = jax_load(os.path.join(jres["model_path"], "model_best.pth.tar"))
    sd = from_jax_variables(jck["params"], jck["batch_stats"], jck["schedule"])
    save_checkpoint(checkpoint_payload(sd, pprep.spec, pprep.config, pprep.featurizers,
                                       {"trainCollection": "toytrain",
                                        "config_name": config_name}), path)
    return os.path.join(jres["model_path"], "model_best.pth.tar"), path


def _trained_world(root, config_name, jax_config, port_config, monkeypatch, frames=False,
                   epochs=3):
    for coll, n, caps, seed in (("toytrain", 24, 2, 0), ("toyval", 12, 1, 5),
                                (TEST, 20, 1, 9)):
        build_collection(root, coll, n_videos=n, caps_per_video=caps, seed=seed,
                         frame_feat=frames)
    build_w2v(root)
    monkeypatch.setattr(jax_prepare, "load_config", lambda name: jax_config.config())
    jres = jax_trainer.main(JOptions(
        trainCollection="toytrain", valCollection="toyval", rootpath=root, val_set="no",
        config_name=config_name, num_epochs=epochs, batch_size=12, model_prefix="serve"))
    return _carry(root, jres, config_name, port_config, os.path.join(root, "port_serve.pt"),
                  monkeypatch)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        root = str(tmp_path_factory.mktemp("serve"))
        jck, pck = _trained_world(root, "tiny", jax_tiny, port_tiny, mp)
    finally:
        mp.undo()
    return root, jck, pck


@pytest.fixture(scope="module")
def jax_bf16(served):
    root, jck, _ = served
    return jax_service.RetrievalService(jck, root, TEST)


def port(served, **kw):
    root, _, pck = served
    return port_service.RetrievalService(pck, root, TEST, device="cpu", **kw)


def captions(root, coll=TEST):
    path = os.path.join(root, coll, "TextData", f"{coll}.caption.txt")
    return [line.strip().split(" ", 1)[1] for line in open(path) if line.strip()]


def same_results(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,block", [("bf16", None), ("bf16", 7), ("int8", None)])
def test_search_matches_laff_tpu(served, jax_bf16, monkeypatch, dtype, block):
    root, jck, _ = served
    if block:
        monkeypatch.setattr(port_service, "SCORE_BLOCK", block)
    caps = captions(root)
    ref = jax_bf16 if dtype == "bf16" else jax_service.RetrievalService(
        jck, root, TEST, gallery_dtype="int8")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    port_service.logger.addHandler(handler)  # the port's loggers do not propagate
    try:
        svc = port(served, gallery_dtype=dtype)
    finally:
        port_service.logger.removeHandler(handler)
    assert any("not cosine-exact" in r.getMessage() for r in records) == (dtype == "int8")
    assert svc.vis_ids == ref.vis_ids and svc.heads == ref.heads
    same_results(svc.search(caps, k=5), ref.search(caps, k=5))
    same_results(svc.search(caps[:3], k=2), ref.search(caps[:3], k=2))  # bucket 8
    same_results(svc.search(caps[:1], k=50), ref.search(caps[:1], k=50))  # k above the gallery
    if dtype == "int8":  # laff_tpu's test_service_int8_matches_bf16_order
        exact = jax_bf16.search(caps[:6], k=3)
        assert [e[0][0] for e in exact] == [q[0][0] for q in svc.search(caps[:6], k=3)]


def _extra_features(root, coll, seed, lo, hi):
    build_collection(root, coll, n_videos=6, caps_per_video=1, seed=seed)
    return {n: BigFile(os.path.join(root, coll, "FeatureData", n)).gather(
        [f"video{i}" for i in range(lo, hi)])[1] for n in ("clip_ft", "x3d")}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_ingest_matches_laff_tpu(served, dtype):
    """add_videos into the capacity slots, back-to-back ingests into a
    roomy gallery, and the guards, against laff_tpu's."""
    root, jck, _ = served
    feats = _extra_features(root, f"toyextra_{dtype}", 21, 0, 4)
    ids = [f"xv{i}" for i in range(4)]
    probe = ["the dog runs in the park"]
    svc = port(served, gallery_dtype=dtype, capacity=24)
    ref = jax_service.RetrievalService(jck, root, TEST, gallery_dtype=dtype, capacity=24)
    assert svc.capacity == 24 and svc.search(probe, k=24) and len(svc.vis_ids) == 20
    assert svc.add_videos(ids, feats) == ref.add_videos(ids, feats) == 24
    same_results(svc.search(probe, k=24), ref.search(probe, k=24))
    with pytest.raises(ValueError, match="already served"):
        svc.add_videos(["xv0"], {k: v[:1] for k, v in feats.items()})
    with pytest.raises(ValueError, match="capacity"):
        svc.add_videos(["y0"], {k: v[:1] for k, v in feats.items()})
    with pytest.raises(ValueError, match="rows"):
        port(served, gallery_dtype=dtype, capacity=30).add_videos(
            ["z0", "z1"], {k: v[:1] for k, v in feats.items()})
    # back to back into a roomy gallery: each write lands after the last
    roomy, ref = (port(served, gallery_dtype=dtype, capacity=200),
                  jax_service.RetrievalService(jck, root, TEST, gallery_dtype=dtype,
                                               capacity=200))
    for svc_ in (roomy, ref):
        assert svc_.add_videos(["pa", "pb"], {k: v[:2] for k, v in feats.items()}) == 22
        assert svc_.add_videos(["pc"], {k: v[2:3] for k, v in feats.items()}) == 23
    got = roomy.search(["the dog runs"], k=23)
    same_results(got, ref.search(["the dog runs"], k=23))
    assert {"pa", "pb", "pc"} <= {i for i, _ in got[0]} and len({i for i, _ in got[0]}) == 23


def _get(port_, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port_}{path}", timeout=60) as r:
        return json.loads(r.read())


def _post(port_, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port_}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _status(port_, path, body):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port_, path, body)
    return exc.value.code


@pytest.mark.parametrize("window_ms", [0.0, 10.0])
def test_http_server(served, jax_bf16, window_ms):
    """do_server's own service (``build_server``), with and without the
    micro-batcher: /healthz, /search from concurrent clients (laff_tpu's
    rankings), the 400s, /ingest into capacity, /metrics."""
    root, _, pck = served
    args = do_server.parse_args([TEST, pck, "--rootpath", root, "--port", "0", "--device",
                                 "cpu", "--capacity", "21", "--batch_window_ms",
                                 str(window_ms)])
    server, svc, batcher = do_server.build_server(args)
    assert (batcher is None) == (window_ms == 0)
    port_ = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        health = _get(port_, "/healthz")
        assert health == {"ok": True, "gallery": 20, "dtype": "bf16", "heads": 4}
        caps = captions(root)[:4]
        results = {}

        def client(i):
            results[i] = _post(port_, "/search", {"queries": [caps[i]], "k": 3})["results"][0]

        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        want = jax_bf16.search(caps, k=3)
        same_results([[(e["id"], e["score"]) for e in results[i]] for i in range(4)], want)
        assert _status(port_, "/search", {"queries": "not a list"}) == 400
        assert _status(port_, "/search", {"queries": ["a dog"], "k": 0}) == 400
        assert _status(port_, "/search", {"queries": ["a dog"], "k": True}) == 400
        assert _status(port_, "/ingest", {"ids": "zz"}) == 400
        row = {"clip_ft": [[0.1] * 16], "x3d": [[0.2] * 12]}
        assert _post(port_, "/ingest", {"ids": ["zz"], "features": row}) == {
            "count": 21, "capacity": 21}
        assert _status(port_, "/ingest", {"ids": ["zy"], "features": row}) == 400  # full
        assert _status(port_, "/nowhere", {}) == 404
        metrics = _get(port_, "/metrics")
        assert metrics["gallery"] == 21 and metrics["ingested_rows"] == 1
        assert metrics["queries"] >= 4
        if batcher is not None:
            assert metrics["batched_requests"] == 4
            assert metrics["fused_dispatches"] <= 4
    finally:
        server.shutdown()
        server.server_close()
        if batcher is not None:
            batcher.close()
    thread.join(timeout=30)
    assert not thread.is_alive() and (batcher is None or not batcher._thread.is_alive())


def test_service_frame_laff(tmp_path, monkeypatch):
    """A FrameLAFF checkpoint serves too: the gallery feed carries the
    padded frame arrays through the two-level tower."""
    root = str(tmp_path)
    jck, pck = _trained_world(root, "tiny_frame", jax_tiny_frame, port_tiny_frame, monkeypatch,
                              frames=True, epochs=2)
    ref = jax_service.RetrievalService(jck, root, TEST)
    svc = port_service.RetrievalService(pck, root, TEST, device="cpu")
    assert svc.spec.vis.frame_features
    caps = captions(root)[:5] + ["the dog runs fast"]
    same_results(svc.search(caps, k=4), ref.search(caps, k=4))


@pytest.mark.parametrize("case", ["hist", "precomputed", "mesh", "mesh_devices", "no_card"])
def test_service_rejections(served, tmp_path, monkeypatch, case):
    if case == "no_card":  # the card unless the caller names the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert do_server.parse_args(["c", "m"]).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_service.RetrievalService(served[2], served[0], TEST)
        return
    if case == "mesh_devices":  # served over N ranks (tests/test_torch_port_parallel.py)
        calls = []
        monkeypatch.setattr(port_parallel, "launch",
                            lambda n, target, args, device: calls.append((n, target, device)))
        assert do_server.main(["c", "m", "--mesh_devices", "4", "--device", "cpu"]) == 0
        assert calls == [(4, do_server.serve_rank, "cpu")]
        return

    class Cfg:
        measure = "hist" if case in ("hist", "mesh") else "cosine"

    monkeypatch.setattr(port_service, "load_checkpoint",
                        lambda p: {"config": Cfg(), "state_dict": {}, "spec": None})
    monkeypatch.setattr(port_service, "rebuild_featurizers",
                        lambda ckpt, rootpath, device: {"clip": None, "bow": object()})
    # over a mesh (a rank of a launched group, served since the mesh slice)
    # the same checks hold, before any collective
    mesh = (port_parallel.Mesh(rank=0, size=2, device=torch.device("cpu"))
            if case == "mesh" else None)
    with pytest.raises(ValueError, match="measure" if case in ("hist", "mesh")
                       else "precomputed-only"):
        port_service.RetrievalService("x", str(tmp_path), "none", device="cpu", mesh=mesh)


def test_micro_batcher_matches_direct(served):
    """Concurrent searches through the MicroBatcher return what direct
    calls return, in fewer dispatches; a bad k raises for its caller;
    close joins the dispatcher thread."""
    root = served[0]
    svc = port(served)
    caps = captions(root)
    direct = {i: svc.search([caps[i]], k=5)[0] for i in range(8)}
    mb = port_service.MicroBatcher(svc, window_ms=25.0)
    try:
        out, errs = {}, []

        def worker(i, k):
            try:
                out[(i, k)] = mb.search([caps[i]], k=k)[0]
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i, 5)) for i in range(8)]
        threads.append(threading.Thread(target=worker, args=(0, 2)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs
        for i in range(8):
            same_results([out[(i, 5)]], [direct[i]])
        same_results([out[(0, 2)]], [direct[0][:2]])
        assert mb.dispatches < 9 and mb.requests == 9
        with pytest.raises(ValueError):
            mb.search(["anything"], k=0)
    finally:
        mb.close()
    assert not mb._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        mb.search(["anything"])


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gallery_snapshot_roundtrip(served, tmp_path, dtype):
    """A restored snapshot serves what the fresh embed served, bit for bit;
    it holds laff_tpu's arrays under laff_tpu's names; a restored gallery
    ingests; a touched checkpoint invalidates it."""
    root, jck, pck = served
    caps = captions(root)[:4]
    cache = str(tmp_path / f"gal_{dtype}.npz")
    fresh = port(served, gallery_dtype=dtype, gallery_cache=cache)
    want = fresh.search(caps, k=5)
    restored = port(served, gallery_dtype=dtype, gallery_cache=cache)
    assert restored.vis_ids == fresh.vis_ids and restored.search(caps, k=5) == want
    ref_cache = str(tmp_path / f"ref_{dtype}.npz")
    jax_service.RetrievalService(jck, root, TEST, gallery_dtype=dtype, gallery_cache=ref_cache)
    ours, theirs = np.load(cache), np.load(ref_cache)
    assert sorted(ours.files) == sorted(theirs.files)
    assert str(ours["key"]).split("|")[1:] != [] and str(ours["key"]).startswith(
        os.path.abspath(pck) + "|")
    for name in ours.files:
        if name == "key":
            continue
        assert ours[name].dtype == theirs[name].dtype and ours[name].shape == theirs[name].shape
        if name == "vn_bf16":  # the same rows to a bf16 rounding
            a, b = (torch.from_numpy(x[name].view(np.int16)).view(torch.bfloat16).float()
                    for x in (ours, theirs))
            assert float((a - b).abs().max()) <= 1e-2
        elif name in ("vis_ids", "heads"):
            assert (ours[name] == theirs[name]).all()
    svc = port(served, gallery_dtype=dtype, gallery_cache=cache, capacity=25)
    rng = np.random.default_rng(3)
    feats = {"clip_ft": rng.standard_normal((2, 16)).astype(np.float32),
             "x3d": rng.standard_normal((2, 12)).astype(np.float32)}
    assert svc.add_videos(["zz1", "zz2"], feats) == 22
    mtime = os.path.getmtime(pck)
    try:
        os.utime(pck, (1, 1))
        again = port(served, gallery_dtype=dtype, gallery_cache=cache)
        assert again.search(caps, k=5) == want  # re-embedded: the same model
        assert str(np.load(cache)["key"]).split("|")[1] == f"{1.0:.6f}"
    finally:
        os.utime(pck, (mtime, mtime))


def test_service_metrics(served):
    root = served[0]
    svc = port(served)
    caps = captions(root)
    svc.search(caps[:3], k=2)
    svc.search(caps[:1], k=2)
    m = svc.metrics()
    assert m["searches"] == 2 and m["queries"] == 4
    assert m["gallery"] == 20 and m["dtype"] == "bf16" and m["heads"] == 4
    assert m["search_seconds"] > 0 and m["search_seconds_max"] <= m["search_seconds"]
    mb = port_service.MicroBatcher(svc, window_ms=1.0)
    try:
        front = do_server._Front(svc, mb)
        front.search(caps[:2], k=2)
        m = front.metrics()
        assert m["batched_requests"] == 1 and m["fused_dispatches"] == 1
        assert m["searches"] == 3
    finally:
        mb.close()


def test_tied_gallery_rows_list_in_decreasing_index(served, jax_bf16, monkeypatch):
    """Gallery rows 2, 5, 9 and 14 set equal to row 11: every query scores
    them alike. The port lists the tied videos in decreasing gallery index
    (the port's rule for every top-k list), laff_tpu's lax.top_k in
    increasing; otherwise the lists agree. Blocks of 4 rows put the tied
    rows in different blocks."""
    root, jck, _ = served
    monkeypatch.setattr(port_service, "SCORE_BLOCK", 4)
    tied = [2, 5, 9, 11, 14]
    svc = port(served)
    svc._vn[tied] = svc._vn[11].clone()
    ref = jax_service.RetrievalService(jck, root, TEST)
    ref._vn = ref._vn.at[jnp.asarray(tied)].set(ref._vn[11])
    caps = captions(root)[:6]
    got, want = svc.search(caps, k=20), ref.search(caps, k=20)
    tied_ids = [svc.vis_ids[i] for i in tied]
    for g, w in zip(got, want):
        g_ids, w_ids = [i for i, _ in g], [i for i, _ in w]
        assert [i for i in g_ids if i in tied_ids] == tied_ids[::-1]
        assert [i for i in w_ids if i in tied_ids] == tied_ids
        assert [i for i in g_ids if i not in tied_ids] == [i for i in w_ids if i not in tied_ids]
        np.testing.assert_allclose(sorted(s for _, s in g), sorted(s for _, s in w), atol=TOL)
        pos = [g_ids.index(i) for i in tied_ids]
        assert max(pos) - min(pos) == len(tied) - 1  # adjacent in the list
