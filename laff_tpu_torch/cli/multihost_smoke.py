#!/usr/bin/env python3
"""Multi-process smoke of the port (the counterpart of
``shell/multihost_smoke.py``): N worker processes, started with torchrun's
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``: a tcp coordinator on 127.0.0.1), join one run through
``parallel.initialize_multihost``, not through ``parallel.launch``: NCCL
with a card each (card ``LOCAL_RANK``), gloo on the CPU. Each worker

* runs ``sim_engine.sharded_t2v_ranks`` and ``sharded_topk`` over a gallery
  of 43 rows, which does not divide by the processes, against a
  one-process numpy oracle: the rank integers exactly, the top-k scores
  within 1e-5;
* trains ``trainer.main(mesh=data_parallel_mesh())`` on a toy world (the
  tiny config, 3 epochs, global batch 16) as one data-parallel run: every
  process prints the same digest (best, epoch losses and mir), which must
  agree with one process's run of the same options within
  ``laff_tpu``'s bounds (losses 5e-3 relative, mir and best 0.02), and
  ``model_best.pth.tar`` is written (by rank 0);
* runs ``--resume`` with a root of its own, only rank 0's holding a
  leftover ``model_resume.pth.tar``: every process must refuse with the
  "shared filesystem" error.

  python -m laff_tpu_torch.cli.multihost_smoke [--procs N] [--device cpu]

The one-process run is made in this process first. Everything is written
in a temporary directory (under ``--workdir`` when given), removed after.
Prints ``multihost smoke: PASS`` and exits 0, or prints the failing
workers' output and exits 1.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 900
LOSS_RTOL = 5e-3  # shell/multihost_smoke.py:310-318
MIR_ATOL = 0.02
TOPK = 7


def _options(root, prefix, device, **kw):
    from laff_tpu_torch.engine.prepare import Options

    return Options(trainCollection="toytrain", valCollection="toyval", rootpath=root,
                   val_set="no", config_name="tiny", num_epochs=3, batch_size=16,
                   model_prefix=prefix, metric="mir", device=device, **kw)


def _world(root):
    from laff_tpu_torch.data.synth import build_collection, build_w2v

    build_collection(root, "toytrain", n_videos=32, caps_per_video=2, seed=0)
    build_collection(root, "toyval", n_videos=16, caps_per_video=1, seed=5)
    build_w2v(root)


def _digest(result):
    return {"best": round(float(result["best_perf"]), 8),
            "loss": [round(float(e["loss"]), 6) for e in result["history"]],
            "mir": [round(float(e["mir"]), 8) for e in result["history"]]}


def sim_check(mesh):
    """The sharded rank and top-k over 43 rows against numpy."""
    import torch

    from laff_tpu_torch.parallel.sim_engine import shard_gallery, sharded_t2v_ranks, sharded_topk

    rng = np.random.default_rng(0)  # the same data in every process
    n_txt, n_vis, heads, dim = 16, 43, 4, 16
    txt = rng.standard_normal((n_txt, heads, dim)).astype(np.float32)
    vis = rng.standard_normal((n_vis, heads, dim)).astype(np.float32)
    gt = rng.integers(0, n_vis, (n_txt,)).astype(np.int32)
    t = torch.from_numpy(txt).to(mesh.device)
    local, v = shard_gallery(torch.from_numpy(vis).to(mesh.device), mesh)
    ranks = sharded_t2v_ranks(t, local, gt, mesh, v)
    vals, _ = sharded_topk(t, local, TOPK, mesh, v)

    def flat(x):  # flatten_heads: each head l2-normalized, then concatenated
        x = x.astype(np.float64)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(len(x), -1)

    scores = flat(txt) @ flat(vis).T
    gt_s = scores[np.arange(n_txt), gt]
    cols = np.arange(n_vis)
    expect = 1 + (scores > gt_s[:, None]).sum(1) + (
        (scores == gt_s[:, None]) & (cols[None, :] > gt[:, None])).sum(1)
    if not np.array_equal(ranks, expect):
        raise AssertionError(f"sharded ranks {ranks.tolist()} != {expect.tolist()}")
    want = -np.sort(-scores, axis=1)[:, :TOPK]
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-5)
    return ranks


def worker(root, resume_roots, device):
    import torch

    from laff_tpu_torch.engine import trainer
    from laff_tpu_torch.engine.prepare import model_dir_for
    from laff_tpu_torch.parallel import data_parallel_mesh, initialize_multihost

    n = initialize_multihost()
    if n != int(os.environ["WORLD_SIZE"]):
        raise AssertionError(f"expected {os.environ['WORLD_SIZE']} processes, got {n}")
    if device == "cpu":
        torch.set_num_threads(1)
    mesh = data_parallel_mesh()
    pid = mesh.rank
    try:
        ranks = sim_check(mesh)
        print(f"SIM-OK proc={pid} ranks_head={ranks[:4].tolist()}", flush=True)
        result = trainer.main(_options(root, "mh_run", device), mesh=mesh)
        print(f"TRAINER-OK proc={pid} {json.dumps(_digest(result))}", flush=True)
        opt = _options(resume_roots[pid], "rs_run", device, resume=1)
        if pid == 0:
            path = model_dir_for(opt)
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "model_resume.pth.tar"), "wb") as fh:
                fh.write(b"leftover")  # the guard fires before anything is unpickled
        try:
            trainer.main(opt, mesh=mesh)
            print(f"RESUME-GUARD-MISSED proc={pid}", flush=True)
        except RuntimeError as e:
            if "shared filesystem" not in str(e):
                raise
            print(f"RESUME-GUARD-OK proc={pid}", flush=True)
        mesh.barrier()
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n, root, resume_roots, device, logdir):
    """The workers' (return code, output), each started with torchrun's
    variables and writing to a log in ``logdir``; when one fails, the
    others are stopped."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                                              if p))
        if device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        logs.append(os.path.join(logdir, f"worker{rank}.log"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "laff_tpu_torch.cli.multihost_smoke", "--worker", root,
                 ",".join(resume_roots), "--device", device],
                env=env, stdout=fh, stderr=subprocess.STDOUT))
    deadline = time.time() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = []
    for p, log in zip(procs, logs):
        with open(log) as fh:
            out.append((p.wait(), fh.read()))
    return out


def _line(out, tag):
    for line in out.splitlines():
        if line.startswith(tag):
            return line[len(tag):].strip()
    return None


def smoke(n, device, workdir=None):
    """Run the workers and check them; True when every check passed."""
    from laff_tpu_torch.engine import trainer
    from laff_tpu_torch.engine.predictor import resolve_device

    resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="mh_smoke_", dir=workdir)
    try:
        root = os.path.join(tmp, "world")
        _world(root)
        resume_roots = [os.path.join(tmp, f"resume_{i}") for i in range(n)]
        for r in resume_roots:
            _world(r)
        single = _digest(trainer.main(_options(root, "sp_run", device)))
        runs = _spawn(n, root, resume_roots, device, tmp)
        ok = True
        digests = []
        for pid, (rc, out) in enumerate(runs):
            tags = [f"SIM-OK proc={pid}", f"TRAINER-OK proc={pid}",
                    f"RESUME-GUARD-OK proc={pid}"]
            found = [_line(out, tag) for tag in tags]
            if rc != 0 or any(f is None for f in found):
                ok = False
                print(f"--- worker {pid} rc={rc} ---\n{out}")
                continue
            digests.append(json.loads(found[1]))
        if not ok:
            return False
        # the processes run one collective program: equal numbers
        if any(d != digests[0] for d in digests):
            print(f"the processes' digests differ: {digests}")
            return False
        d = digests[0]
        close = (np.allclose(d["loss"], single["loss"], rtol=LOSS_RTOL, atol=0)
                 and np.allclose(d["mir"], single["mir"], rtol=0, atol=MIR_ATOL)
                 and abs(d["best"] - single["best"]) <= MIR_ATOL)
        best = os.path.join(root, "toytrain", "w2vvpp_train", "toyval", "tiny", "mh_run",
                            "model_best.pth.tar")
        print(f"multihost trainer: {n} processes {d} against one process {single}; "
              f"model_best {'written' if os.path.exists(best) else 'MISSING'}")
        return close and os.path.exists(best)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser("multi-process smoke (PyTorch port)")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--device", default="cuda", help="'cuda' (default: a card a process) or 'cpu'")
    p.add_argument("--workdir", default=None)
    p.add_argument("--worker", nargs=2, metavar=("ROOT", "RESUME_ROOTS"), default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        worker(args.worker[0], args.worker[1].split(","), args.device)
        return 0
    ok = smoke(args.procs, args.device, args.workdir)
    print("multihost smoke:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
