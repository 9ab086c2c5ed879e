#!/usr/bin/env python3
"""MV-test3k R@1-parity reproduction with the port (the counterpart of
``shell/reproduce_mvtest3k.py``): once the MSR-VTT feature dumps exist
under ``--rootpath``, parity against the published reference numbers is
one command:

    python -m laff_tpu_torch.cli.reproduce_mvtest3k --model both

It trains and predicts the headline configs (reference
shell/do_laff_mvtest3k.sh:23 and shell/do_laffml_mvtest3k.sh:14,24)
through ``engine.orchestrate.retrieval_task``, and diffs the t2v metrics
against BASELINE.md (reference README.md:48-49). Exit codes: 2 when data
are missing (each missing path listed), 1 when R@1 is outside the ±0.2
north-star band or R@10 (±0.5) or MedR miss parity, else 0.

``--dry_run`` proves the plumbing on a synthetic mirror world
(``data.synth``'s toy collections, 32/16/20 videos x 2 captions, the tiny
config, 4 epochs) in a temporary directory, removed after: train ->
predict -> TSV -> diff harness. ``--device`` and ``--rank_path`` pass to
every run (on the card unless ``--device cpu``).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

from laff_tpu_torch.engine import orchestrate
from laff_tpu_torch.engine.evaluator import RANK_PATHS

# reference README.md:48-49 via BASELINE.md
BASELINES = {
    "laff": {"config": "laff", "parm": "0_12_0_12_0_0_1",
             "r1": 28.0, "r10": 64.9, "medr": 4},
    "laffml": {"config": "FrameLaff_NoFrameFc_StrongCLIP_adjust",
               "parm": "0_7_1_12_0_12_0",
               "r1": 29.1, "r10": 65.8, "medr": 4},
}
R1_TOL = 0.2  # BASELINE.json north star
R10_TOL = 0.5
COLLECTIONS = ("msrvtt10ktrain", "msrvtt10kval", "msrvtt10ktest")
NEEDED_FEATURES = ("clip_ft", "timesformer", "x3d", "ircsn")
DRY_WORLD = (("msrvtt10ktrain", 32, 0), ("msrvtt10kval", 16, 5), ("msrvtt10ktest", 20, 9))


def check_data(rootpath):
    """The paths a real run needs that are not under ``rootpath``."""
    missing = []
    for coll in COLLECTIONS:
        cdir = os.path.join(rootpath, coll)
        if not os.path.isdir(cdir):
            missing.append(cdir)
            continue
        for feat in NEEDED_FEATURES:
            d = os.path.join(cdir, "FeatureData", feat)
            if not os.path.isdir(d):
                missing.append(d)
        cap = os.path.join(cdir, "TextData", f"{coll}.caption.txt")
        if not os.path.exists(cap):
            missing.append(cap)
    w2v = os.path.join(rootpath, "word2vec", "flickr", "vec500flickr30m")
    if not os.path.isdir(w2v):
        missing.append(w2v)
    return missing


def run_model(name, rootpath, num_epochs, seed, batch_size, device="cuda", rank_path="auto",
              train="msrvtt10ktrain", val="msrvtt10kval", test="msrvtt10ktest", config=None,
              parm=None, result_file=orchestrate.SweepOptions.result_file):
    """One headline run through ``retrieval_task``; model_best's t2v tuple
    on the first query set."""
    base = BASELINES.get(name, {})
    sweep = orchestrate.SweepOptions(
        trainCollection=train, valCollection=val, testCollection=test, rootpath=rootpath,
        val_set="no", config_name=config or base["config"],
        parm_adjust_configs=[parm or base["parm"]], random_seeds=[seed],
        batch_size=batch_size, num_epochs=num_epochs, model_prefix_base="repro_",
        result_file=result_file, device=device, rank_path=rank_path)
    results = orchestrate.retrieval_task(sweep)
    run = results[next(iter(results))]
    return next(iter(run["predict"].values()))["t2v"]


def diff_against_baseline(name, t2v):
    base = BASELINES[name]
    r1, r10, medr = t2v[0], t2v[2], t2v[3]
    rows = {
        "r1": (r1, base["r1"], abs(r1 - base["r1"]) <= R1_TOL),
        "r10": (r10, base["r10"], abs(r10 - base["r10"]) <= R10_TOL),
        "medr": (medr, base["medr"], int(medr) == int(base["medr"])),
    }
    ok = all(v[2] for v in rows.values())
    print(json.dumps({"model": name,
                      **{k: {"ours": v[0], "reference": v[1], "pass": v[2]}
                         for k, v in rows.items()},
                      "parity": ok}))
    return ok


def build_dry_world(root):
    """The mirror world of ``--dry_run`` under ``root``."""
    from laff_tpu_torch.data.synth import build_collection, build_w2v

    for coll, n, seed in DRY_WORLD:
        build_collection(root, coll, n_videos=n, caps_per_video=2, seed=seed)
    build_w2v(root)


def dry_run(device="cuda", rank_path="auto", root=None):
    """The same path on the synthetic mirror world (the tiny config): it
    checks plumbing, not performance. The world (and the result file) is
    written in ``root``, or in a temporary directory removed after the
    run."""
    own = root is None
    root = tempfile.mkdtemp(prefix="repro_dry_") if own else root
    try:
        build_dry_world(root)
        t2v = run_model("dry", root, num_epochs=4, seed=2, batch_size=16, device=device,
                        rank_path=rank_path, config="tiny", parm="None",
                        result_file=os.path.join(root, "result_log", "repro_dry.txt"))
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    ok = all(x == x and x >= 0 for x in t2v)  # finite, sane
    print(json.dumps({"model": "dry_run", "t2v": [float(x) for x in t2v],
                      "plumbing": "ok" if ok else "FAILED"}))
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser("MV-test3k parity reproduction (PyTorch port)")
    p.add_argument("--rootpath", default=os.path.expanduser("~/VisualSearch"))
    p.add_argument("--model", choices=["laff", "laffml", "both"], default="both")
    p.add_argument("--num_epochs", type=int, default=80)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--rank_path", default="auto", choices=RANK_PATHS)
    args = p.parse_args(argv)

    if args.dry_run:
        return dry_run(args.device, args.rank_path)
    missing = check_data(args.rootpath)
    if missing:
        print("missing data (get MSR-VTT dumps per the reference README):")
        for m in missing:
            print(f"  {m}")
        return 2
    names = ["laff", "laffml"] if args.model == "both" else [args.model]
    ok = True
    for name in names:
        t2v = run_model(name, args.rootpath, args.num_epochs, args.seed, args.batch_size,
                        args.device, args.rank_path)
        ok &= diff_against_baseline(name, t2v)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
