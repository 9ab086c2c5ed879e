"""Readings that set a cell's limits without the program: the control (the
reference put in the program's place one precision step below what the
configuration states, ``reference.model.rounding``) and, for training,
a planted fault, each held against the float32 reference by the numbers
the cell's check compares.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--fault half_batch]

It makes the world and the weights from each seed as a run of the cell
does, takes a training cell's first dispatch of K steps on the rows the
trainer's feed gives them (epoch 0's permutation of the caption ids,
``default_rng(seed + epoch)``), and prints one JSON line per seed. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, program, world  # noqa: E402
from portbench.drivers import train as train_driver  # noqa: E402
from portbench.drivers import val as val_driver  # noqa: E402
from portbench.reference.model import _fp8, parameter_count  # noqa: E402
from portbench.reference.rank import rank_gaps, ranks_from_scores, scores  # noqa: E402
from portbench.reference.train import train_steps  # noqa: E402
from portbench.weights import make_weights  # noqa: E402


def shapes_of(cfg: Dict, text) -> Dict[str, tuple]:
    """The state dict's shapes, from the configuration's layout (what the
    port's model holds, without the port)."""
    c, h = cfg["common_dim"], cfg["heads"]
    out = {}
    for tower, side in (("txt_net", cfg["text"]), ("vis_net", cfg["video"])):
        feats = list(side["features"])
        if side.get("frames"):
            fr = side["frames"]
            feats.append({"name": fr["name"], "dim": fr["dim"], "transform": False})
        for f in feats:
            p = f"{tower}.transform_{f['name']}"
            if f["transform"]:
                dim = len(text.bow_vocab) if f["name"] == "bow" else f["dim"]
                out[p + ".fc1.weight"], out[p + ".fc1.bias"] = (c, dim), (c,)
            for k in ("weight", "bias", "running_mean", "running_var"):
                out[f"{p}.bn1.{k}"] = (c,)
            out[f"{p}.bn1.num_batches_tracked"] = ()
        if tower == "txt_net":
            g = side["gru"]
            out["txt_net.gru.we.weight"] = (len(text.gru_vocab), g["we_dim"])
            out["txt_net.gru.rnn.weight_ih_l0"] = (3 * g["hidden"], g["we_dim"])
            out["txt_net.gru.rnn.weight_hh_l0"] = (3 * g["hidden"], g["hidden"])
            out["txt_net.gru.rnn.bias_ih_l0"] = out["txt_net.gru.rnn.bias_hh_l0"] = (
                3 * g["hidden"],)
        if side.get("frames"):
            fr = side["frames"]
            out[f"{tower}.frame_attn_{fr['name']}.gate.weight"] = (1, fr["dim"])
            out[f"{tower}.frame_attn_{fr['name']}.gate.bias"] = (1,)
        out[f"{tower}.attention.gate_kernel"] = (h, c // h)
        out[f"{tower}.attention.gate_bias"] = (h,)
    return out


def _inputs(cfg, tr, seed, workdir, device):
    world_seed, weight_seed, run_seed = harness.sub_seeds(seed, 3)
    world.build_world(workdir, tr["collection"], tr["videos"], tr["captions_per_video"],
                      tr["caption_words"], n_vocab=cfg["vocab_words"], seed=world_seed,
                      frame_feat=bool(cfg["video"].get("frames")))
    text, video = program.reference_inputs(cfg, workdir, tr["collection"])
    shapes = shapes_of(cfg, text)
    n = sum(int(np.prod(s)) for k, s in shapes.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    if n != parameter_count(cfg, len(text.bow_vocab), len(text.gru_vocab)):
        raise RuntimeError("the shapes do not hold the configuration's parameters")
    w0 = make_weights(shapes, weight_seed, device)
    return text, video, w0, run_seed


def train_readings(cfg, tr, seed, workdir, device, fault=None) -> Dict[str, float]:
    text, video, w0, run_seed = _inputs(cfg, tr, seed, workdir, device)
    batches = [(program.to_device(text.featurize(caps), device),
                program.to_device(video.featurize([c.split("#")[0] for c in caps]), device))
               for caps in train_driver.first_batches(text.ids, run_seed, tr["batch_size"],
                                                      tr["steps_per_dispatch"])]
    ref = train_steps(cfg, w0, batches, gen_seed=run_seed * 1000)
    if fault:
        other = train_steps(cfg, w0, batches, gen_seed=run_seed * 1000, fault=fault)
    else:
        other = train_steps(cfg, w0, batches, gen_seed=run_seed * 1000, precision="control")
    return train_driver.compare(other["losses"], {**other["params"], **other["stats"]}, ref, w0)


@torch.no_grad()
def val_readings(cfg, tr, seed, workdir, device) -> Dict[str, float]:
    text, video, w0, _ = _inputs(cfg, tr, seed, workdir, device)
    txt_ids, vis_ids = text.ids, [f"{tr['collection']}_v{i}" for i in range(tr["videos"])]
    tf, vf = val_driver.reference_embeddings(cfg, w0, text, video, txt_ids, vis_ids, device)
    cf, cv = val_driver.reference_embeddings(cfg, w0, text, video, txt_ids, vis_ids, device,
                                             precision="control")
    cf, cv = _fp8(cf), _fp8(cv)  # the scores one step below the rank kernel's bf16
    gt = val_driver.gt_columns(txt_ids, vis_ids, device)
    gap, block = 0.0, val_driver.TXT_BLOCK
    for s in range(0, len(txt_ids), block):
        ranks = ranks_from_scores(scores(cf[s:s + block], cv, cfg["heads"]), gt[s:s + block])
        ref = scores(tf[s:s + block], vf, cfg["heads"])
        gap = max(gap, float(rank_gaps(ref, gt[s:s + block], ranks).max()))
    return {"rank_gap": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", default=None, help="a training fault: half_batch")
    args = ap.parse_args(argv)
    c = harness.cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    program.strict_fp32()
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        t0 = time.perf_counter()
        try:
            if c["traffic"]["driver"] == "train":
                out = train_readings(c["config"], c["traffic"], seed, workdir, device, args.fault)
            else:
                out = val_readings(c["config"], c["traffic"], seed, workdir, device)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": args.fault or "control", "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
