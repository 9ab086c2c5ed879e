"""What the benchmark takes from the program under test (``laff_tpu_torch``,
the PyTorch port): its training options and ``prepare``, its model, and
the checks that a cell runs the path it is meant to measure. Every import
of the program happens inside these functions, after the harness has
looked for the card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import parameter_count
from .reference.text import TextInputs
from .reference.video import VideoInputs

VOCAB_SHARE = 0.999  # the least share of the configuration's vocabulary a world may give


def options(cfg: Dict, traffic: Dict, root: str, seed: int, device: torch.device, **extra):
    """The trainer's ``Options`` at its defaults for one collection that
    both trains and validates (a train cell never validates in its window;
    the validation cell ranks that collection)."""
    from laff_tpu_torch.engine.prepare import Options

    coll = traffic["collection"]
    return Options(trainCollection=coll, valCollection=coll, val_set="no", rootpath=root,
                   config_name=cfg["port_config"], parm_adjust_config=cfg["parm_adjust_config"],
                   device=device.type, random_seed=seed, workers=traffic.get("workers", 2),
                   num_epochs=1_000_000, model_prefix="portbench", **extra)


def check_spec(spec, cfg: Dict, bow_words: int) -> None:
    """The program's model spec has the configuration's widths and layout;
    the bow width is the vocabulary the reference's rule finds in the
    world, which must hold nearly all of the configuration's words."""
    want_dtype = cfg["tower_dtype"]
    txt = [(f["name"], bow_words if f["name"] == "bow" else f["dim"])
           for f in cfg["text"]["features"]]
    vis = [(f["name"], f["dim"]) for f in cfg["video"]["features"]]
    frames = cfg["video"].get("frames")
    problems = []
    if list(spec.txt.features) != txt:
        problems.append(f"text features {spec.txt.features} != {txt}")
    if list(spec.vis.features) != vis:
        problems.append(f"video features {spec.vis.features} != {vis}")
    got_frames = list(spec.vis.frame_features)
    if got_frames != ([(frames["name"], frames["dim"])] if frames else []):
        problems.append(f"frame features {got_frames} != {frames}")
    for tower in (spec.txt, spec.vis):
        if tower.common_dim != cfg["common_dim"] or tower.attention.heads != cfg["heads"]:
            problems.append(f"common {tower.common_dim} x {tower.attention.heads} heads")
        if tower.compute_dtype != want_dtype:
            problems.append(f"tower dtype {tower.compute_dtype} != {want_dtype}")
    if bow_words < VOCAB_SHARE * cfg["vocab_words"]:
        problems.append(f"bow vocabulary {bow_words} < {VOCAB_SHARE} x {cfg['vocab_words']}")
    if problems:
        raise RuntimeError("the program's model is not the configuration's: " + "; ".join(problems))


def check_parameters(model: torch.nn.Module, cfg: Dict, text) -> None:
    """The program's model has the parameters the configuration's layout
    gives at the world's vocabularies, and that layout gives the
    configuration's stated count at its own vocabulary."""
    n = sum(p.numel() for p in model.parameters())
    want = parameter_count(cfg, len(text.bow_vocab), len(text.gru_vocab))
    stated = parameter_count(cfg, cfg["vocab_words"],
                             cfg["vocab_words"] + len(text.gru_vocab) - len(text.bow_vocab))
    if n != want or stated != cfg["parameters"]:
        raise RuntimeError(f"the program's model has {n} parameters, the configuration's "
                           f"layout {want} here and {stated} (stated {cfg['parameters']})")


def reference_inputs(cfg: Dict, root: str, collection: str):
    """The reference's text and video inputs of a collection whose own
    captions give the vocabularies."""
    import os

    tcfg = cfg["text"]
    capfile = os.path.join(root, collection, "TextData", f"{collection}.caption.txt")
    text = TextInputs(root, collection, capfile, cfg["vocab_threshold"], tcfg["w2v_dir"],
                      tcfg["clip_dir"], cfg["max_txtlength"])
    video = VideoInputs(root, collection, [f["name"] for f in cfg["video"]["features"]],
                        cfg["video"].get("frames"))
    return text, video


def to_device(arrays: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms, |norm(prog) - norm(ref)|, against the
    larger of the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def pin_float32_math(cfg: Dict) -> None:
    """The configuration's float32 products (``float32_math``), set before
    the program is built, since a CUDA graph keeps the kernels of its
    capture: TF32 or float32 for cuDNN (the GRU) and for cuBLAS."""
    math_cfg = cfg["float32_math"]
    torch.backends.cudnn.allow_tf32 = bool(math_cfg["cudnn_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(math_cfg["cublas_tf32"])


def strict_fp32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
