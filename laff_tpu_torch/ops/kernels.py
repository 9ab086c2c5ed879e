"""Hand-written CUDA kernels of the retrieval path, their plain PyTorch
versions, and the build that compiles them at first use.

Kernels (sources in ``laff_tpu_torch/csrc``):

  sim_rank_wide   fused similarity + ground-truth rank (csrc/sim_rank.cu):
                  a gt pass over the tiles holding ground truths, then the
                  count pass; the gallery fits the wide budget
  sim_rank_tiled  the same ranks for larger galleries, ground-truth scores
                  from a separate f32 reduction (csrc/sim_rank.cu)
  gate_attention  the fused LAFF multi-head gate (csrc/gate.cu): a
                  persistent bulk-copy ring kernel (its launches also
                  counted by layout and L in GATE_LAUNCHES), and a simple
                  kernel (counted as gate_attention_simple) for shapes
                  outside the ring's conditions

Each wrapper serves a CPU tensor with its plain version and a CUDA tensor
with its kernel; any other device raises. There is no fallback from the
kernel to the plain version. ``LAUNCHES`` counts kernel launches by name.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface (one ``nvcc`` per source, all started together)
and bound with ctypes. The libraries go under ``build/laff_tpu_torch/`` of
the source checkout, or, for an installed package, under
``$XDG_CACHE_HOME/laff_tpu_torch`` (``~/.cache/laff_tpu_torch`` by default).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from .similarity import flatten_heads

_CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():  # a source checkout
        return root / "build" / "laff_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(Path.home(), ".cache")
    return Path(cache) / "laff_tpu_torch"


BUILD_DIR = _build_dir()
_SOURCES = {"sim_rank": "sim_rank.cu", "gate": "gate.cu"}
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# work item of the rank kernels, text rows x gallery rows: BM and BN of
# csrc/sim_rank.cu, which size the wide branch's scratch
SIM_RANK_ITEM_ROWS = 128
SIM_RANK_ITEM_COLS = 256

# galleries whose padded bf16 block is at most this many bytes take the
# wide branch (the JAX package's VMEM budget, kept so both packages pick the
# same branch and tie rule for the same inputs); tests lower it
WIDE_BUDGET = 64 * 1024 * 1024

LAUNCHES: Dict[str, int] = {"sim_rank_wide": 0, "sim_rank_tiled": 0,
                            "gate_attention": 0, "gate_attention_simple": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    GATE_LAUNCHES.clear()


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    """The library of a source, named by a digest of the source, the headers
    beside it and the compiler flags, so an edit never loads a stale one."""
    h = hashlib.sha1((_CSRC / _SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source that has no up-to-date library yet, one
    ``nvcc`` process per source, all running at once. Returns the compiler
    output (``-Xptxas -v``: registers, shared memory, spills) by source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in _SOURCES.items():
        so = _lib_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so)
    logs = {}
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SOURCES[name]}:\n{out}")
        os.replace(tmp, so)
        so.with_suffix(".log").write_text(out)
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_kernels()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "sim_rank":
        lib.laff_sim_rank_wide.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.laff_sim_rank_wide.restype = i
        lib.laff_sim_rank_tiled.argtypes = [p, p, p, p, i, i, i, p, p]
        lib.laff_sim_rank_tiled.restype = i
    else:
        lib.laff_gate_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, p,
                                            ctypes.POINTER(i), p]
        lib.laff_gate_attention.restype = i
    _LIBS[name] = lib
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_LAUNCH_ERRORS = {-1: "libcuda has no cuTensorMapEncodeTiled",
                  -2: "cuTensorMapEncodeTiled refused the operand layout"}


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{name}: kernel launch failed: {why}")
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    _require(len(kinds) == 1, f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel or plain version for device {kind!r}")
    return kind


# ---------------------------------------------------------------------------
# fused similarity + rank (replaces pallas_kernels.fused_sim_rank)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def is_wide(v: int, hd: int) -> bool:
    """The JAX branch rule: the padded bf16 gallery fits ``WIDE_BUDGET``."""
    return _round_up(v, 256) * hd * 2 <= WIDE_BUDGET


def _flat_bf16(embs: torch.Tensor, prenormalized: bool) -> torch.Tensor:
    flat = embs.reshape(embs.shape[0], -1) if prenormalized else flatten_heads(embs)
    return flat.to(torch.bfloat16).contiguous()


def gt_scores_f32(tn: torch.Tensor, vn: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Ground-truth scores of the tiled branch's plain version: an f32
    elementwise reduction of the bf16 rows, apart from the count (as in the
    JAX package; the kernel's counterpart is ``gt_dot`` in csrc/sim_rank.cu)."""
    return torch.sum(tn.float() * vn[gt.long()].float(), dim=1)


def _sim_rank_plain_flat(tn, vn, gt, wide: bool, block: int = 4096):
    v = vn.shape[0]
    valid = (gt >= 0) & (gt < v)  # other rows get rank 0
    gt = torch.where(valid, gt, 0).long()
    cols = torch.arange(v, device=tn.device)
    vf = vn.float()
    gts = None if wide else gt_scores_f32(tn, vn, gt)
    out = torch.empty(tn.shape[0], dtype=torch.int32, device=tn.device)
    for start in range(0, tn.shape[0], block):
        stop = min(start + block, tn.shape[0])
        s = tn[start:stop].float() @ vf.T
        g_col = gt[start:stop, None]
        if wide:
            g = torch.gather(s, 1, g_col)
            greater = s > g
        else:
            g = gts[start:stop, None]
            greater = (s > g) & (cols[None, :] != g_col)
        beats = greater | ((s == g) & (cols[None, :] > g_col))
        out[start:stop] = (1 + beats.sum(dim=1)).to(torch.int32)
    return torch.where(valid, out, 0)


def fused_sim_rank_plain(txt, vis, gt_cols, prenormalized: bool = False):
    """Plain PyTorch version of :func:`fused_sim_rank`, on any device: the
    same bf16 operands, f32 scores, branch rule and tie rules."""
    tn = _flat_bf16(txt, prenormalized)
    vn = _flat_bf16(vis, prenormalized)
    gt = gt_cols.to(device=tn.device, dtype=torch.int32)
    return _sim_rank_plain_flat(tn, vn, gt, is_wide(vn.shape[0], tn.shape[1]))


def fused_sim_rank(txt, vis, gt_cols, prenormalized: bool = False):
    """1-based ranks of ``gt_cols`` for multi-head (T, H, d) or flat (T, D)
    embeddings against the gallery, with larger-index-first tie breaking.
    The (T, V) score matrix is never materialized on the card.

    ``prenormalized=True`` skips the per-head l2norm (LAFF attention outputs
    are unit-norm per head already). Galleries within ``WIDE_BUDGET`` take
    the wide kernel, where the ground-truth score comes from the same tile
    accumulation as the counted scores; larger ones take the tiled kernel,
    where it comes from a separate f32 reduction and the ground-truth column
    is excluded from the greater-count. A row whose ground truth lies outside
    [0, V) gets rank 0, which no valid row has."""
    tn = _flat_bf16(txt, prenormalized)
    vn = _flat_bf16(vis, prenormalized)
    gt = gt_cols.to(device=tn.device, dtype=torch.int32).contiguous()
    wide = is_wide(vn.shape[0], tn.shape[1])
    if _device_kind(tn, vn) == "cpu":
        return _sim_rank_plain_flat(tn, vn, gt, wide)

    t, hd = tn.shape
    v = vn.shape[0]
    _require(vn.shape[1] == hd, f"feature widths differ: {hd} vs {vn.shape[1]}")
    _require(hd % 64 == 0, f"flat width {hd} must be a multiple of 64")
    _require(gt.shape == (t,), f"gt_cols shape {tuple(gt.shape)} != ({t},)")
    _require(0 < t < 2**31 and 0 < v < 2**31, "row counts out of range")
    n_items = -(-t // SIM_RANK_ITEM_ROWS) * -(-v // SIM_RANK_ITEM_COLS)
    _require(n_items < 2**30, "too many work items")
    _require(tn.data_ptr() % 16 == 0 and vn.data_ptr() % 16 == 0,
             "operands must be 16-byte aligned")
    out = torch.empty(t, dtype=torch.int32, device=tn.device)
    gts = torch.empty(t, dtype=torch.float32, device=tn.device)  # ground-truth scores
    lib = _lib("sim_rank")
    stream = _stream(tn.device)
    if wide:
        work = torch.empty(2 * n_items, dtype=torch.int32, device=tn.device)
        err = lib.laff_sim_rank_wide(tn.data_ptr(), vn.data_ptr(), gt.data_ptr(),
                                     work.data_ptr(), gts.data_ptr(), t, v, hd,
                                     out.data_ptr(), stream)
        _check_launch(err, "sim_rank_wide")
    else:
        err = lib.laff_sim_rank_tiled(tn.data_ptr(), vn.data_ptr(), gt.data_ptr(),
                                      gts.data_ptr(), t, v, hd, out.data_ptr(),
                                      stream)
        _check_launch(err, "sim_rank_tiled")
    return out


# ---------------------------------------------------------------------------
# fused LAFF gate (replaces pallas_kernels.fused_gate_attention)
# ---------------------------------------------------------------------------

# the limits and the routing of csrc/gate.cu: at most GATE_MAX_L positions;
# the ring kernel takes dh % 4 == 0, 16-byte-aligned x, gate kernel and
# output, and one head's L slices within GATE_STAGE_BYTES; other shapes take
# the simple kernel. The C entry point chooses, and reports its choice as a
# route: an index into _GATE_ROUTES, the name LAUNCHES counts and the layout
GATE_MAX_L = 16
GATE_STAGE_BYTES = 72 * 1024
GATE_RING_BYTES = 224 * 1024
_GATE_ROUTES = (("gate_attention", "packed_rows"), ("gate_attention_simple", "simple"),
                ("gate_attention", "whole_rows"), ("gate_attention", "head_split"))

# gate launches by (layout, L); reset_launches zeroes it with LAUNCHES
GATE_LAUNCHES: Dict[Tuple[str, int], int] = {}


def gate_layout(length: int, heads: int, dh: int, aligned: bool = True) -> str:
    """The layout of _GATE_ROUTES that ``laff_gate_attention`` of
    csrc/gate.cu reports for x (B, length, heads, dh): the simple kernel, or
    the ring kernel with rows of at most GATE_STAGE_BYTES packed into its
    stages, rows up to half of GATE_RING_BYTES whole in two stages, or
    larger rows split by heads. ``aligned``: x, the gate kernel and the
    output all lie on 16-byte boundaries."""
    head_bytes = length * dh * 4
    if dh % 4 or not aligned or head_bytes > GATE_STAGE_BYTES:
        return "simple"
    if head_bytes * heads <= GATE_STAGE_BYTES:
        return "packed_rows"
    if 2 * head_bytes * heads <= GATE_RING_BYTES:
        return "whole_rows"
    return "head_split"


def fused_gate_attention_plain(x, gate_kernel, gate_bias, global_weight=1.0,
                               with_ave: bool = True, mul: bool = False):
    """Plain PyTorch version of :func:`fused_gate_attention`; g may be a
    number or a one-element tensor on x's device."""
    x = x.float()
    length = x.shape[1]
    mean = x.mean(dim=1)  # (B, H, dh)
    common = x * mean[:, None] if mul else x
    logits = torch.einsum("blhd,hd->blh", common, gate_kernel.float()) + gate_bias.float()
    weights = torch.softmax(logits, dim=1)
    out = torch.einsum("blh,blhd->bhd", weights, x)
    if with_ave:
        if isinstance(global_weight, torch.Tensor):
            global_weight = global_weight.float().reshape(())
        out = out + global_weight * mean * float(length)
    return out / (torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True)) + 1e-14)


def _check_gate_args(x, gate_kernel, gate_bias, global_weight) -> None:
    """The wrapper's contract, the same on both devices."""
    _require(x.ndim == 4, f"x must be (B, L, H, dh), got {tuple(x.shape)}")
    b, length, heads, dh = x.shape
    _require(tuple(gate_kernel.shape) == (heads, dh),
             f"gate_kernel {tuple(gate_kernel.shape)} != ({heads}, {dh})")
    _require(tuple(gate_bias.shape) == (heads,),
             f"gate_bias {tuple(gate_bias.shape)} != ({heads},)")
    _require(1 <= length <= GATE_MAX_L, f"L={length} outside 1..{GATE_MAX_L}")
    _require(0 < b * heads < 2**31 and length * heads * dh < 2**31,
             f"x {tuple(x.shape)} out of range")
    if isinstance(global_weight, torch.Tensor):
        _require(global_weight.numel() == 1,
                 f"global_weight must hold one value, got shape {tuple(global_weight.shape)}")
        _require(global_weight.device == x.device,
                 f"global_weight on {global_weight.device}, x on {x.device}")


def fused_gate_attention(x, gate_kernel, gate_bias, global_weight=1.0,
                         with_ave: bool = True, mul: bool = False):
    """Fused multi-head LAFF gate, forward only: x (B, L, H, dh) f32 ->
    (B, H, dh) per-head unit vectors (mean over L, gate logits, softmax over
    L, weighted sum, ``with_ave`` residual g*L*mean, per-head l2norm with
    +1e-14). ``global_weight`` (g) is a number or a one-element tensor on
    x's device; the kernel reads a tensor g on the card, so the call never
    waits for it. Raises when an input requires grad: there is no backward."""
    tensors = [x, gate_kernel, gate_bias]
    if isinstance(global_weight, torch.Tensor):
        tensors.append(global_weight)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_gate_attention is forward-only; an input requires grad")
    _check_gate_args(x, gate_kernel, gate_bias, global_weight)
    if _device_kind(x, gate_kernel, gate_bias) == "cpu":
        return fused_gate_attention_plain(x, gate_kernel, gate_bias, global_weight,
                                          with_ave, mul)

    b, length, heads, dh = x.shape
    for name, t in (("x", x), ("gate_kernel", gate_kernel), ("gate_bias", gate_bias)):
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    g = None
    if with_ave:
        if isinstance(global_weight, torch.Tensor):
            g = global_weight.reshape(1).float()
        else:  # a fill on the card, no copy from the host to wait for
            g = torch.full((1,), float(global_weight), dtype=torch.float32, device=x.device)
    out = torch.empty((b, heads, dh), dtype=torch.float32, device=x.device)
    route = ctypes.c_int(0)
    err = _lib("gate").laff_gate_attention(
        x.data_ptr(), gate_kernel.data_ptr(), gate_bias.data_ptr(),
        None if g is None else g.data_ptr(), b, length, heads, dh, int(with_ave), int(mul),
        out.data_ptr(), ctypes.byref(route), _stream(x.device))
    name, layout = _GATE_ROUTES[route.value]
    _check_launch(err, name)
    GATE_LAUNCHES[(layout, length)] = GATE_LAUNCHES.get((layout, length), 0) + 1
    return out
