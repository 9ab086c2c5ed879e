"""laff_tpu_torch kernel modules on the CPU: the plain versions of the CUDA
kernels against the JAX package's Pallas kernels (interpret mode) and flax
modules, on the same seeded numpy inputs.

Tolerances: ranks are compared exactly on rows without a near tie and
otherwise allowed to move by the near ties they have (both sides round
the operands to bf16 identically, but accumulate f32 sums in different
orders); the gate's f32 unit-vector outputs to 1e-5 (f32 reduction order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laff_tpu.ops.pallas_kernels as PK
from laff_tpu.eval import ranks_from_scores_device
from laff_tpu.models.attention import MultiHeadGateAttention as FlaxGate
from laff_tpu_torch.eval.metrics import ranks_from_scores
from laff_tpu_torch.ops import kernels as K
from laff_tpu_torch.ops.norms import l2norm
from laff_tpu_torch.ops.similarity import flatten_heads, multi_head_cosine_sim

NEAR_TIE = 1e-5  # abs score gap below which two f32 accumulations may disagree


def _assert_ranks_match(ours, ref, txt, vis, gt):
    """Equal ranks, except that a row may differ by at most the number of
    gallery columns whose bf16-operand score lies within NEAR_TIE of its
    ground-truth score."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    tn = flatten_heads(torch.from_numpy(txt)).to(torch.bfloat16).double()
    vn = flatten_heads(torch.from_numpy(vis)).to(torch.bfloat16).double()
    s = (tn @ vn.T).numpy()
    for row in np.nonzero(ours != ref)[0]:
        g = s[row, gt[row]]
        near = np.sum(np.abs(s[row] - g) <= NEAR_TIE) - 1
        assert abs(int(ours[row]) - int(ref[row])) <= near, (row, ours[row], ref[row])


def _jax_ranks(txt, vis, gt, **kw):
    return np.asarray(PK.fused_sim_rank(jnp.asarray(txt), jnp.asarray(vis),
                                        jnp.asarray(gt), **kw))


def _inputs(rng, t, v, h, d):
    txt = rng.standard_normal((t, h, d)).astype(np.float32)
    vis = rng.standard_normal((v, h, d)).astype(np.float32)
    gt = rng.integers(0, v, (t,)).astype(np.int32)
    return txt, vis, gt


@pytest.mark.parametrize("prenormalized", [False, True])
def test_sim_rank_wide_matches_jax(rng, prenormalized):
    txt, vis, gt = _inputs(rng, 70, 300, 4, 16)
    if prenormalized:
        txt = l2norm(torch.from_numpy(txt)).numpy()
        vis = l2norm(torch.from_numpy(vis)).numpy()
    assert K.is_wide(300, 64)
    ours = K.fused_sim_rank(torch.from_numpy(txt), torch.from_numpy(vis),
                            torch.from_numpy(gt), prenormalized=prenormalized)
    ref = _jax_ranks(txt, vis, gt, block_t=16, prenormalized=prenormalized)
    _assert_ranks_match(ours, ref, txt, vis, gt)
    assert (ours.numpy() == ref).mean() > 0.95


def test_sim_rank_tiled_matches_jax(rng, monkeypatch):
    txt, vis, gt = _inputs(rng, 50, 300, 2, 32)
    monkeypatch.setattr(K, "WIDE_BUDGET", 1)
    monkeypatch.setattr(PK, "_WIDE_VMEM_BUDGET", 1)
    ours = K.fused_sim_rank(torch.from_numpy(txt), torch.from_numpy(vis),
                            torch.from_numpy(gt))
    ref = _jax_ranks(txt, vis, gt, block_t=16, block_v=128)
    _assert_ranks_match(ours, ref, txt, vis, gt)


@pytest.mark.parametrize("wide", [True, False])
def test_sim_rank_exact_match_is_rank_one(rng, monkeypatch, wide):
    """A query identical to its gt row ranks 1 on both branches (the tiled
    branch excludes the gt column from the greater-count)."""
    if not wide:
        monkeypatch.setattr(K, "WIDE_BUDGET", 1)
    vis = l2norm(torch.from_numpy(rng.standard_normal((600, 2, 32)).astype(np.float32)))
    gt = torch.from_numpy(rng.integers(0, 600, (128,)).astype(np.int32))
    ranks = K.fused_sim_rank(vis[gt.long()], vis, gt, prenormalized=True)
    assert K.is_wide(600, 64) == wide
    np.testing.assert_array_equal(ranks.numpy(), np.ones(128, np.int32))


@pytest.mark.parametrize("wide", [True, False])
def test_sim_rank_duplicate_gallery_ties(rng, monkeypatch, wide):
    """Duplicated gallery rows tie exactly: the larger index wins, as in
    laff_tpu (tests/test_pallas.py::test_flat_sim_ranks_ties)."""
    if not wide:
        monkeypatch.setattr(K, "WIDE_BUDGET", 1)
        monkeypatch.setattr(PK, "_WIDE_VMEM_BUDGET", 1)
    base = rng.standard_normal((5, 2, 8)).astype(np.float32)
    vis = np.concatenate([base, base[:2]], axis=0)  # rows 0, 1 again at 5, 6
    txt = base[:2]
    for gt, expected in (([0, 1], [2, 2]), ([5, 6], [1, 1])):
        gt = np.asarray(gt, np.int32)
        ours = K.fused_sim_rank(torch.from_numpy(txt), torch.from_numpy(vis),
                                torch.from_numpy(gt)).numpy()
        np.testing.assert_array_equal(ours, expected)
        np.testing.assert_array_equal(_jax_ranks(txt, vis, gt, block_t=8, block_v=8),
                                      expected)


def test_sim_rank_plain_equals_cpu_wrapper(rng):
    txt, vis, gt = _inputs(rng, 40, 90, 2, 16)
    args = (torch.from_numpy(txt), torch.from_numpy(vis), torch.from_numpy(gt))
    before = dict(K.LAUNCHES)
    np.testing.assert_array_equal(K.fused_sim_rank(*args).numpy(),
                                  K.fused_sim_rank_plain(*args).numpy())
    assert K.LAUNCHES == before  # the CPU path launches no kernel


def test_ranks_from_scores_matches_jax(rng):
    scores = rng.standard_normal((30, 40)).astype(np.float32)
    scores[:, 7] = scores[:, 3]  # exact ties
    gt = rng.integers(0, 40, (30,)).astype(np.int32)
    gt[:10] = 3
    ours = ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(gt)).numpy()
    ref = np.asarray(ranks_from_scores_device(jnp.asarray(scores), jnp.asarray(gt)))
    np.testing.assert_array_equal(ours, ref)


def test_flatten_heads_equals_multihead_mean(rng):
    t = torch.from_numpy(rng.standard_normal((6, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((9, 4, 16)).astype(np.float32))
    flat = (flatten_heads(t) @ flatten_heads(v).T) / 4
    np.testing.assert_allclose(multi_head_cosine_sim(t, v).numpy(), flat.numpy(),
                               rtol=1e-5, atol=1e-6)


# L 4 (LAFF-ml's towers), 5 (FrameLAFF's video tower) and 8 (the most the
# ring kernel's register path holds at dh 512); the L 4 cases keep their ids
@pytest.mark.parametrize("l,with_ave,mul", [
    pytest.param(l, with_ave, mul, id=f"{with_ave}-{mul}" if l == 4 else f"L{l}-{with_ave}-{mul}")
    for l in (4, 5, 8) for with_ave, mul in ((True, False), (False, False), (True, True))])
def test_gate_plain_matches_jax_kernel_and_flax(rng, l, with_ave, mul):
    b, h, dh = 12, 4, 16
    x = rng.standard_normal((b, l, h * dh)).astype(np.float32)
    mod = FlaxGate(heads=h, with_ave=with_ave, mul=mul, split_head=True)
    variables = mod.init(jax.random.key(0), jnp.asarray(x))
    flax_out = np.asarray(mod.apply(variables, jnp.asarray(x)))
    k = np.array(variables["params"]["gate_kernel"])
    bias = np.array(variables["params"]["gate_bias"])
    g = 0.7
    jax_kernel = np.asarray(PK.fused_gate_attention(
        jnp.asarray(x.reshape(b, l, h, dh)), jnp.asarray(k), jnp.asarray(bias), g,
        with_ave=with_ave, mul=mul, block_b=8))
    ours = K.fused_gate_attention(torch.from_numpy(x.reshape(b, l, h, dh)),
                                  torch.from_numpy(k), torch.from_numpy(bias), g,
                                  with_ave=with_ave, mul=mul).numpy()
    np.testing.assert_allclose(ours, jax_kernel, rtol=1e-5, atol=1e-5)
    ours_g1 = K.fused_gate_attention_plain(torch.from_numpy(x.reshape(b, l, h, dh)),
                                           torch.from_numpy(k), torch.from_numpy(bias),
                                           1.0, with_ave=with_ave, mul=mul).numpy()
    np.testing.assert_allclose(ours_g1, flax_out, rtol=1e-5, atol=1e-5)


def test_gate_wrapper_refuses_grad(rng):
    x = torch.randn(2, 3, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.fused_gate_attention(x, torch.randn(2, 8), torch.randn(2))


def test_kernel_sources_declare_their_tpu_counterparts():
    for src, names in (("sim_rank.cu", ("_sim_rank_kernel_wide", "_sim_rank_kernel")),
                       ("gate.cu", ("_gate_kernel",))):
        text = (K._CSRC / src).read_text()
        assert "laff_tpu/ops/pallas_kernels.py" in text
        for name in names:
            assert name in text


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """A library is named by a digest of its source and the headers beside
    it, so an edit to either names another library (never a stale one)."""
    for src in K._CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(K, "_CSRC", tmp_path)
    names = [(K._lib_path("sim_rank"), K._lib_path("gate"))]
    with open(tmp_path / "wgmma.cuh", "a") as f:
        f.write("\n")
    names.append((K._lib_path("sim_rank"), K._lib_path("gate")))
    with open(tmp_path / "sim_rank.cu", "a") as f:
        f.write("\n")
    names.append((K._lib_path("sim_rank"), K._lib_path("gate")))
    assert len({n[0] for n in names}) == 3
    assert names[1][1] != names[0][1] and names[2][1] == names[1][1]


def test_work_item_tile_matches_the_kernel_source():
    """The wrapper sizes the wide branch's scratch from the kernel's work item."""
    text = (K._CSRC / "sim_rank.cu").read_text()
    assert f"constexpr int BM = {K.SIM_RANK_ITEM_ROWS};" in text
    assert f"constexpr int BN = {K.SIM_RANK_ITEM_COLS};" in text


@pytest.mark.parametrize("wide", [True, False])
def test_sim_rank_out_of_range_gt_has_rank_zero(rng, monkeypatch, wide):
    """A row whose ground truth lies outside [0, V) gets rank 0 (the kernel
    does the same on the card); the other rows keep their ranks."""
    if not wide:
        monkeypatch.setattr(K, "WIDE_BUDGET", 1)
    txt, vis, gt = _inputs(rng, 40, 90, 2, 16)
    args = (torch.from_numpy(txt), torch.from_numpy(vis))
    ref = K.fused_sim_rank(*args, torch.from_numpy(gt)).numpy()
    bad = gt.copy()
    bad[[3, 17, 30]] = [-1, 90, 2**31 - 1]
    ours = K.fused_sim_rank(*args, torch.from_numpy(bad)).numpy()
    np.testing.assert_array_equal(ours[[3, 17, 30]], 0)
    keep = np.ones(40, bool)
    keep[[3, 17, 30]] = False
    np.testing.assert_array_equal(ours[keep], ref[keep])
    assert (ref >= 1).all()
