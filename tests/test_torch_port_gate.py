"""The gate wrapper of laff_tpu_torch on the CPU: its plain version with g
given as a tensor against the JAX package's Pallas gate (interpret mode)
and flax module on the same seeded numpy inputs, the wrapper's argument
contract, and the constants it shares with csrc/gate.cu.

Tolerance: f32 unit-vector outputs to 1e-5 (f32 reductions in another
order), as in test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laff_tpu.ops.pallas_kernels as PK
from laff_tpu.models.attention import MultiHeadGateAttention as FlaxGate
from laff_tpu_torch.ops import kernels as K

TOL = dict(rtol=1e-5, atol=1e-5)


def _gate_inputs(rng, b=12, l=4, h=4, dh=16):
    x = rng.standard_normal((b, l, h * dh)).astype(np.float32)
    k = (rng.uniform(-1, 1, (h, dh)) / np.sqrt(dh)).astype(np.float32)
    bias = (rng.uniform(-1, 1, (h,)) / np.sqrt(dh)).astype(np.float32)
    return x, k, bias


@pytest.mark.parametrize("mul", [False, True])
def test_gate_tensor_g_matches_jax_kernel_and_flax(rng, mul):
    """with_ave gates given g as a 0-d tensor (as the towers pass their
    global_emb_weight buffer) match the Pallas gate and the flax module."""
    b, l, h, dh = 12, 4, 4, 16
    x = rng.standard_normal((b, l, h * dh)).astype(np.float32)
    mod = FlaxGate(heads=h, with_ave=True, mul=mul, split_head=True)
    variables = jax.tree_util.tree_map(np.array, mod.init(jax.random.key(1), jnp.asarray(x)))
    variables["schedule"]["global_emb_weight"] = np.float32(0.7)
    flax_out = np.asarray(mod.apply(variables, jnp.asarray(x)))
    k = variables["params"]["gate_kernel"]
    bias = variables["params"]["gate_bias"]
    x4 = x.reshape(b, l, h, dh)
    jax_kernel = np.asarray(PK.fused_gate_attention(
        jnp.asarray(x4), jnp.asarray(k), jnp.asarray(bias), np.float32(0.7),
        with_ave=True, mul=mul, block_b=8))
    ours = K.fused_gate_attention(torch.from_numpy(x4), torch.from_numpy(k),
                                  torch.from_numpy(bias), torch.tensor(0.7),
                                  with_ave=True, mul=mul).numpy()
    np.testing.assert_allclose(ours, jax_kernel, **TOL)
    np.testing.assert_allclose(ours, flax_out, **TOL)


@pytest.mark.parametrize("g", [0.0, 0.35, -2.0])
@pytest.mark.parametrize("shape", [(), (1,)])
def test_gate_tensor_g_equals_number_g(rng, g, shape):
    x, k, bias = _gate_inputs(rng)
    args = (torch.from_numpy(x.reshape(12, 4, 4, 16)), torch.from_numpy(k),
            torch.from_numpy(bias))
    as_number = K.fused_gate_attention(*args, g, mul=True)
    as_tensor = K.fused_gate_attention(*args, torch.full(shape, g), mul=True)
    np.testing.assert_array_equal(as_tensor.numpy(), as_number.numpy())


@pytest.mark.parametrize("case", ["l17", "kernel_shape", "bias_shape", "g_size", "x_rank"])
def test_gate_wrapper_refuses_bad_arguments(rng, case):
    """The wrapper's contract holds on the CPU as on the card: at most 16
    positions, a gate kernel (H, dh) and bias (H,), a g of one value."""
    l = 17 if case == "l17" else 4
    x = torch.from_numpy(rng.standard_normal((3, l, 2, 8)).astype(np.float32))
    k, bias, g = torch.zeros(2, 8), torch.zeros(2), torch.tensor(0.5)
    if case == "kernel_shape":
        k = torch.zeros(2, 9)
    elif case == "bias_shape":
        bias = torch.zeros(3)
    elif case == "g_size":
        g = torch.ones(2)
    elif case == "x_rank":
        x = x.reshape(3, l, 16)
    with pytest.raises(ValueError):
        K.fused_gate_attention(x, k, bias, g, with_ave=True)


def test_gate_wrapper_refuses_grad_on_g():
    g = torch.tensor(0.5, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.fused_gate_attention(torch.randn(2, 3, 2, 8), torch.randn(2, 8), torch.randn(2), g)


def test_gate_cpu_call_launches_no_kernel(rng):
    x, k, bias = _gate_inputs(rng)
    before = dict(K.LAUNCHES)
    K.fused_gate_attention(torch.from_numpy(x.reshape(12, 4, 4, 16)), torch.from_numpy(k),
                           torch.from_numpy(bias), torch.tensor(0.5))
    assert K.LAUNCHES == before


def test_gate_constants_match_the_kernel_source():
    """The wrapper's position limit and the constants of its mirror of the
    ring's routing are those of csrc/gate.cu."""
    text = (K._CSRC / "gate.cu").read_text()
    assert f"constexpr int MAX_L = {K.GATE_MAX_L};" in text
    for name, value in (("STAGE_BYTES", K.GATE_STAGE_BYTES), ("RING_BYTES", K.GATE_RING_BYTES)):
        assert value % 1024 == 0
        assert f"constexpr int {name} = {value // 1024} * 1024;" in text
    routes = ("ROUTE_PACKED_ROWS = 0, ROUTE_SIMPLE = 1, ROUTE_WHOLE_ROWS = 2, "
              "ROUTE_HEAD_SPLIT = 3")
    assert routes in text
    assert [layout for _, layout in K._GATE_ROUTES] == [
        "packed_rows", "simple", "whole_rows", "head_split"]
    assert {name for name, _ in K._GATE_ROUTES} <= set(K.LAUNCHES)


@pytest.mark.parametrize("shape,aligned,want", [
    # the LAFF-ml towers' L 4 (64 KB rows): packed rows
    ((4, 8, 512), True, "packed_rows"),
    ((2, 8, 256), True, "packed_rows"),
    ((16, 1, 1024), True, "packed_rows"),
    # FrameLAFF's video tower, L 5 (80 KB rows), and up to L 7 (112 KB):
    # two stages of one whole row
    ((5, 8, 512), True, "whole_rows"),
    ((6, 8, 512), True, "whole_rows"),
    ((7, 8, 512), True, "whole_rows"),
    # larger rows: split by heads
    ((8, 8, 512), True, "head_split"),
    ((5, 16, 512), True, "head_split"),
    ((16, 16, 128), True, "head_split"),
    ((5, 31, 256), True, "head_split"),
    # outside the ring's conditions: the simple kernel
    ((16, 2, 2048), True, "simple"),
    ((4, 8, 130), True, "simple"),
    ((4, 8, 512), False, "simple"),
])
def test_gate_layout_mirrors_the_ring_geometry(shape, aligned, want):
    """gate_layout gives the route csrc/gate.cu's entry point reports."""
    assert K.gate_layout(*shape, aligned=aligned) == want


def test_mbarrier_helpers_live_in_one_header():
    """Both ring kernels take their mbarrier and bulk-copy helpers from
    csrc/mbarrier.cuh; no source keeps a copy of its own."""
    header = (K._CSRC / "mbarrier.cuh").read_text()
    for helper in ("mbar_init", "mbar_expect_tx", "mbar_arrive", "mbar_wait", "bulk_load"):
        assert f"void {helper}(" in header
    for src in ("sim_rank.cu", "gate.cu"):
        text = (K._CSRC / src).read_text()
        assert '#include "mbarrier.cuh"' in text
        assert "mbarrier.try_wait" not in text and "void mbar_" not in text
