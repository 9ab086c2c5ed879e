"""The large-gallery paths on the CPU, held against laff_tpu on the same
numpy inputs: ``ops.quantized``, ``topk_two_stage`` / ``topk_wide``,
``streaming_benchmark_eval`` (with a fake embedder over gallery rows
duplicated to make exact ties; cached against uncached; the bf16 rank
kernel branch and the f32-text guard) and ``int8_streaming_topk``.

Pinned divergence: the running top-k of ``streaming_benchmark_eval`` puts
equal scores in decreasing gallery index order, across blocks;
``laff_tpu``'s ``lax.top_k`` merge puts the lower index first. Each
package's list is checked against its own rule on the same scores.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laff_tpu.data.feed import EvalFeed as JEvalFeed
from laff_tpu.engine import evaluator as JEV
from laff_tpu.eval import metrics as JM
from laff_tpu.ops import quantized as JQ
from laff_tpu_torch.data import EvalFeed
from laff_tpu_torch.engine import evaluator as EV
from laff_tpu_torch.eval import metrics as M
from laff_tpu_torch.ops import flatten_heads, fused_sim_rank, quantized as Q

RESCORE_ATOL = 1e-6  # exact rescoring of unit rows: f32 sums in other orders


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_quantized_equals_laff_tpu():
    """q and scales bit for bit (a zero row included), int32-exact approximate
    scores, and int8_topk with and without rescoring."""
    rng = np.random.default_rng(0)
    txt, vis = _unit(rng, 37, 96), _unit(rng, 300, 96)
    txt[5] = 0.0
    jq, js = JQ.quantize_rows(jnp.asarray(txt))
    q, s = Q.quantize_rows(torch.from_numpy(txt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jvq, jvs = JQ.quantize_rows(jnp.asarray(vis))
    vq, vs = Q.quantize_rows(torch.from_numpy(vis))
    np.testing.assert_array_equal(Q.int8_scores(q, s, vq, vs).numpy(),
                                  np.asarray(JQ.int8_scores(jq, js, jvq, jvs)))
    keep = np.arange(37) != 5  # the zero row ties everywhere
    got = Q.int8_topk(q, s, vq, vs, 20)
    want = JQ.int8_topk(jq, js, jvq, jvs, 20)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy()[keep], np.asarray(want[1])[keep])
    got = Q.int8_topk(q, s, vq, vs, 20, rescore_embs=(torch.from_numpy(txt),
                                                      torch.from_numpy(vis)), block_t=16)
    want = JQ.int8_topk(jq, js, jvq, jvs, 20, rescore_embs=(jnp.asarray(txt), jnp.asarray(vis)),
                        block_t=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=RESCORE_ATOL)
    np.testing.assert_array_equal(got[1].numpy()[keep], np.asarray(want[1])[keep])


@pytest.mark.parametrize("name", ["topk_two_stage", "topk_wide"])
def test_topk_equals_laff_tpu(name):
    """Values equal on a ragged wide axis with ties; the indices hold them."""
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 50, size=(6, 1000)).astype(np.float32) / 7
    kwargs = {"block_v": 96} if name == "topk_two_stage" else {}
    vals, idx = getattr(M, name)(torch.from_numpy(scores), 40, **kwargs)
    want, _ = getattr(JM, name)(jnp.asarray(scores), 40, **kwargs)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.take_along_axis(scores, idx.numpy(), 1), vals.numpy())
    assert all(len(set(row)) == 40 for row in idx.tolist())


class _JaxEmbedder:
    """laff_tpu's streaming paths call ``_vis(variables, batch)`` and, for the
    int8 re-embedding, ``embed_vis(feed)``."""
    variables = None

    def __init__(self, cast=None):
        self.cast = cast

    def _vis(self, variables, batch):
        x = jnp.asarray(batch["feat"])
        return x.astype(self.cast) if self.cast is not None else x

    def embed_vis(self, feed):
        embs, ids = [], []
        for item in feed:
            embs.append(self._vis(None, item["data"])[: item["valid"]])
            ids.extend(item["ids"])
        return jnp.concatenate(embs), ids


def _port_embedder(dtype="float32"):
    """A real ``Embedder`` over a model whose video tower returns its input:
    'bfloat16' rounds the features on the device, as a bf16 tower's does."""
    spec = SimpleNamespace(txt=SimpleNamespace(compute_dtype=dtype),
                           vis=SimpleNamespace(compute_dtype=dtype))
    return EV.Embedder(SimpleNamespace(spec=spec, encode_vis=lambda data: data["feat"]),
                       torch.device("cpu"))


def _tie_world(kind, n_vis=37, caps_per=3, heads=2, dim=8, seed=3):
    """Gallery rows with duplicates (rows 5 and 20 copy row 9), captions
    v<i>#<j>. 'exact' gives every head four entries of +-1 and the rest 0:
    its norm is 2, so the unit heads, their products and every score are
    exact in f32 in both packages, and ties are everywhere."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        if kind != "exact":
            return rng.normal(size=shape).astype(np.float32)
        signs = rng.choice([-1.0, 1.0], size=shape).astype(np.float32)
        return signs * (np.argsort(rng.random(shape), axis=-1) < 4)
    vis = draw(n_vis, heads, dim)
    vis[5] = vis[9]
    vis[20] = vis[9]
    vis_ids = [f"v{i}" for i in range(n_vis)]
    txt_ids = [f"v{i}#{j}" for i in range(n_vis) for j in range(caps_per)]
    txt = draw(len(txt_ids), heads, dim)
    return vis, vis_ids, txt, txt_ids


def _feeds(vis, vis_ids, batch=8):
    def batcher(ids):
        return {"feat": np.stack([vis[int(i[1:])] for i in ids])}
    return JEvalFeed(vis_ids, batcher, batch_size=batch), EvalFeed(vis_ids, batcher, batch)


def _rank(row, col):
    s = row[col]
    return 1 + int((row > s).sum()) + int(((row == s) & (np.arange(len(row)) > col)).sum())


@pytest.mark.parametrize("kind", ["exact", "normal"])
def test_streaming_benchmark_eval_equals_laff_tpu(kind):
    vis, vis_ids, txt, txt_ids = _tie_world(kind)
    jfeed, feed = _feeds(vis, vis_ids)
    want = JEV.streaming_benchmark_eval(_JaxEmbedder(), jnp.asarray(txt), txt_ids, jfeed,
                                        topk=10)
    got = EV.streaming_benchmark_eval(_port_embedder(), torch.from_numpy(txt), txt_ids, feed,
                                      topk=10)
    assert got["vis_ids"] == want["vis_ids"] == vis_ids
    np.testing.assert_array_equal(got["t2v_ranks"], want["t2v_ranks"])
    np.testing.assert_allclose(got["t2v"], want["t2v"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["v2t"], want["v2t"], rtol=1e-6, atol=1e-6)
    if kind == "exact":
        np.testing.assert_array_equal(got["topk_vals"], want["topk_vals"])
    else:  # unit heads and products summed in other orders: the last f32 bit
        np.testing.assert_allclose(got["topk_vals"], want["topk_vals"], rtol=0, atol=1e-6)

    # each package's ids against its own tie rule on the port's block scores
    tn = flatten_heads(torch.from_numpy(txt))
    scores = np.concatenate([EV._flat_scores(tn, flatten_heads(torch.from_numpy(vis[s:s + 8])),
                                             2).numpy() for s in range(0, 37, 8)], axis=1)
    cols = np.arange(37)
    for q, row in enumerate(scores):
        port_rule = sorted(cols, key=lambda j: (-row[j], -j))[:10]
        jax_rule = sorted(cols, key=lambda j: (-row[j], j))[:10]
        assert got["topk_idx"][q].tolist() == port_rule
        if kind == "exact":
            assert want["topk_idx"][q].tolist() == jax_rule
        assert got["t2v_ranks"][q] == _rank(row, int(txt_ids[q].split("#")[0][1:]))
    if kind == "exact":  # ties straddle blocks: the two rules give other lists
        assert (got["topk_idx"] != want["topk_idx"]).any()
    for v, ranks in enumerate(got["v2t_ranks"]):
        caps = [q for q in range(len(txt_ids)) if txt_ids[q].startswith(f"v{v}#")]
        assert ranks.tolist() == sorted(_rank(scores[:, v], q) for q in caps)


def test_streaming_cached_equals_uncached(monkeypatch):
    """The flat gallery cached on the device (rescored slices) and streamed
    again through the tower give the same numbers bit for bit."""
    vis, vis_ids, txt, txt_ids = _tie_world("normal", seed=7)
    feed = _feeds(vis, vis_ids)[1]
    embedder = _port_embedder()
    cached = EV.streaming_benchmark_eval(embedder, torch.from_numpy(txt), txt_ids, feed, topk=5)
    passes, real = [], EV._vis_blocks

    def counting(e, f):
        passes.append(f)
        yield from real(e, f)

    monkeypatch.setattr(EV, "_vis_blocks", counting)
    monkeypatch.setenv(EV.STREAM_BUDGET_ENV, "0")
    uncached = EV.streaming_benchmark_eval(embedder, torch.from_numpy(txt), txt_ids, feed,
                                           topk=5)
    assert len(passes) == 2  # the gallery went through the tower twice
    for key in ("t2v_ranks", "topk_idx", "topk_vals"):
        np.testing.assert_array_equal(cached[key], uncached[key])
    assert cached["t2v"] == uncached["t2v"] and cached["v2t"] == uncached["v2t"]



def _counting_kernel(monkeypatch):
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return fused_sim_rank(*args, **kwargs)

    monkeypatch.setattr(EV, "fused_sim_rank", counted)
    return calls


def test_streaming_kernel_branch(monkeypatch):
    """bf16 text and a bf16 cache under rank_path 'kernel': pass 2 is one
    fused_sim_rank over the whole cache, equal to the kernel called on the
    same rows and to laff_tpu's pallas branch; the duplicate tie holds."""
    rng = np.random.default_rng(29)
    vis = rng.normal(size=(21, 2, 8)).astype(np.float32)
    vis[4] = vis[12]
    vis_ids = [f"v{i}" for i in range(21)]
    txt_ids = [f"v{i}#0" for i in range(21)]
    txt = rng.normal(size=(21, 2, 8)).astype(np.float32)
    txt[3], txt_ids[3] = vis[4], "v4#0"  # the query's duplicate v12 outranks v4
    jfeed, feed = _feeds(vis, vis_ids)
    calls = _counting_kernel(monkeypatch)
    got = EV.streaming_benchmark_eval(_port_embedder("bfloat16"),
                                      torch.from_numpy(txt).to(torch.bfloat16), txt_ids, feed,
                                      topk=0, rank_path="kernel")
    assert calls == [(21, 16)]
    gt = torch.as_tensor([int(t.split("#")[0][1:]) for t in txt_ids])
    direct = fused_sim_rank(flatten_heads(torch.from_numpy(txt).to(torch.bfloat16)),
                            flatten_heads(torch.from_numpy(vis).to(torch.bfloat16)), gt,
                            prenormalized=True)
    np.testing.assert_array_equal(got["t2v_ranks"], direct.numpy())
    assert got["t2v_ranks"][3] == 2 and "topk_idx" not in got
    monkeypatch.setenv("LAFF_TPU_RANK_PATH", "pallas")
    want = JEV.streaming_benchmark_eval(_JaxEmbedder(jnp.bfloat16),
                                        jnp.asarray(txt).astype(jnp.bfloat16), txt_ids, jfeed,
                                        topk=0)
    np.testing.assert_array_equal(got["t2v_ranks"], want["t2v_ranks"])


def test_streaming_kernel_guard_f32_text(monkeypatch):
    """f32 text with a bf16 cache under rank_path 'kernel' takes the
    rescoring branch: the kernel casts text to bf16, which pass 1 never saw.
    The query's components differ by about 12 f32 ulps: f32 ranks the
    ground truth first, bf16 text ties it with a later column."""
    vis = np.zeros((2, 1, 8), np.float32)
    vis[0, 0, 1] = vis[1, 0, 0] = 1.0
    txt = np.zeros((1, 1, 8), np.float32)
    txt[0, 0, 0], txt[0, 0, 1] = 1.0, 1.0 + 1e-6
    calls = _counting_kernel(monkeypatch)
    got = EV.streaming_benchmark_eval(_port_embedder("bfloat16"), torch.from_numpy(txt),
                                      ["v0#0"], _feeds(vis, ["v0", "v1"], 2)[1], topk=0,
                                      rank_path="kernel")
    assert got["t2v_ranks"][0] == 1 and calls == []
    kernel = fused_sim_rank(torch.from_numpy(txt).to(torch.bfloat16),
                            torch.from_numpy(vis).to(torch.bfloat16), torch.tensor([0]),
                            prenormalized=True)
    assert kernel[0] == 2  # the guard is what keeps rank 1


def test_int8_streaming_topk_equals_laff_tpu():
    rng = np.random.default_rng(5)
    vis, txt = _unit(rng, 300, 2, 16), _unit(rng, 13, 2, 16)
    vis_ids = [f"v{i}" for i in range(300)]
    jfeed, feed = _feeds(vis, vis_ids, batch=64)
    want = JEV.int8_streaming_topk(_JaxEmbedder(), jnp.asarray(txt), jfeed, k=20)
    lapped = []
    got = EV.int8_streaming_topk(_port_embedder(), torch.from_numpy(txt), feed, k=20,
                                 chunk_t=8, lap=lapped.append)
    assert lapped == ["int8_stream", "nominate", "reembed", "exact_topk"]
    assert got["vis_ids"] == want[2] == vis_ids
    np.testing.assert_allclose(got["topk_vals"], want[0], atol=RESCORE_ATOL)
    np.testing.assert_array_equal(got["topk_idx"], want[1])
    exact = EV._flat_scores(flatten_heads(torch.from_numpy(txt)),
                            flatten_heads(torch.from_numpy(vis)), 2).numpy()
    np.testing.assert_allclose(got["topk_vals"], np.take_along_axis(exact, got["topk_idx"], 1),
                               atol=RESCORE_ATOL)
    assert got["int8_bytes"] == 304 * 32 + 304 * 4  # rows padded to a multiple of 8
    assert 30 <= got["union"] <= 13 * 30
