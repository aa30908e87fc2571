"""The sharded attention (`models.common.sharded_attention`) over spawned
gloo ranks on the CPU, against the plain attention on the whole tensors and
against the JAX package's `_shard_map_attention` on the 8-device CPU mesh.

Each rank holds the shard the reference's shard_map specs give it
(ecad_tpu/models/common.py:466-490): its dp rows, its tp heads, its sp
query tokens; K and V sp-sharded and all-gathered for self-attention (no
bias, Tk divisible), whole for biased cross-attention; a bias cut along
the batch, heads and query axes it spans. The ranks' outputs are put back
together and compared. fp32 throughout; the shards' sums run in the same
order as the whole tensors' (attention has no cross-batch, cross-head or
cross-query sums), so the tolerance is a few fp32 ulps: atol = rtol =
1e-6."""

import itertools
import json

import numpy as np
import pytest
import torch

from ecad_tpu_torch.models.common import sharded_attention
from ecad_tpu_torch.ops import fused_attention
from ecad_tpu_torch.parallel import mesh as tmesh
from ecad_tpu_torch.parallel.launch import spawn

TOL = dict(rtol=1e-6, atol=1e-6)
B, TQ, H, D = 4, 16, 4, 16
TK_SELF, TK_CROSS = 16, 12
BIASES = ("none", "key_padding", "dense")
LAYOUTS_2 = [(1, 2, 1), (1, 1, 2)]  # (dp, sp, tp) over 2 ranks
LAYOUTS_4 = [(2, 1, 2), (1, 2, 2)]  # over 4 ranks


def case_inputs(bias_name: str):
    """q, k, v (B, T, H, D) and the bias: self-attention without one, a
    (B, 1, 1, Tk) key-padding bias (0 / −1e9, lengths 12, 9, 5, 1) or a
    dense (1, H, Tq, Tk) one, both on 12 text keys."""
    rng = np.random.default_rng(BIASES.index(bias_name))
    tk = TK_SELF if bias_name == "none" else TK_CROSS
    q = rng.standard_normal((B, TQ, H, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, tk, H, D), dtype=np.float32) for _ in range(2))
    bias = None
    if bias_name == "key_padding":
        lengths = np.array([12, 9, 5, 1])
        bias = np.where(np.arange(tk)[None] < lengths[:, None], 0.0, -1e9)
        bias = bias[:, None, None, :].astype(np.float32)
    elif bias_name == "dense":
        bias = rng.standard_normal((1, H, TQ, tk), dtype=np.float32)
    return q, k, v, bias


def local_inputs(mesh, q, k, v, bias):
    """The rank's operands as the reference's in_specs cut them, and
    whether K and V are gathered."""
    def cut(x, axis, dim):
        return mesh.shard(x, axis, dim) if mesh.size(axis) > 1 else x

    gather = bias is None and k.shape[1] % mesh.size("sp") == 0 and mesh.size("sp") > 1
    ql = cut(cut(cut(q, "dp", 0), "sp", 1), "tp", 2)
    kl, vl = (cut(cut(x, "dp", 0), "tp", 2) for x in (k, v))
    if gather:
        kl, vl = cut(kl, "sp", 1), cut(vl, "sp", 1)
    bl = bias
    if bias is not None:
        if bias.shape[0] == q.shape[0]:
            bl = cut(bl, "dp", 0)
        if bias.shape[1] == q.shape[2]:
            bl = cut(bl, "tp", 1)
        if bias.shape[2] == q.shape[1]:
            bl = cut(bl, "sp", 2)
    return ql, kl, vl, bl, gather


def _attention_rank(rank, world, layouts, out):
    rows = {}
    for dp, sp, tp in layouts:
        mesh = tmesh.create_mesh(dp=dp, tp=tp, sp=sp)
        for bias_name in BIASES:
            q, k, v, bias = (None if a is None else torch.from_numpy(a)
                             for a in case_inputs(bias_name))
            ql, kl, vl, bl, gather = local_inputs(mesh, q, k, v, bias)
            o = sharded_attention(ql, kl, vl, bl, mesh, gather)
            rows[f"{dp},{sp},{tp},{bias_name}"] = {
                "coord": [mesh.coord(a) for a in ("dp", "sp", "tp")],
                "out": o.tolist(), "gathers": mesh.calls.get("all_gather/sp", 0),
                "shape": list(ql.shape), "tk": kl.shape[1] * (sp if gather else 1),
            }
            mesh.calls.clear()
    (out / f"rank{rank}.json").write_text(json.dumps(rows))


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    """Every case's output put back together from the ranks' shards, with
    what each rank saw: {case: (whole output, [(shape, tk, gathers)])}."""
    out = tmp_path_factory.mktemp("attn")
    results = {}
    for world, layouts in ((2, LAYOUTS_2), (4, LAYOUTS_4)):
        d = out / str(world)
        d.mkdir()
        spawn(_attention_rank, world, (layouts, d), timeout_s=90, threads=1, init_dir=d)
        ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]
        for key in ranks[0]:
            dp, sp, tp = (int(x) for x in key.split(",")[:3])
            whole = np.zeros((B, TQ, H, D), np.float32)
            bq, tq, hq = B // dp, TQ // sp, H // tp
            for rows in ranks:
                c = rows[key]["coord"]
                whole[c[0] * bq:(c[0] + 1) * bq, c[1] * tq:(c[1] + 1) * tq,
                      c[2] * hq:(c[2] + 1) * hq] = np.array(rows[key]["out"], np.float32)
            seen = [(rows[key]["shape"], rows[key]["tk"], rows[key]["gathers"]) for rows in ranks]
            results[key] = (whole, seen)
    return results


CASES = [(*lay, b) for lay, b in itertools.product(LAYOUTS_2 + LAYOUTS_4, BIASES)]


@pytest.mark.parametrize("dp,sp,tp,bias_name", CASES,
                         ids=[f"dp{c[0]}-sp{c[1]}-tp{c[2]}-{c[3]}" for c in CASES])
def test_sharded_attention_matches_plain(rank_outputs, dp, sp, tp, bias_name):
    """Each layout and bias: the shards put together equal the plain
    attention on the whole tensors; each rank attended with its local
    shapes (its rows, heads and query tokens) over all keys, which
    self-attention on an sp mesh reached by two all-gathers (K and V)."""
    whole, seen = rank_outputs[f"{dp},{sp},{tp},{bias_name}"]
    q, k, v, bias = (None if a is None else torch.from_numpy(a) for a in case_inputs(bias_name))
    want = fused_attention(q, k, v, bias)
    np.testing.assert_allclose(whole, want.numpy(), **TOL)
    gathers = 2 if (bias_name == "none" and sp > 1) else 0
    for shape, tk, n in seen:
        assert shape == [B // dp, TQ // sp, H // tp, D]
        assert tk == k.shape[1] and n == gathers


@pytest.mark.parametrize("bias_name", ["none", "key_padding"])
def test_sharded_attention_matches_reference_shard_map(rank_outputs, bias_name):
    """dp=1 × sp=2 × tp=2 against the reference's `_shard_map_attention` on
    the 8-device CPU mesh (its kernel XLA's attention): the same specs, the
    same K/V all-gather for self-attention, the same output."""
    import jax

    from ecad_tpu.models import common as jcommon
    from ecad_tpu.parallel import create_mesh as jcreate

    q, k, v, bias = case_inputs(bias_name)
    mesh = jcreate(dp=1, sp=2, tp=2, devices=jax.devices()[:4])
    kernel = lambda q_, k_, v_, b_: jax.nn.dot_product_attention(q_, k_, v_, bias=b_)  # noqa: E731
    want = jcommon._shard_map_attention(kernel, mesh, q, k, v, bias)
    assert want is not None
    np.testing.assert_allclose(rank_outputs[f"1,2,2,{bias_name}"][0], np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_reference_wrapper_falls_back_where_the_port_computes_replicated():
    """Where the reference's wrapper returns None (heads not divisible by
    tp, query tokens not divisible by sp, other axis names), XLA computes
    the same function unsharded; the port keeps such sites whole on every
    rank (`tp_degree`, `seq_parallel`): the same function, replicated."""
    import jax

    from ecad_tpu.models import common as jcommon
    from ecad_tpu.parallel import create_mesh as jcreate
    from ecad_tpu_torch.models.common import seq_parallel, tp_degree

    q, k, v, _ = case_inputs("none")
    kernel = lambda q_, k_, v_, b_: jax.nn.dot_product_attention(q_, k_, v_, bias=b_)  # noqa: E731
    mesh = jcreate(dp=1, tp=8, devices=jax.devices()[:8])  # 4 heads over tp=8
    assert jcommon._shard_map_attention(kernel, mesh, q, k, v, None) is None
    m = tmesh.Mesh(tmesh.rank_layout(1, 8, 1, 8), rank=0)
    assert tp_degree(m, H) == 1 and tp_degree(m, 16) == 8
    sp3 = tmesh.Mesh(tmesh.rank_layout(1, 1, 3, 3), rank=0)
    assert not seq_parallel(sp3, TQ) and seq_parallel(sp3, 15)
    assert not seq_parallel(None, TQ)
