"""The port's int8 serving quantization (ecad_tpu_torch/ops/quant.py) against
the reference's (ecad_tpu/ops/quant.py) on the CPU.

Inputs come from numpy with a fixed seed and go to both sides. The port
copies the reference's arithmetic in its order, so the int8 values, the
fp32 scales, the int32 sums and the dequantized outputs of the dynamic,
static and Int8Dense forms are equal bit for bit: at the shape of one
PixArt-α projection (x (2, 300, 1152) bf16, weight 1152 → 4608) and at a
tiny width."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.ops import quant as jq
from ecad_tpu_torch.models.bridge import reference_path
from ecad_tpu_torch.models.bridge import _convert as bridge_convert
from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
from ecad_tpu_torch.ops import quant as tq

# (batch, tokens, in, out, dtype): the served projection and a tiny one
SHAPES = {
    "pixart_ff_in_bf16": (2, 300, 1152, 4608, "bfloat16"),
    "tiny_fp32": (3, 5, 64, 72, "float32"),
}
JDT = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _data(name, seed=0):
    b, t, k, n, dt = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, k), dtype=np.float32)
    x[0, 1] *= 40.0  # one outlier token
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.02  # flax (in, out)
    bias = rng.standard_normal((n,), dtype=np.float32) * 0.1
    # round to the dtype once, on the numpy side, so both see the same values
    cast = lambda a: np.asarray(jnp.asarray(a, JDT[dt]).astype(jnp.float32))  # noqa: E731
    return cast(x), cast(w), cast(bias), dt


def _jax(a, dt):
    return jnp.asarray(a, JDT[dt])


def _torch(a, dt):
    return torch.from_numpy(np.array(a)).to(TDT[dt])


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quantize_int8_values_and_scales_equal_reference(name):
    """Per-token (last axis) for activations, per-output-channel for weights
    (the reference's axis 0 of (in, out) is the port's axis 1 of (out, in))."""
    x, w, _, dt = _data(name)
    jqx, jsx = jq.quantize_int8(_jax(x, dt), axis=-1)
    tqx, tsx = tq.quantize_int8(_torch(x, dt), dim=-1)
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    assert tqx.dtype == torch.int8 and tsx.dtype == torch.float32
    jqw, jsw = jq.quantize_int8(_jax(w, dt), axis=0)
    tqw, tsw = tq.quantize_weight(_torch(w.T, dt))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw).T)
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw).reshape(-1))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_int32_sums_equal_reference(name):
    x, w, _, dt = _data(name)
    jqx, _ = jq.quantize_int8(_jax(x, dt).reshape(-1, x.shape[-1]), axis=-1)
    jqw, _ = jq.quantize_int8(_jax(w, dt), axis=0)
    want = jax.lax.dot_general(jqx, jqw, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq.int8_matmul(torch.from_numpy(np.asarray(jqx)),
                         torch.from_numpy(np.ascontiguousarray(np.asarray(jqw).T)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_dense(dot_general, x, w, bias, dt):
    dense = fnn.Dense(w.shape[1], dtype=JDT[dt], dot_general=dot_general)
    return dense.apply({"params": {"kernel": _jax(w, dt), "bias": _jax(bias, dt)}},
                       _jax(x, dt))


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("form", ["dynamic", "static", "int8dense", "int8dense_static"])
def test_dequantized_outputs_equal_reference(name, form):
    """The reference's nn.Dense with its int8 dot_general (dynamic, and static
    at a calibrated amax of 3.7) and its Int8Dense (per-token and static
    activations), bias included, against the port's on the same values."""
    x, w, bias, dt = _data(name)
    amax = 3.7
    if form in ("dynamic", "static"):
        dg = jq.int8_dot_general if form == "dynamic" else jq.static_int8_dot_general(amax)
        want = _jax_dense(dg, x, w, bias, dt)
        fn = tq.maybe_quant("int8" if form == "dynamic" else "int8_static",
                            "site", {"site": amax})
        got = fn(_torch(x, dt), _torch(w.T, dt), _torch(bias, dt))
    else:
        act = amax if form == "int8dense_static" else None
        mod = jq.Int8Dense(w.shape[1], axes=(None, None), dtype=JDT[dt], act_amax=act)
        jqw, jsw = jq.quantize_int8(jnp.asarray(w), axis=0)
        params = {"kernel": jqw, "scale": jsw.reshape(-1), "bias": jnp.asarray(bias)}
        want = mod.apply({"params": params}, _jax(x, dt))
        port = tq.Int8Dense(w.shape[0], w.shape[1], dtype=TDT[dt], act_amax=act)
        port.load_state_dict(bridge_convert(jax.tree.map(np.asarray, params)))
        with torch.inference_mode():
            got = port(_torch(x, dt))
    assert got.dtype == TDT[dt]
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_maybe_quant_dispatch():
    """The reference's test_maybe_quant_dot_general, case by case, plus the
    static mode's table lookup with its dynamic fallback."""
    assert tq.maybe_quant(None) is None
    assert tq.maybe_quant("none") is None
    assert tq.maybe_quant("int8") is tq.int8_linear
    # int8_w is structural (the Int8Dense swap), not a product override
    assert tq.maybe_quant("int8_w") is None
    assert tq.maybe_quant("int8_w_static") is None
    with pytest.raises(ValueError, match="unknown quant mode 'fp4'"):
        tq.maybe_quant("fp4")
    assert tq.maybe_quant("int8_static", "a/b", None) is tq.int8_linear
    assert tq.maybe_quant("int8_static", "a/b", (("a/c", 2.0),)) is tq.int8_linear
    assert tq.maybe_quant("int8_static", "a/b", (("a/b", 2.0),)).keywords == {"act_amax": 2.0}
    for quant, cls in ((None, torch.nn.Linear), ("int8", tq.QuantLinear),
                       ("int8_static", tq.QuantLinear), ("int8_w", tq.Int8Dense),
                       ("int8_w_static", tq.Int8Dense)):
        assert type(tq.dense(8, 16, torch.float32, quant, "s", {"s": 1.0})) is cls
    assert tq.dense(8, 16, torch.float32, "int8_w_static", "s", {"s": 1.5}).act_amax == 1.5
    assert tq.dense(8, 16, torch.float32, "int8_w", "s", {"s": 1.5}).act_amax is None


def test_int8_dense_storage_and_bridge_round_trip():
    """An Int8Dense holds an int8 (out, in) weight (1 byte a weight) and an
    fp32 per-channel scale; the reference's quantize_params_tree of a float
    Dense, carried across by the bridge, lands in it unchanged, and the
    port's own quantize_params_tree of the same float weights gives the
    same tensors."""
    din, dout = 256, 512
    rng = np.random.default_rng(1)
    fparams = {"kernel": rng.standard_normal((din, dout), dtype=np.float32) * 0.02,
               "bias": rng.standard_normal((dout,), dtype=np.float32)}
    ref = {"kernel": jax.ShapeDtypeStruct((din, dout), jnp.int8),
           "scale": jax.ShapeDtypeStruct((dout,), jnp.float32),
           "bias": jax.ShapeDtypeStruct((dout,), jnp.float32)}
    jparams = jax.tree.map(np.asarray, jq.quantize_params_tree(fparams, ref))
    state = bridge_convert({"site": jparams})
    port = torch.nn.Module()
    port.site = tq.Int8Dense(din, dout, dtype=torch.float32)
    port.load_state_dict(state)
    assert port.site.weight.dtype == torch.int8 and port.site.weight.shape == (dout, din)
    assert port.site.weight.element_size() == 1
    assert port.site.scale.dtype == torch.float32 and port.site.scale.shape == (dout,)
    np.testing.assert_array_equal(port.site.weight.numpy(), jparams["kernel"].T)
    np.testing.assert_array_equal(port.site.scale.numpy(), jparams["scale"])
    float_state = {"site.weight": torch.from_numpy(fparams["kernel"].T.copy()),
                   "site.bias": torch.from_numpy(fparams["bias"])}
    mine = tq.quantize_params_tree(float_state, port)
    for k in ("site.weight", "site.scale", "site.bias"):
        assert torch.equal(mine[k], port.state_dict()[k]), k
    # a weight already in int8 passes through: quantizing twice would lose it
    again = tq.quantize_params_tree(mine, port)
    assert all(again[k] is mine[k] for k in mine)


def test_padding_of_short_rows():
    """Fewer than 17 rows (FLUX's adaLN linear at batch 1) go to torch._int_mm
    as 17, the zero rows sliced off: the sums equal the reference's at m=1,
    and one call is counted."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 64), dtype=np.float32)
    w = rng.standard_normal((64, 384), dtype=np.float32) * 0.02
    want = jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())))
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape), b.stride()))
        return real(a, b)

    reset_launch_counts()
    torch._int_mm = spy
    try:
        got = tq.int8_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    finally:
        torch._int_mm = real
    assert seen == [((17, 64), (64, 384), (1, 64))]  # the weight's .t() view
    assert launch_counts()["int8_matmul"] == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_matmul(torch.zeros(20, 60, dtype=torch.int8),
                       torch.zeros(16, 60, dtype=torch.int8))


def test_cached_weight_quantization_equals_per_call():
    """A QuantLinear quantizes its weight once and again only when the weight
    changes; its outputs equal the per-call quantization's bit for bit."""
    torch.manual_seed(0)
    lin = tq.dense(64, 96, torch.float32, "int8")
    torch.nn.init.normal_(lin.weight, std=0.02)
    x = torch.randn(4, 7, 64)
    with torch.inference_mode():
        got = lin(x)
        wq = lin._wq
        assert lin(x) is not got and lin._wq is wq  # cached
        np.testing.assert_array_equal(got.numpy(),
                                      tq.int8_linear(x, lin.weight, lin.bias).numpy())
    with torch.no_grad():
        lin.weight.mul_(2.0)
    with torch.inference_mode():
        np.testing.assert_array_equal(lin(x).numpy(),
                                      tq.int8_linear(x, lin.weight, lin.bias).numpy())
    assert lin._wq is not wq


def test_merge_amax_and_reference_path():
    tables = ({"a": 1.0, "b": 3.0}, {"a": 2.0, "c": 0.5})
    assert tq.merge_amax(*tables) == jq.merge_amax(*tables) == {"a": 2.0, "b": 3.0, "c": 0.5}
    assert reference_path("blocks.3.attn1.to_q") == "block_3/attn1/to_q"
    assert reference_path("single_blocks.12.proj_mlp") == "single_block_12/proj_mlp"
    assert reference_path("adaln_single.timestep_embedder.linear_1") == (
        "adaln_single/timestep_embedder/linear_1")
    assert reference_path("proj_out") == "proj_out"
