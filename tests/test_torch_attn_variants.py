"""The attention-variant harness's plain versions (X1-X4, and K4 in its
``transposed`` rows) against the eight Pallas bodies of the JAX package's
``scripts/exp_attn_variants.py``, run in interpret mode on the CPU; the
Tk % 128 rule; and the port's harness on the CPU.

The script is loaded from its file with the repo root on ``sys.path`` (it
imports ``bench``), as ``tests/test_scripts_import.py`` loads it; nothing
in it changes. ``_call_transposed*`` take ``ECAD_EXP_INTERPRET=1``;
``_call`` has no interpret switch, so the loaded module's ``pl`` is
replaced by one whose ``pallas_call`` interprets. Inputs come from numpy
with a fixed seed and go to both sides; on the CPU each wrapper runs its
plain version, and chip_smoke.py holds the CUDA kernels against the same
plain versions on the card."""

import functools
import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from ecad_tpu_torch.ops import (
    clamp_fd_attention,
    matmul_only_attention,
    max_exp2_attention,
    nomax_attention,
    nomax_attention_reference,
    transposed_attention,
)
from ecad_tpu_torch.scripts import exp_attn_variants as port_harness

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Pallas body (by the harness's variant name) → the port's wrapper
PORT = {
    "matmul_only": matmul_only_attention,
    "nomax": nomax_attention,
    "rowblock": max_exp2_attention,
    "chunk2": max_exp2_attention,
    "transposed": transposed_attention,
    "transposed_subk": transposed_attention,
    "transposed_fd": clamp_fd_attention,
    "transposed_subk_fd": clamp_fd_attention,
}
CALL_BODIES = ("matmul_only", "nomax", "rowblock", "chunk2")  # launched by `_call`

# fp32: the same function on both sides, only the order of the fp32 sums
# differs (measured ≤ 3.6e-7 on outputs of std 0.1; 0 for matmul_only).
# bf16, softmax bodies: q·scale, p and the output round to bf16 on both
# sides; a sum in another order can flip the output's rounding (one ulp,
# 2^-8 relative) or p's (``chunk2`` rounds p against each half's max, the
# plain version against the row max), as for K4's CPU tests. bf16,
# matmul_only: the output is unnormalised (std ≈ 130-180 here, ulp 1-4),
# and a flipped bf16 rounding of one s moves it by that s's ulp times |v|;
# the atol is one part in 128 of the output's std.
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


def _tol(dtype, name, want):
    tol = dict(FP32_TOL if dtype == "fp32" else BF16_TOL)
    if name == "matmul_only":
        tol["atol"] *= float(np.std(want))
    return tol


@pytest.fixture(scope="module")
def reference():
    """The JAX harness, loaded from its file."""
    sys.path.insert(0, str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location(
            "script_exp_attn_variants", ROOT / "scripts" / "exp_attn_variants.py"
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT))
    return mod


@pytest.fixture
def interpret(reference, monkeypatch):
    """The harness with every Pallas body in interpret mode."""
    monkeypatch.setenv("ECAD_EXP_INTERPRET", "1")
    monkeypatch.setattr(reference, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec,
    ))
    return reference


def _body(mod, name, q, k, v, bq=128):
    """The Pallas body `name` on (B, T, H, D) arrays, through the harness's
    own wrappers and with its query tile `bq`."""
    if name in mod.VARIANTS:
        kernel, prescale = mod.VARIANTS[name]
        return mod._call(kernel, *mod._prep(q, k, v, bq, prescale), bq)
    if name == "transposed":
        return mod._call_transposed(q, k, v, bq)
    return mod._call_transposed_v2(q, k, v, bq, name)


def _qkv(seed, tk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, t, 2, d), dtype=np.float32) for t in (256, tk, tk))


def _both(mod, name, dtype, q, k, v, port=None):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(_body(mod, name, *(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    got = (port or PORT[name])(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt
    return got.float().numpy(), want


BODY_CASES = [(name, 72) for name in PORT] + [(name, 128) for name in CALL_BODIES]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name,d", BODY_CASES, ids=[f"{n}_d{d}" for n, d in BODY_CASES])
def test_plain_version_matches_pallas_body(interpret, name, d, dtype):
    """Each of the eight bodies at D=72 (a padded head dim, where the
    harness runs all eight) and the four `_call` bodies at D=128, at
    (1, 256, 2, D) with a 128-row query tile (two tiles; ``chunk2`` splits
    the 256 keys in two)."""
    got, want = _both(interpret, name, dtype, *_qkv(0, 256, d))
    np.testing.assert_allclose(got, want, **_tol(dtype, name, want))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_unaligned_keys_pallas_counts_pad_keys(interpret, dtype):
    """Tk = 200: ``_prep`` zero-pads the keys to 256 and only the ``*_fd``
    bodies mask them (the ones row of vᵀ is 0 past Tk), so the Pallas
    ``nomax`` weighs 56 keys with s = 0 and moves by more than 0.05 (0.074
    here), while ``transposed_fd`` stays within its tolerance of the plain
    version. The port refuses Tk % 128 != 0 in every wrapper whose body
    counts pad keys, and in the harness's K4 rows."""
    q, k, v = _qkv(1, 200, 72)
    got, want = _both(interpret, "nomax", dtype, q, k, v, port=nomax_attention_reference)
    assert np.abs(got - want).max() > 0.05
    got, want = _both(interpret, "transposed_fd", dtype, q, k, v)
    np.testing.assert_allclose(got, want, **_tol(dtype, "transposed_fd", want))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for fn in (matmul_only_attention, nomax_attention, max_exp2_attention,
               port_harness.TRANSPOSED["transposed"],
               port_harness.TRANSPOSED["transposed_subk"]):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(*t)


def test_nomax_overflows_like_the_pallas_body(interpret):
    """Without a max, exp2 of a score past 128 is +inf in fp32: the plain
    version gives NaN in exactly the rows where the Pallas body does."""
    q, k, v = _qkv(3, 256, 128)
    q[:, ::2] *= 64
    got, want = _both(interpret, "nomax", "fp32", q, k, v)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert 0 < np.isfinite(got).sum() < got.size
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **FP32_TOL)


def test_port_harness_main_on_cpu(monkeypatch, capsys):
    """The port's harness through its `main` with `SHAPES` cut to two tiny
    shapes: one JSON row per variant (8 at D=72, 4 at D=128) in the
    reference's order, no time on the CPU, and errors against the plain
    exact softmax of a bf16 output's size."""
    monkeypatch.setattr(port_harness, "SHAPES", {
        "tiny72": dict(b=1, h=3, t=256, d=72),
        "tiny128": dict(b=1, h=2, t=128, d=128),
    })
    rows = port_harness.main(["--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    want = [f"exp_tiny72_{n}" for n in ("transposed_fd", "transposed_subk",
                                        "transposed_subk_fd", "transposed", *CALL_BODIES)]
    want += [f"exp_tiny128_{n}" for n in CALL_BODIES]
    assert [r["metric"] for r in rows] == want
    for r in rows:
        assert r["value"] is None and r["unit"] == "ms"
        detail = r["detail"]
        assert detail["card"] == "cpu" and detail["calls"] == 1 and detail["bound_ms"] > 0
        err = detail["max_abs_err_vs_plain_bf16"]
        if r["metric"].endswith("matmul_only"):
            assert err is None
        else:
            assert 0 <= err < 0.02, r
    # only known shapes are accepted
    with pytest.raises(SystemExit):
        port_harness.main(["--device", "cpu", "--shape=flux1024"])
