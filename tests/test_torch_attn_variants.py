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

from ecad_tpu_torch.ops import attention as port_attention
from ecad_tpu_torch.ops import (
    clamp_fd_attention,
    matmul_only_attention,
    max_exp2_attention,
    nomax_attention,
    nomax_attention_reference,
    transposed_attention,
)
from ecad_tpu_torch.ops.attention import clamp_scale
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


# ---------------------------------------------------------------------------
# X1-X4 on the Hopper body (csrc/attention_sm90.cu): its arithmetic,
# emulated, and the routing
# ---------------------------------------------------------------------------


def _chip_smoke_xattn():
    """chip_smoke.py's XATTN table, loaded from its file, for the tolerances
    its checks hold X1-X4 to on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.XATTN


def _hopper_x_body(q, k, v, mode):
    """csrc/attention_sm90.cu's X3 (`mode` "max"), X2 ("nomax") and X1
    ("matmul") modes in their own order, on bf16 (B, T, H, D) q, k, v: q ×
    bf16(log2e/√D), rounded to bf16 (X1: q as it is); per 128-key tile s =
    q·kᵀ in fp32; X3: the running max m of the pre-scaled scores, p =
    exp2(s − m), and Σp and o of the earlier tiles rescaled by exp2(m_old −
    m); X2: p = exp2(s), no max, no rescale; X1: p = s, no sum; Σp in fp32
    over the unrounded p, p rounded to bf16 for p·v against the max of its
    tile, summed in fp32 over the tiles, no pad keys (Tk % 128 == 0); one
    factor 1/Σp (X1: none), one cast."""
    if mode != "matmul":
        q = q * torch.tensor(clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    m = torch.full((*qf.shape[:3], 1), -torch.inf)
    l = torch.zeros((*qf.shape[:3], 1))
    o = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], 128):
        s = qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
        alpha = 1.0
        if mode == "max":
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, s, m = torch.exp2(m - mx), s - mx, mx
        p = s if mode == "matmul" else torch.exp2(s)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 128]
    out = o if mode == "matmul" else o * (1.0 / l)
    return out.to(torch.bfloat16).permute(0, 2, 1, 3)


def _least_atol_per_std(got, want, rtol=2.0 ** -7):
    """The least atol that passes `got` beside `rtol`, per the std of
    `want` (chip_smoke.py's `least_atol_per_std`)."""
    err = np.abs(got - want) - rtol * np.abs(want)
    return float(max(err.max(), 0.0)) / float(np.std(want))


# Pallas body → (the Hopper mode its emulation runs, its chip_smoke.py
# counter)
HOPPER_X = {"rowblock": ("max", "xattn_max"), "chunk2": ("max", "xattn_max"),
            "nomax": ("nomax", "xattn_nomax")}


@pytest.mark.parametrize("d", [72, 128])
@pytest.mark.parametrize("name", sorted(HOPPER_X))
def test_hopper_x_arithmetic_matches_pallas_body(interpret, name, d):
    """The Hopper body's X3 arithmetic (a running max over 128-key tiles, p
    rounded to bf16 against it) against ``k_rowblock`` (the row max) and
    ``k_chunk2`` (each 128-key half's max, merged), and its X2 arithmetic
    (exp2 with no max) against ``k_nomax``, in interpret mode at (1, 256,
    2, D) → 256 keys, bf16: the least atol per std that passes beside 2^-7
    relative stays below half of the share chip_smoke.py's XATTN holds the
    kernel to on the card, and the emulation passes that tolerance."""
    mode, counter = HOPPER_X[name]
    q, k, v = _qkv(5, 256, d)
    want = np.asarray(_body(interpret, name, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = _hopper_x_body(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                         mode).float().numpy()
    atol, rtol = _chip_smoke_xattn()[counter][2](torch.from_numpy(want))
    share = atol / float(np.std(want))
    assert rtol == 2.0 ** -7
    assert _least_atol_per_std(got, want) <= share / 2, _least_atol_per_std(got, want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("d", [72, 128])
def test_hopper_x1_arithmetic_matches_k_matmul_only(interpret, d):
    """The Hopper body's X1 arithmetic (q unscaled, s = q·kᵀ in fp32 per
    128-key tile rounded to bf16, p·v summed in fp32 over the tiles, one
    cast, no divide) against ``k_matmul_only`` in interpret mode at (1,
    256, 2, D) → 256 keys, bf16, within the std_bf16_tol(0.0025) that
    chip_smoke.py's XATTN holds the card's kernel to: 2^-7 relative (the
    output's own rounding) plus 0.0025 of the output's std. The output is
    unnormalised (std ≈ 130-180 here), and a bf16 rounding of one s that
    flips between two fp32 sum orders over D moves it by that s's ulp
    (0.0625 at |s| ≈ 11) times |v|: those flips are all of the error here
    (0.0014 of the std at D=128), as they are between the card's products
    and the plain version, so the share is not halved as for X2-X4, whose
    p passes through exp2. The emulation's own order matches the plain
    version's function exactly: the tile sums only reorder fp32 sums."""
    q, k, v = _qkv(8, 256, d)
    want = np.asarray(_body(interpret, "matmul_only",
                            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    got = _hopper_x_body(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                         "matmul").float().numpy()
    atol, rtol = _chip_smoke_xattn()["xattn_matmul_only"][2](torch.from_numpy(want))
    assert rtol == 2.0 ** -7
    assert atol == pytest.approx(0.0025 * float(torch.from_numpy(want).std()), rel=1e-6)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("d", [72, 128])
def test_hopper_x2_overflows_like_k_nomax(interpret, d):
    """Without a max, a score past 128 gives exp2 = +inf: with q × 64 on
    every other row, the Hopper X2 emulation is inf/NaN in exactly the
    elements where ``k_nomax`` is, in bf16, and agrees elsewhere."""
    q, k, v = _qkv(6, 256, d)
    q[:, ::2] *= 64
    want = np.asarray(_body(interpret, "nomax", *(jnp.asarray(a, jnp.bfloat16)
                                                  for a in (q, k, v))), np.float32)
    got = _hopper_x_body(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                         "nomax").float().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert 0 < np.isfinite(got).sum() < got.size
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **BF16_TOL)


def _hopper_fd_body(q, k, v):
    """csrc/attention_sm90.cu's X4 mode in its own order, on bf16 (B, T, H,
    D) q, k, v: q × bf16(log2e/√D), rounded to bf16; per 128-key tile s =
    q·kᵀ in fp32, p = exp2(clip(s, −100, 80)) rounded to bf16, keys past Tk
    at 0 (the last tile is short here); o += bf16(p)·v and the denominator
    += Σ bf16(p), both accumulated in fp32 (the ones column of the same
    product); one factor 1/Σ, one cast."""
    scale = torch.tensor(clamp_scale(q.shape[-1], q.dtype), dtype=q.dtype)
    qf = (q * scale).float().permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    den = torch.zeros((*qf.shape[:3], 1))
    o = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], 128):
        s = qf @ kf[:, :, k0:k0 + 128].transpose(-1, -2)
        p = torch.exp2(s.clamp(port_attention._CLAMP_LO, port_attention._CLAMP_HI))
        p = p.to(torch.bfloat16).float()
        den = den + p.sum(-1, keepdim=True)
        o = o + p @ vf[:, :, k0:k0 + 128]
    return (o * (1.0 / den)).to(torch.bfloat16).permute(0, 2, 1, 3)


@pytest.mark.parametrize("tk", [256, 200])
@pytest.mark.parametrize("name", ["transposed_fd", "transposed_subk_fd"])
def test_hopper_x4_arithmetic_matches_pallas_body(interpret, name, tk):
    """The Hopper body's X4 arithmetic (p = bf16(exp2(clip(s))), the
    denominator Σ bf16(p) from the same bf16 p in fp32, keys past Tk at 0)
    against ``k_transposed_fd`` and ``k_transposed_subk_fd`` in interpret
    mode at (1, 256, 2, 72) → 256 and → 200 keys (the Pallas wrapper pads
    the 200 to 256 and its ones row gives the pad keys weight 0), bf16: the
    least atol per std that passes beside 2^-7 relative stays below half of
    the share chip_smoke.py's XATTN holds X4 to on the card, and the
    emulation passes that tolerance."""
    q, k, v = _qkv(7, tk, 72)
    want = np.asarray(_body(interpret, name, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                      np.float32)
    got = _hopper_fd_body(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v))).float().numpy()
    atol, rtol = _chip_smoke_xattn()["xattn_fd"][2](torch.from_numpy(want))
    share = atol / float(np.std(want))
    assert rtol == 2.0 ** -7
    assert _least_atol_per_std(got, want) <= share / 2, _least_atol_per_std(got, want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# (wrapper, dtype, head dim, keys) → the launch it takes: ("sm90", counter)
# on the Hopper body, or the exception raised before any launcher
HARNESS_ROUTES = {
    "nomax_bf16_d72": (nomax_attention, "bf16", 72, 256, ("sm90", "xattn_nomax")),
    "nomax_bf16_d128": (nomax_attention, "bf16", 128, 256, ("sm90", "xattn_nomax")),
    "max_bf16_d72": (max_exp2_attention, "bf16", 72, 256, ("sm90", "xattn_max")),
    "max_bf16_d128": (max_exp2_attention, "bf16", 128, 256, ("sm90", "xattn_max")),
    "nomax_bf16_d80": (nomax_attention, "bf16", 80, 256, ValueError),
    "max_bf16_d80": (max_exp2_attention, "bf16", 80, 256, ValueError),
    "max_bf16_d120": (max_exp2_attention, "bf16", 120, 256, ValueError),
    "nomax_fp32_d72": (nomax_attention, "fp32", 72, 256, TypeError),
    "max_fp32_d128": (max_exp2_attention, "fp32", 128, 256, TypeError),
    "nomax_tk200_d72": (nomax_attention, "bf16", 72, 200, ValueError),
    "max_tk200_d128": (max_exp2_attention, "bf16", 128, 200, ValueError),
    "matmul_only_bf16_d72": (matmul_only_attention, "bf16", 72, 256,
                             ("sm90", "xattn_matmul_only")),
    "matmul_only_bf16_d128": (matmul_only_attention, "bf16", 128, 256,
                              ("sm90", "xattn_matmul_only")),
    "matmul_only_bf16_d80": (matmul_only_attention, "bf16", 80, 256, ValueError),
    "matmul_only_fp32_d72": (matmul_only_attention, "fp32", 72, 256, TypeError),
    "matmul_only_tk200_d128": (matmul_only_attention, "bf16", 128, 200, ValueError),
    "fd_bf16_d72": (clamp_fd_attention, "bf16", 72, 256, ("sm90", "xattn_fd")),
    "fd_tk200_d72": (clamp_fd_attention, "bf16", 72, 200, ("sm90", "xattn_fd")),
    "fd_bf16_d80": (clamp_fd_attention, "bf16", 80, 256, ValueError),
    "fd_bf16_d128": (clamp_fd_attention, "bf16", 128, 256, ValueError),
    "fd_fp32_d72": (clamp_fd_attention, "fp32", 72, 256, TypeError),
}


@pytest.mark.parametrize("case", sorted(HARNESS_ROUTES))
def test_harness_kernel_routing(case, monkeypatch):
    """X1, X2 and X3 in bf16 at head dim 72 or 128, and X4 at 72 with any
    Tk, launch the Hopper body (under ``xattn_matmul_only`` /
    ``xattn_nomax`` / ``xattn_max`` / ``xattn_fd``); X1-X4 at other head
    dims (the Hopper body is built for 72 and 128 only, X4 for 72), fp32
    (no kernel takes it on the card) and, for X1, X2 and X3, Tk = 200 (the
    reference counts its pad keys) raise before either launcher, the Hopper
    body's or csrc/attention.cu's.
    Tensors on the meta device reach the launch decision without a card;
    the launchers are replaced by recorders."""
    fn, dtype, d, tk, want = HARNESS_ROUTES[case]
    calls = []
    monkeypatch.setattr(port_attention, "_launch_sm90",
                        lambda q, k, v, counter, bias=None, n_pad=0: calls.append(
                            ("sm90", counter)))
    monkeypatch.setattr(port_attention, "_launch",
                        lambda q, k, v, bias, variant, n_pad: calls.append(("mma", variant)))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.empty((2, 256, 3, d), dtype=tdt, device="meta")
    kv = torch.empty((2, tk, 3, d), dtype=tdt, device="meta")
    if isinstance(want, type):
        with pytest.raises(want):
            fn(q, kv, kv)
        assert calls == []
    else:
        fn(q, kv, kv)
        assert calls == [want]
