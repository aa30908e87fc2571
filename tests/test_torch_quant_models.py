"""The int8 serving modes through the port's PixArt and FLUX transformers and
pipelines against the reference's, on the CPU (tiny configurations, fp32,
parameters carried across by models/bridge.py, int8_w trees included).

Both sides quantize the same activations with the same arithmetic, so they
agree to fp32 round-off (1e-4 here), except where an activation that the
two sides compute a rounding apart lands on a quantization tie; none does
at these seeds. The port's own error against its float path is held to the
reference's bounds in tests/test_quant.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import flux as jfx
from ecad_tpu.models import pixart as jpx
from ecad_tpu.ops import quant as jq
from ecad_tpu.pipelines import flux_pipeline as jfp
from ecad_tpu.pipelines import pixart_pipeline as jpp
from ecad_tpu.schedules import FluxCacheSchedule as JFSched
from ecad_tpu.schedules.pixart import PixArtCacheSchedule as JPSched
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models.bridge import flux_state_dict, pixart_state_dict
from ecad_tpu_torch.models.common import rebuild
from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
from ecad_tpu_torch.ops import quant as tq
from ecad_tpu_torch.pipelines import flux_pipeline as tfp
from ecad_tpu_torch.pipelines import pixart_pipeline as tpp
from ecad_tpu_torch.schedules import FluxCacheSchedule as TFSched
from ecad_tpu_torch.schedules.pixart import PixArtCacheSchedule as TPSched

MODES = ("int8", "int8_static", "int8_w", "int8_w_static")
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
GRID = (4, 4)


def _np_tree(params):
    return jax.tree.map(np.asarray, fnn.meta.unbox(params))


def _pixart_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 8, 4), dtype=np.float32),
            rng.standard_normal((B, 8, 32), dtype=np.float32),
            np.array([999.0, 501.0], np.float32))


def _flux_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 16, 16), dtype=np.float32),
            rng.standard_normal((B, 8, 32), dtype=np.float32),
            rng.standard_normal((B, 24), dtype=np.float32),
            np.array([0.93, 0.41], np.float32), np.array([5.0, 3.5], np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


class Family:
    """One model family on both sides: its configs, params, forward and
    calibration inputs."""

    def __init__(self, name):
        self.name = name
        self.j, self.t = (jpx, tpx) if name == "pixart" else (jfx, tfx)

    def jcfg(self, quant=None, act_scales=None):
        return self.j.PixArtConfig.tiny(dtype=jnp.float32, quant=quant, act_scales=act_scales) \
            if self.name == "pixart" else \
            self.j.FluxConfig.tiny(dtype=jnp.float32, quant=quant, act_scales=act_scales)

    def tcfg(self, quant=None, act_scales=None):
        cls = self.t.PixArtConfig if self.name == "pixart" else self.t.FluxConfig
        return cls.tiny(dtype=torch.float32, quant=quant, act_scales=act_scales)

    @functools.lru_cache(maxsize=None)
    def jparams(self, quant=None):
        """The reference's float params, or their int8_w conversion by its
        quantize_params_tree, as real weights are converted."""
        init = jpx.init_params if self.name == "pixart" else jfx.init_flux_params
        if quant is None:
            return _np_tree(init(self.jcfg(), 0)[1])
        ref = fnn.meta.unbox(jax.eval_shape(lambda: init(self.jcfg(quant), 0)[1]))
        return jax.tree.map(np.asarray, jq.quantize_params_tree(self.jparams(), ref))

    @functools.lru_cache(maxsize=None)
    def jtable(self, base):
        """The reference's calibration table of the float (None) or int8_w
        model, as a config takes it."""
        table = self.jcalibrate(self.jcfg(base), self.jparams(base), self.inputs(3))
        return tuple(sorted(table.items()))

    def port(self, quant, params, act_scales=None):
        cls = tpx.PixArtTransformer if self.name == "pixart" else tfx.FluxTransformer
        bridge = pixart_state_dict if self.name == "pixart" else flux_state_dict
        model = cls(self.tcfg(quant, act_scales)).eval().requires_grad_(False)
        model.load_state_dict(bridge(params), strict=True)
        return model

    def inputs(self, seed=0):
        return _pixart_inputs(seed) if self.name == "pixart" else _flux_inputs(seed)

    def jforward(self, cfg, params, inputs):
        if self.name == "pixart":
            model = jpx.PixArtTransformer(cfg)
            fn = lambda p, *a: model.apply(  # noqa: E731
                {"params": p}, *a, jpx.init_cache(cfg, B), jpx.full_step_mask(cfg))[0]
        else:
            model = jfx.FluxTransformer(cfg)
            fn = lambda p, *a: model.apply(  # noqa: E731
                {"params": p}, *a, {}, jfx.full_flux_mask(cfg), GRID)[0]
        return jax.jit(fn)(params, *inputs)

    def targs(self, model, inputs):
        c = model.config
        if self.name == "pixart":
            return (*_t(inputs), tpx.init_cache(c, B, device="cpu"), tpx.full_step_mask(c))
        return (*_t(inputs), {}, tfx.full_flux_mask(c), GRID)

    def tforward(self, model, inputs):
        with torch.inference_mode():
            return model(*self.targs(model, inputs))[0]

    def jcalibrate(self, cfg, params, inputs):
        model = (jpx.PixArtTransformer if self.name == "pixart" else jfx.FluxTransformer)(cfg)
        if self.name == "pixart":
            return jq.calibrate_dense_amax(model, {"params": params}, *inputs,
                                           jpx.init_cache(cfg, B), jpx.full_step_mask(cfg))
        return jq.calibrate_dense_amax(model, {"params": params}, *inputs, {},
                                       jfx.full_flux_mask(cfg), GRID)


FAMILIES = {n: Family(n) for n in ("pixart", "flux")}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_calibration_tables_match_reference(family):
    """The static modes' calibration: int8_static's on the float model,
    int8_w_static's on the int8_w one. The same keys as the reference's
    calibrate_dense_amax (every Dense and Int8Dense by module path, adaLN
    and embedders included), values within fp32 round-off."""
    f = FAMILIES[family]
    for base in (None, "int8_w"):
        want = dict(f.jtable(base))
        model = f.port(base, f.jparams(base))
        got = tq.calibrate_dense_amax(model, *f.targs(model, f.inputs(3)))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    block = "block_0/attn1/to_q" if family == "pixart" else "single_block_2/proj_mlp"
    assert block in got


# each (family, mode) is held to the reference once: by one forward here,
# or by a trajectory (whose first step is such a forward) below
TRAJECTORIES = (("pixart", "int8"), ("flux", "int8_static"), ("pixart", "int8_w"),
                ("flux", "int8_w_static"))
FORWARDS = tuple((f, q) for f in sorted(FAMILIES) for q in MODES if (f, q) not in TRAJECTORIES)


@pytest.mark.parametrize("family,quant", FORWARDS)
def test_bridged_forward_matches_reference(family, quant):
    """One forward of every recomputed slot, the static modes with the
    reference's calibration table in both configs."""
    f = FAMILIES[family]
    base = "int8_w" if quant in tq.WEIGHT_MODES else None
    params = f.jparams(base)
    inputs = f.inputs(2)
    table = f.jtable(base) if quant in tq.STATIC_MODES else None
    want = f.jforward(f.jcfg(quant, table), params, inputs)
    model = f.port(quant, params, table)
    reset_launch_counts()
    got = f.tforward(model, inputs)
    _close(got, want)
    assert launch_counts()["int8_matmul"] > 0


def _pixart_schedules(steps, blocks):
    g = np.random.default_rng(7).random((steps, blocks, 3)) < 0.6
    return (JPSched.from_numpy(g.reshape(steps, -1), steps, blocks),
            TPSched.from_numpy(g.reshape(steps, -1), steps, blocks))


def _flux_schedules(steps, cfg):
    n = (cfg.num_blocks + cfg.num_single_blocks) * 3
    g = np.random.default_rng(1).random(steps * n) < 0.32
    return tuple(S.from_numpy(g, steps, cfg.num_blocks, num_single_blocks=cfg.num_single_blocks)
                 for S in (JFSched, TFSched))


@pytest.mark.parametrize("family,quant", TRAJECTORIES)
def test_trajectory_matches_reference(family, quant):
    """Two steps, the second under a cached mask (PixArt: DPM-Solver++ with
    CFG and text masks; FLUX: flow-match Euler at guidance 5), the same
    noise on both sides, against the reference's pipeline of the same
    mode."""
    f = FAMILIES[family]
    steps = 2
    base = "int8_w" if quant in tq.WEIGHT_MODES else None
    params = f.jparams(base)
    table = f.jtable(base) if quant in tq.STATIC_MODES else None
    jcfg, model = f.jcfg(quant, table), f.port(quant, params, table)
    rng = np.random.default_rng(11)
    if family == "pixart":
        jsched, tsched = _pixart_schedules(steps, jcfg.num_blocks)
        data = (rng.standard_normal((B, 8, 8, 4), dtype=np.float32),
                rng.standard_normal((B, 8, 32), dtype=np.float32),
                rng.standard_normal((B, 8, 32), dtype=np.float32),
                (np.arange(8)[None] < np.array([[3], [8]])).astype(np.int32),
                (np.arange(8)[None] < 1).repeat(B, 0).astype(np.int32))
        jpipe = jpp.PixArtPipeline(jpp.PixArtPipelineConfig(jcfg, steps), params, jsched)
        tpipe = tpp.PixArtPipeline(tpp.PixArtPipelineConfig(model.config, steps), model, tsched)
    else:
        jsched, tsched = _flux_schedules(steps, jcfg)
        data = (rng.standard_normal((B, 16, jcfg.in_channels), dtype=np.float32),
                rng.standard_normal((B, jcfg.text_len, jcfg.joint_dim), dtype=np.float32),
                rng.standard_normal((B, jcfg.pooled_dim), dtype=np.float32))
        jpipe = jfp.FluxPipeline(jfp.FluxPipelineConfig(jcfg, steps, height=64, width=64),
                                 params, jsched)
        tpipe = tfp.FluxPipeline(
            tfp.FluxPipelineConfig(model.config, steps, height=64, width=64), model, tsched)
    want = jpipe.build_denoise_fn(donate=False)(params, *data)
    got = tpipe.build_denoise_fn()(*_t(data))
    assert tpipe.masks == jpipe.masks
    _close(got, want)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_error_against_its_float_path(family):
    """The port's quantized models made from its float model by `rebuild`
    (the storage modes quantize the float weights, the others share them),
    against that float model: within the reference's bounds
    (test_pixart_block_int8_close_to_bf16 0.06, test_flux_block_int8_close_to_bf16
    and test_flux_int8_w_close_to_fp32_and_half_bytes 0.08); the static
    modes within max(3 × the dynamic error, 0.02) of the float output, an
    empty table equal to the dynamic mode bit for bit; FLUX's int8_w
    weights under 0.65 of the bf16 bytes (the reference's bound: its tiny
    embedders and fp32 scales weigh more than at full width)."""
    f = FAMILIES[family]
    init = tpx.init_model if family == "pixart" else tfx.init_model
    fmodel = init(f.tcfg(), 0, "cpu")
    inputs = f.inputs(4)
    want = f.tforward(fmodel, inputs).numpy()
    bound = 0.06 if family == "pixart" else 0.08
    out = {}
    for quant in MODES:
        table = None
        if quant in tq.STATIC_MODES:
            base = rebuild(fmodel, f.tcfg("int8_w" if quant == "int8_w_static" else None))
            table = tuple(sorted(tq.merge_amax(*(
                tq.calibrate_dense_amax(base, *f.targs(base, f.inputs(s))) for s in (5, 6)
            )).items()))
        model = rebuild(fmodel, f.tcfg(quant, table))
        out[quant] = f.tforward(model, inputs).numpy()
        assert np.isfinite(out[quant]).all()
        if quant in ("int8", "int8_w"):
            assert _rel_err(out[quant], want) < bound, (quant, _rel_err(out[quant], want))
    scale = np.abs(want).max()
    for static, dynamic in (("int8_static", "int8"), ("int8_w_static", "int8_w")):
        err_static = np.abs(out[static] - want).max() / scale
        err_dyn = np.abs(out[dynamic] - want).max() / scale
        assert err_static < max(3 * err_dyn, 0.02), (static, err_static, err_dyn)
        empty = f.tforward(rebuild(fmodel, f.tcfg(static, ())), inputs).numpy()
        np.testing.assert_array_equal(empty, out[dynamic])

    if family == "flux":
        def nbytes(model):
            return sum(p.numel() * p.element_size() for p in model.parameters())

        bf16 = tfx.init_model(tfx.FluxConfig.tiny(), 0, "cpu")
        q_bytes = nbytes(rebuild(bf16, tfx.FluxConfig.tiny(quant="int8_w")))
        assert q_bytes < 0.65 * nbytes(bf16), (q_bytes, nbytes(bf16))


def test_rebuild_shares_the_float_weights():
    """`rebuild` to int8 or int8_static takes the float model's tensors by
    assignment (no copy); to int8_w it quantizes them per output channel."""
    fmodel = tpx.init_model(tpx.PixArtConfig.tiny(), 0, "cpu")
    shared = rebuild(fmodel, tpx.PixArtConfig.tiny(quant="int8"))
    ptrs = {n: p.data_ptr() for n, p in fmodel.named_parameters()}
    assert all(p.data_ptr() == ptrs[n] for n, p in shared.named_parameters())
    assert isinstance(shared.blocks[0].attn1.to_q, tq.QuantLinear)
    assert type(shared.adaln_single.linear) is torch.nn.Linear
    w8 = rebuild(fmodel, tpx.PixArtConfig.tiny(quant="int8_w"))
    site = w8.blocks[1].ff.proj_in
    assert isinstance(site, tq.Int8Dense) and site.weight.dtype == torch.int8
    q, s = tq.quantize_weight(fmodel.blocks[1].ff.proj_in.weight)
    assert torch.equal(site.weight, q) and torch.equal(site.scale, s)
    assert site.bias.data_ptr() == ptrs["blocks.1.ff.proj_in.bias"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_model_fills_int8_sites(family):
    """init_model for int8_w fills the Int8Dense sites as the reference's
    random_serving_params does: int8 weights over [-127, 127], positive
    dequant scales near 0.02/127; the same seed gives the same model."""
    f = FAMILIES[family]
    init = tpx.init_model if family == "pixart" else tfx.init_model
    cfg = f.tcfg().__class__.tiny(quant="int8_w")
    a, b = init(cfg, 1, "cpu"), init(cfg, 1, "cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    sites = [m for m in a.modules() if isinstance(m, tq.Int8Dense)]
    per_block = 8 if family == "pixart" else 14  # FLUX's dual block, adaLN included
    assert len(sites) >= cfg.num_blocks * per_block
    w = torch.cat([m.weight.flatten() for m in sites]).float()
    s = torch.cat([m.scale for m in sites])
    assert w.min() == -127 and w.max() == 127 and abs(float(w.mean())) < 1.0
    assert bool((s > 0).all()) and abs(float(s.mean()) - 0.02 / 127 * 0.798) < 2e-5
    assert all(m.bias is None or bool((m.bias == 0).all()) for m in sites)


@pytest.mark.parametrize("quant", MODES)
def test_flux_fp8_caches_compose_with_every_mode(quant):
    """cache_dtype=float8_e4m3fn composes with each quant mode: the cached
    components are stored in fp8 and read back, the int8 products run, and
    the latents stay near the same mode's with compute-dtype caches."""
    steps = 3
    cfg = tfx.FluxConfig.tiny(dtype=torch.float32, quant=quant)
    model = tfx.init_model(cfg, 0, "cpu")
    _, sched = _flux_schedules(steps, cfg)
    rng = np.random.default_rng(3)
    data = _t((rng.standard_normal((1, 16, cfg.in_channels), dtype=np.float32),
               rng.standard_normal((1, cfg.text_len, cfg.joint_dim), dtype=np.float32),
               rng.standard_normal((1, cfg.pooled_dim), dtype=np.float32)))
    out = {}
    for cache_dtype in (None, torch.float8_e4m3fn):
        c = tfx.FluxConfig.tiny(dtype=torch.float32, quant=quant, cache_dtype=cache_dtype)
        pipe = tfp.FluxPipeline(tfp.FluxPipelineConfig(c, steps, height=64, width=64),
                                rebuild(model, c), sched)
        reset_launch_counts()
        out[cache_dtype] = pipe.denoise(*data)
        assert launch_counts()["int8_matmul"] > 0
    with torch.inference_mode():
        _, cache = model(*data[:3], torch.full((1,), 0.5), torch.full((1,), 5.0), {},
                         tfx.full_flux_mask(cfg), GRID)
        _, cache8 = rebuild(model, tfx.FluxConfig.tiny(
            dtype=torch.float32, quant=quant, cache_dtype=torch.float8_e4m3fn))(
            *data[:3], torch.full((1,), 0.5), torch.full((1,), 5.0), {},
            tfx.full_flux_mask(cfg), GRID)
    assert cache["single_attn_0"].dtype == torch.float32
    assert cache8["single_attn_0"].dtype == torch.float8_e4m3fn
    assert torch.isfinite(out[torch.float8_e4m3fn]).all()
    # the random tiny model's cached components are small beside the
    # flow's latents: e4m3 storage moves them by ≈ 5e-6 relative here
    assert _rel_err(out[torch.float8_e4m3fn], out[None]) < 1e-3
