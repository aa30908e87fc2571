"""The search loop's device layer in the port against the JAX package's, on
the CPU: the population denoisers and shared steppers, the scan-form DPM
update, `fidelity_snr_db` and the candidate evaluators (PixArt and FLUX),
on the tiny fp32 models with the Flax params carried across by
`models/bridge.py` and numpy-seeded inputs. The port's evaluators are fed
the JAX evaluators' noise batches (jax.random and torch.Generator give
different numbers from one seed)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.genetic import evaluate as jev
from ecad_tpu.genetic import population_io as jpio
from ecad_tpu.models import flux as jfx
from ecad_tpu.models import pixart as jpx
from ecad_tpu.pipelines import flux_pipeline as jfp
from ecad_tpu.pipelines import pixart_pipeline as jpp
from ecad_tpu.pipelines import samplers as jsamp
from ecad_tpu.schedules import FluxCacheSchedule as JFlux
from ecad_tpu.schedules import PixArtCacheSchedule as JPix
from ecad_tpu_torch.genetic import evaluate as tev
from ecad_tpu_torch.genetic import population_io as tpio
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models.bridge import flux_state_dict, pixart_state_dict
from ecad_tpu_torch.pipelines import flux_pipeline as tfp
from ecad_tpu_torch.pipelines import pixart_pipeline as tpp
from ecad_tpu_torch.pipelines import samplers as tsamp
from ecad_tpu_torch.schedules import FluxCacheSchedule as TFlux
from ecad_tpu_torch.schedules import PixArtCacheSchedule as TPix

STEPS = 4
# fp32 on both sides, sums in other orders: final latents agree within
# rtol = atol = 1e-4, as the port's pipeline tests hold them
LATENT_TOL = dict(rtol=1e-4, atol=1e-4)
# fidelity of a candidate: its SNR in dB against its own framework's
# uncached trajectory. The two frameworks' latents differ by ~1e-8 of
# their size (sums in other orders), which moves a candidate's error
# amplitude relative to the reference's RMS, 10^(−dB/20), by about as much:
# the two amplitudes must agree within 1e-7 (a few fp32 ulps). That is
# 3e-5 dB at 30 dB but 0.5 dB at 115 dB, where the caching error itself is
# only 2e-6 of the latents.
AMPLITUDE_TOL = 1e-7


def _assert_fidelity_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(10 ** (-got / 20), 10 ** (-want / 20), rtol=0,
                               atol=AMPLITUDE_TOL)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def pixart():
    jcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32)
    _, params = jpx.init_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tpx.PixArtConfig.tiny(dtype=torch.float32)
    model = tpx.PixArtTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(pixart_state_dict(params), strict=True)
    jpipe = jpp.PixArtPipeline(jpp.PixArtPipelineConfig(jcfg, STEPS), params)
    tpipe = tpp.PixArtPipeline(tpp.PixArtPipelineConfig(tcfg, STEPS), model)
    rng = np.random.default_rng(21)
    text, neg = (rng.standard_normal((2, 8, 32), dtype=np.float32) for _ in range(2))
    return jcfg, tcfg, jpipe, tpipe, text, neg


def _pix_genomes(num_blocks):
    """The all-recompute default, a light cache (one FF reuse), a seeded
    random genome and cache-everything (step 0 forced)."""
    full = np.ones((STEPS, num_blocks, 3), bool)
    light = full.copy()
    light[2, 0, 2] = False
    rnd = np.random.default_rng(8).random((STEPS, num_blocks, 3)) < 0.5
    return {"default": full, "light": light, "random": rnd,
            "heavy": np.zeros((STEPS, num_blocks, 3), bool)}


def _pix_schedules(genome):
    g = genome.reshape(-1)
    nb = genome.shape[1]
    return (JPix.from_numpy(g, STEPS, nb, name="c"), TPix.from_numpy(g, STEPS, nb, name="c"))


@pytest.mark.parametrize("kind", ["light", "random"])
def test_population_denoiser_matches_stepper_and_reference(pixart, kind):
    """The port's PopulationDenoiser (mask array) equals its
    SharedModelStepper (step-mask tuples) exactly, and JAX's
    PopulationDenoiser within LATENT_TOL."""
    jcfg, tcfg, jpipe, tpipe, text, neg = pixart
    jsched, tsched = _pix_schedules(_pix_genomes(2)[kind])
    arr = tpx.schedule_mask_array(tsched, tcfg)
    np.testing.assert_array_equal(arr, jpx.schedule_mask_array(jsched, jcfg))
    noise = np.random.default_rng(4).standard_normal((2, 8, 8, 4), dtype=np.float32)
    got = tpp.PopulationDenoiser(tpipe).denoise(arr, _t(noise), _t(text), _t(neg))
    stepped = tpp.SharedModelStepper(tpipe).denoise(
        tpx.schedule_step_masks(tsched, tcfg), _t(noise), _t(text), _t(neg))
    torch.testing.assert_close(got, stepped, rtol=0, atol=0)
    want = jpp.PopulationDenoiser(jpipe).denoise(arr, noise, text, neg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LATENT_TOL)
    with pytest.raises(ValueError, match="steps, blocks, 3"):
        tpp.PopulationDenoiser(tpipe).denoise(arr[1:], _t(noise), _t(text), _t(neg))


def test_cfg_dpm_step_matches_reference_and_dpm_step():
    """The scan-form update equals the reference's on the same arrays, and
    the port's own `dpm_step` bit for bit at every step."""
    rng = np.random.default_rng(0)
    sched_t, sched_j = tsamp.make_dpm_schedule(20), jsamp.make_dpm_schedule(20)
    co_t, co_j = tsamp.dpm_scan_coeffs(sched_t), jsamp.dpm_scan_coeffs(sched_j)
    np.testing.assert_array_equal(co_t, co_j)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    prev = np.zeros_like(x)
    state = tsamp.DPMState(_t(x), torch.zeros_like(_t(x)), False)
    for i in range(20):
        eps2 = rng.standard_normal((4, 8, 8, 8), dtype=np.float32)
        new_x, x0 = tpp.cfg_dpm_step(_t(x), _t(prev), co_t[i], _t(eps2), 4.5, 4)
        want_x, want_x0 = jpp.cfg_dpm_step(
            jnp.asarray(x), jnp.asarray(prev), jnp.asarray(co_j[i], jnp.float32),
            jnp.asarray(eps2), 4.5, 4)
        np.testing.assert_allclose(new_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x0.numpy(), np.asarray(want_x0), rtol=1e-6, atol=1e-6)
        neg, pos = _t(eps2[..., :4]).chunk(2)
        state = tsamp.dpm_step(sched_t, i, neg + 4.5 * (pos - neg), state)
        torch.testing.assert_close(new_x, state.x, rtol=0, atol=0)
        x, prev = new_x.numpy(), x0.numpy()


def test_fidelity_snr_db_matches_reference():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((5, 8, 8, 4), dtype=np.float32)
    lat = ref + np.array([0, 1e-4, 1e-2, 1.0, 10.0], np.float32)[:, None, None, None] * (
        rng.standard_normal(ref.shape, dtype=np.float32))
    got = tev.fidelity_snr_db(_t(lat), _t(ref)).numpy()
    want = np.asarray(jev.fidelity_snr_db(jnp.asarray(lat), jnp.asarray(ref)))
    assert got[0] == want[0] == 200.0  # exact match: mse 0, capped
    # fp32 on both sides: a few ulps of the dB value, 1e-5 dB near 0 dB
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # bf16 latents are compared in fp32, as the reference does
    got16 = tev.fidelity_snr_db(_t(lat).bfloat16(), _t(ref).bfloat16()).numpy()
    want16 = np.asarray(jev.fidelity_snr_db(jnp.asarray(lat, jnp.bfloat16),
                                            jnp.asarray(ref, jnp.bfloat16)))
    np.testing.assert_allclose(got16, want16, rtol=1e-5)


def _pix_evaluators(pixart, mode="dynamic", images_per_prompt=1):
    jcfg, tcfg, jpipe, tpipe, text, neg = pixart
    cfg = dict(scorer="fidelity", mode=mode, images_per_prompt=images_per_prompt,
               start_seed=3, seed_step=2)
    jevl = jev.CandidateEvaluator(jpipe, jnp.asarray(text), jnp.asarray(neg), ["a", "b"],
                                  jev.EvalConfig(**cfg))
    noise = np.asarray(jevl._noise_batch()[0])
    tevl = tev.CandidateEvaluator(tpipe, _t(text), _t(neg), ["a", "b"],
                                  tev.EvalConfig(**cfg), noise=_t(noise))
    return jevl, tevl


@pytest.mark.parametrize("mode,images", [("dynamic", 1), ("stepwise", 1), ("dynamic", 2)])
def test_pixart_evaluator_fidelity_matches_reference(pixart, mode, images):
    """Fed the JAX evaluator's noise batch, the port's evaluator scores
    every candidate within AMPLITUDE_TOL of the JAX evaluator's, and the
    default candidate at exactly 200 dB; cache-everything scores lowest."""
    jevl, tevl = _pix_evaluators(pixart, mode, images)
    scores = {}
    for kind, genome in _pix_genomes(2).items():
        jsched, tsched = _pix_schedules(genome)
        (js, jimg), (ts, timg) = jevl.evaluate_candidate(jsched), tevl.evaluate_candidate(tsched)
        assert set(ts) == {"total_score", "avg_by_prompt", "score_by_prompt_id"}
        assert ts["score_by_prompt_id"].keys() == js["score_by_prompt_id"].keys()
        for pid, vals in js["score_by_prompt_id"].items():
            _assert_fidelity_close(ts["score_by_prompt_id"][pid], vals)
        assert timg.shape == jimg.shape == (2 * images, 8, 8, 3) and timg.dtype == np.uint8
        scores[kind] = ts["total_score"]
    assert scores["default"] == 200.0
    assert scores["heavy"] < min(scores["light"], scores["random"]) < 200.0
    # the uncached reference trajectory is computed once and kept
    ref = tevl._ref_latents
    tevl.evaluate_candidate(_pix_schedules(_pix_genomes(2)["light"])[1])
    assert tevl._ref_latents is ref


def test_evaluator_modes_agree_and_noise_is_checked(pixart):
    """Both eval modes run the same loop: equal scores. Without a given
    noise batch the evaluator draws one per seed from a torch.Generator,
    reproducibly; a given batch of the wrong shape is refused."""
    _, tevl = _pix_evaluators(pixart, "dynamic")
    _, tevl2 = _pix_evaluators(pixart, "stepwise")
    sched = _pix_schedules(_pix_genomes(2)["random"])[1]
    assert tevl.evaluate_candidate(sched)[0] == tevl2.evaluate_candidate(sched)[0]
    _, tcfg, _, tpipe, text, neg = pixart
    drawn = [tev.CandidateEvaluator(tpipe, _t(text), _t(neg), ["a", "b"],
                                    tev.EvalConfig(images_per_prompt=2))._noise_batch()
             for _ in range(2)]
    torch.testing.assert_close(drawn[0][0], drawn[1][0], rtol=0, atol=0)
    assert drawn[0][0].shape == (4, 8, 8, 4) and drawn[0][3] == ["a", "b", "a", "b"]
    bad = tev.CandidateEvaluator(tpipe, _t(text), _t(neg), ["a", "b"],
                                 noise=torch.zeros(3, 8, 8, 4))
    with pytest.raises(ValueError, match="noise"):
        bad.evaluate_candidate(sched)


def test_evaluate_generation_resumes_partial_scores(tmp_path, pixart):
    """Interrupted offline eval: an existing scores.json is kept and only
    the missing candidates are evaluated (mirrors the JAX test in
    tests/test_genetic.py); every candidate gets its MACs."""
    _, tcfg, _, tpipe, text, neg = pixart
    mgr = tpio.PixArtPopulationIOManager(
        "resume", all_populations_dir=tmp_path / "p", all_benchmarks_dir=tmp_path / "b",
        population_size=3, num_inference_steps=STEPS,
        default_schedule=TPix.default(num_inference_steps=STEPS, num_blocks=2),
    )
    mgr.save_population(np.random.default_rng(0).random((3, mgr.n_var)) < 0.5)
    d = mgr.score_dir() / "cand_001"
    d.mkdir(parents=True)
    (d / "scores.json").write_text(json.dumps(
        {"total_score": 123.0, "avg_by_prompt": {}, "score_by_prompt_id": {}}))
    ev = tev.CandidateEvaluator(tpipe, _t(text), _t(neg), ["a", "b"], tev.EvalConfig())
    results = ev.evaluate_generation(mgr, verbose=False)
    assert set(results) == {0, 2}
    assert json.loads((d / "scores.json").read_text())["total_score"] == 123.0
    assert mgr.check_offline_eval()
    # the same manager files from the JAX side read the same objectives
    jmgr = jpio.PixArtPopulationIOManager.from_json(mgr.save_config())
    for a, b in zip(jmgr.ask(), mgr.ask()):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# FLUX
# ---------------------------------------------------------------------------

FLUX_SIDE = 64  # 4×4 packed tokens


@pytest.fixture(scope="module")
def flux():
    jcfg = jfx.FluxConfig.tiny(dtype=jnp.float32)
    _, params = jfx.init_flux_params(jcfg, 0)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    tcfg = tfx.FluxConfig.tiny(dtype=torch.float32)
    model = tfx.FluxTransformer(tcfg).eval().requires_grad_(False)
    model.load_state_dict(flux_state_dict(params), strict=True)
    kw = dict(num_inference_steps=STEPS, height=FLUX_SIDE, width=FLUX_SIDE)
    jpipe = jfp.FluxPipeline(jfp.FluxPipelineConfig(jcfg, **kw), params)
    tpipe = tfp.FluxPipeline(tfp.FluxPipelineConfig(tcfg, **kw), model)
    rng = np.random.default_rng(22)
    text = rng.standard_normal((2, jcfg.text_len, jcfg.joint_dim), dtype=np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim), dtype=np.float32)
    return jcfg, tcfg, jpipe, tpipe, text, pooled


def _flux_schedules(jcfg, kind):
    n = STEPS * (jcfg.num_blocks + jcfg.num_single_blocks) * 3
    genome = {"default": np.ones(n, bool), "cached": np.zeros(n, bool),
              "random": np.random.default_rng(9).random(n) < 0.5}[kind]
    return tuple(S.from_numpy(genome, STEPS, jcfg.num_blocks, name=kind,
                              num_single_blocks=jcfg.num_single_blocks, top_level_config={})
                 for S in (JFlux, TFlux))


def test_flux_population_denoiser_matches_stepper_and_reference(flux):
    jcfg, tcfg, jpipe, tpipe, text, pooled = flux
    _, tsched = _flux_schedules(jcfg, "random")
    arr = np.array(tsched.mask, bool).reshape(STEPS, -1, 3).copy()
    arr[0] = True
    noise = np.random.default_rng(5).standard_normal(
        (2, (FLUX_SIDE // 16) ** 2, tcfg.in_channels), dtype=np.float32)
    got = tfp.FluxPopulationDenoiser(tpipe).denoise(arr, _t(noise), _t(text), _t(pooled))
    stepped = tfp.SharedFluxStepper(tpipe).denoise(
        tfx.flux_step_masks(tsched, tcfg), _t(noise), _t(text), _t(pooled))
    torch.testing.assert_close(got, stepped, rtol=0, atol=0)
    want = jfp.FluxPopulationDenoiser(jpipe).denoise(arr, noise, text, pooled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LATENT_TOL)
    with pytest.raises(ValueError, match="steps, slots, 3"):
        tfp.FluxPopulationDenoiser(tpipe).denoise(arr[:, 1:], _t(noise), _t(text), _t(pooled))


@pytest.mark.parametrize("mode", ["dynamic", "stepwise"])
def test_flux_evaluator_fidelity_matches_reference(flux, mode):
    """Mirrors tests/test_fidelity.py's FLUX case: the all-recompute
    candidate scores exactly 200 dB, caching scores lower, and every score
    is within AMPLITUDE_TOL of the JAX evaluator's on its noise batch."""
    jcfg, tcfg, jpipe, tpipe, text, pooled = flux
    cfg = dict(scorer="fidelity", mode=mode)
    jevl = jev.FluxCandidateEvaluator(jpipe, jnp.asarray(text), jnp.asarray(pooled),
                                      ["a", "b"], jev.EvalConfig(**cfg))
    noise = np.asarray(jevl._noise_batch()[0])
    tevl = tev.FluxCandidateEvaluator(tpipe, _t(text), _t(pooled), ["a", "b"],
                                      tev.EvalConfig(**cfg), noise=_t(noise))
    scores = {}
    for kind in ("default", "random", "cached"):
        jsched, tsched = _flux_schedules(jcfg, kind)
        (js, jimg), (ts, timg) = jevl.evaluate_candidate(jsched), tevl.evaluate_candidate(tsched)
        for pid, vals in js["score_by_prompt_id"].items():
            _assert_fidelity_close(ts["score_by_prompt_id"][pid], vals)
        # images are the latent visualisation of the unpacked (B, 8, 8, 16) latents
        assert timg.shape == jimg.shape == (2, FLUX_SIDE // 8, FLUX_SIDE // 8, 3)
        scores[kind] = ts["total_score"]
    assert scores["default"] == 200.0
    assert scores["cached"] < scores["default"]
