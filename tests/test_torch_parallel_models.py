"""Tiny PixArt and FLUX evaluations under dp, tp and sp over spawned gloo
ranks on the CPU, against the port's one-process evaluation, the JAX
package's single-device one and, for one tp case and one sp case, the JAX
package's mesh evaluation on the 8-device CPU mesh.

The weights are the JAX package's tiny fp32 models (numpy-seeded inputs,
the JAX evaluator's noise batch), carried across by `models/bridge.py` and
saved for the ranks, which import no JAX. Each rank runs the cooperative
evaluator (`CandidateEvaluator(..., mesh=)`): the batch over dp, heads and
MLP width over tp (one all-reduce after each row-parallel product), the
tokens over sp (K and V all-gathered). Tolerances, fp32 throughout:

* latents against the port's one process, atol = rtol = 1e-5: the tp
  all-reduce adds the rank's partial sums in another order (≈ 1e-7
  relative a product), compounded over the steps;
* latents against the JAX package, atol = rtol = 1e-4, as
  tests/test_torch_search_eval.py holds the one-process port;
* fidelity scores as amplitudes 10^(−dB/20) within 1e-6 of the port's
  one-process run's (the latents' 1e-5 on outputs of size ~1 at errors
  of 1e-1 … 1e-3) and of the JAX package's;
* the int8 modes under tp bit for bit: the row-parallel product all-reduces
  its int32 sums and its token max-abs, integer sums in any order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ecad_tpu_torch.genetic import evaluate as tev
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models.common import rebuild
from ecad_tpu_torch.ops.quant import WEIGHT_MODES
from ecad_tpu_torch.parallel import mesh as tmesh
from ecad_tpu_torch.parallel.launch import spawn
from ecad_tpu_torch.pipelines import flux_pipeline as tfp
from ecad_tpu_torch.pipelines import pixart_pipeline as tpp
from ecad_tpu_torch.schedules import FluxCacheSchedule as TFlux
from ecad_tpu_torch.schedules import PixArtCacheSchedule as TPix

STEPS = 3
FLUX_SIDE = 64  # 4×4 packed image tokens beside 8 text tokens
P = 4  # prompts: two rows a dp rank
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
AMPLITUDE_TOL = 1e-6
# (family, dp, sp, tp, eval mode, quant) over 2 and over 4 ranks
RUNS_2 = [("pixart", 2, 1, 1, "dynamic", None), ("pixart", 1, 1, 2, "dynamic", None),
          ("pixart", 1, 2, 1, "dynamic", None), ("pixart", 1, 1, 2, "dynamic", "int8"),
          ("pixart", 1, 1, 2, "stepwise", "int8_w"),
          ("flux", 2, 1, 1, "dynamic", None), ("flux", 1, 1, 2, "dynamic", None),
          ("flux", 1, 1, 2, "stepwise", None), ("flux", 1, 2, 1, "dynamic", None),
          ("flux", 1, 2, 1, "stepwise", None)]
RUNS_4 = [("pixart", 2, 1, 2, "dynamic", None), ("pixart", 1, 2, 2, "stepwise", None),
          ("flux", 1, 2, 2, "dynamic", None), ("flux", 2, 1, 2, "stepwise", None)]


def _key(run):
    return "-".join(str(x) for x in run)


def _genome(family):
    slots = 2 if family == "pixart" else 5
    genome = np.random.default_rng(9).random(STEPS * slots * 3) < 0.5
    genome[: slots * 3] = True  # step 0 recomputes anyway
    return genome


def build(family, data, quant=None, mode="dynamic", mesh=None):
    """The port's tiny evaluator of `family` on the saved weights and
    inputs, for `mesh` (None: one process)."""
    cfg = dict(scorer="fidelity", mode=mode, return_images=False)
    if family == "pixart":
        c = tpx.PixArtConfig.tiny(dtype=torch.float32, quant=quant)
        stored = quant in WEIGHT_MODES  # quantized from the float weights by `rebuild`
        model = tpx.init_model(dataclasses.replace(c, quant=None) if stored else c,
                               device="cpu", state=data["pixart_state"], mesh=mesh)
        if stored:
            model = rebuild(model, c)
        pipe = tpp.PixArtPipeline(tpp.PixArtPipelineConfig(c, STEPS), model)
        return tev.CandidateEvaluator(pipe, data["text"], data["neg"], list("abcd"),
                                      tev.EvalConfig(**cfg), noise=data["pixart_noise"],
                                      mesh=mesh)
    c = tfx.FluxConfig.tiny(dtype=torch.float32, quant=quant)
    model = tfx.init_model(c, device="cpu", state=data["flux_state"], mesh=mesh)
    pipe = tfp.FluxPipeline(tfp.FluxPipelineConfig(c, STEPS, height=FLUX_SIDE, width=FLUX_SIDE),
                            model)
    return tev.FluxCandidateEvaluator(pipe, data["ftext"], data["pooled"], list("abcd"),
                                      tev.EvalConfig(**cfg), noise=data["flux_noise"], mesh=mesh)


def schedule(family, cls=None):
    g = _genome(family)
    if family == "pixart":
        return (cls or TPix).from_numpy(g, STEPS, 2, name="c")
    return (cls or TFlux).from_numpy(g, STEPS, 2, name="c", num_single_blocks=3,
                                     top_level_config={})


def evaluate(ev, family):
    """(scores, uncached latents, candidate latents) of one evaluator."""
    sched = schedule(family)
    scores, _ = ev.evaluate_candidate(sched)
    if ev.config.mode == "stepwise":
        masks = ev._schedule_masks(sched)
    elif family == "pixart":
        masks = tpx.schedule_mask_array(sched, ev.pipeline.config.model)
    else:
        masks = np.array(sched.mask, bool).reshape(STEPS, -1, 3)
        masks[0] = True  # step-0 cache-miss forcing, as evaluate_candidate does
    arrays = ev._noise_batch()[:3]
    cand = ev._sharded_denoise(ev._denoiser(), masks, list(arrays))
    return scores, ev._reference_latents(), cand


def _eval_rank(rank, world, runs, data_path, out):
    data = torch.load(data_path)
    results = {}
    for run in runs:
        family, dp, sp, tp, mode, quant = run
        mesh = tmesh.create_mesh(dp=dp, tp=tp, sp=sp)
        ev = build(family, data, quant, mode, mesh)
        scores, ref, cand = evaluate(ev, family)
        shapes = {}
        if family == "flux" and mode == "dynamic":
            # one forward's cache layout on this rank
            c = ev.pipeline.config
            x = ev.pipeline.model(data["flux_noise"][:2], data["ftext"][:2], data["pooled"][:2],
                                  torch.full((2,), 0.5), torch.full((2,), 5.0), {},
                                  tfx.full_flux_mask(c.model), c.grid_hw)[1]
            shapes = {k: list(x[k].shape) for k in ("single_proj_mlp_0", "single_attn_0",
                                                     "single_proj_out_0", "full_ff_0")}
            shapes["full_attn_0"] = [list(t.shape) for t in x["full_attn_0"]]
        results[_key(run)] = {"scores": scores, "ref": ref, "cand": cand, "shapes": shapes,
                              "calls": dict(mesh.calls)}
    if rank == 0:
        torch.save(results, out / "results.pt")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX tiny models' params bridged to the port, prompts, and the
    JAX evaluators' noise batches, plus the JAX single-device evaluators."""
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn

    from ecad_tpu.genetic import evaluate as jev
    from ecad_tpu.models import flux as jfx
    from ecad_tpu.models import pixart as jpx
    from ecad_tpu.pipelines import flux_pipeline as jfp
    from ecad_tpu.pipelines import pixart_pipeline as jpp
    from ecad_tpu_torch.models.bridge import flux_state_dict, pixart_state_dict

    rng = np.random.default_rng(31)
    text, neg = (rng.standard_normal((P, 8, 32), dtype=np.float32) for _ in range(2))
    ftext = rng.standard_normal((P, 8, 32), dtype=np.float32)
    pooled = rng.standard_normal((P, 24), dtype=np.float32)
    jpcfg = jpx.PixArtConfig.tiny(dtype=jnp.float32)
    pparams = jax.tree.map(np.asarray, fnn.meta.unbox(jpx.init_params(jpcfg, 0)[1]))
    jfcfg = jfx.FluxConfig.tiny(dtype=jnp.float32)
    fparams = jax.tree.map(np.asarray, fnn.meta.unbox(jfx.init_flux_params(jfcfg, 0)[1]))
    cfg = dict(scorer="fidelity", return_images=False)
    jpipe = jpp.PixArtPipeline(jpp.PixArtPipelineConfig(jpcfg, STEPS), pparams)
    jfpipe = jfp.FluxPipeline(jfp.FluxPipelineConfig(jfcfg, STEPS, height=FLUX_SIDE,
                                                     width=FLUX_SIDE), fparams)
    jpev = jev.CandidateEvaluator(jpipe, jnp.asarray(text), jnp.asarray(neg), list("abcd"),
                                  jev.EvalConfig(**cfg))
    jfev = jev.FluxCandidateEvaluator(jfpipe, jnp.asarray(ftext), jnp.asarray(pooled),
                                      list("abcd"), jev.EvalConfig(**cfg))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    d = {"pixart_state": pixart_state_dict(pparams), "flux_state": flux_state_dict(fparams),
         "text": t(text), "neg": t(neg), "ftext": t(ftext), "pooled": t(pooled),
         "pixart_noise": t(jpev._noise_batch()[0]), "flux_noise": t(jfev._noise_batch()[0])}
    path = tmp_path_factory.mktemp("models") / "data.pt"
    torch.save(d, path)
    d["path"] = path
    d["jax"] = {"pixart": (jpev, pparams), "flux": (jfev, fparams)}
    return d


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """Every run's results from the ranks (rank 0's; every rank holds the
    same scores and gathered latents)."""
    results = {}
    for world, runs in ((2, RUNS_2), (4, RUNS_4)):
        out = tmp_path_factory.mktemp(f"ranks{world}")
        spawn(_eval_rank, world, (runs, str(data["path"]), out), timeout_s=240, threads=1,
              init_dir=out)
        results.update(torch.load(out / "results.pt"))
    return results


@pytest.fixture(scope="module")
def one_process(data):
    """The port's one-process evaluation of each (family, mode, quant)."""
    cache = {}

    def get(family, mode, quant):
        key = (family, mode, quant)
        if key not in cache:
            cache[key] = evaluate(build(family, data, quant, mode), family)
        return cache[key]

    return get


def _amplitudes(scores):
    return np.array([10 ** (-np.asarray(v, np.float64) / 20)
                     for _, v in sorted(scores["score_by_prompt_id"].items())])


def _jax_scores(data, family, mesh=None):
    """The JAX package's evaluation of the same candidate (single device,
    or on `mesh` with the params sharded over it)."""
    from ecad_tpu.genetic import evaluate as jev
    from ecad_tpu.parallel import shard_params
    from ecad_tpu.schedules import FluxCacheSchedule as JFlux
    from ecad_tpu.schedules import PixArtCacheSchedule as JPix

    ev, params = data["jax"][family]
    sched = schedule(family, JPix if family == "pixart" else JFlux)
    if mesh is None:
        return ev.evaluate_candidate(sched)[0], ev._reference_latents()
    pipe = type(ev.pipeline)(ev.pipeline.config, shard_params(params, mesh))
    if family == "pixart":
        mev = jev.CandidateEvaluator(pipe, ev.text, ev.neg, ev.prompts, ev.config, mesh=mesh)
    else:
        mev = jev.FluxCandidateEvaluator(pipe, ev.text, ev.pooled, ev.prompts, ev.config,
                                         mesh=mesh)
    scores = mev.evaluate_candidate(sched)[0]
    with mesh:
        return scores, mev._reference_latents()


@pytest.mark.parametrize("run", RUNS_2 + RUNS_4, ids=[_key(r) for r in RUNS_2 + RUNS_4])
def test_mesh_evaluation_matches_one_process(ranks, one_process, run):
    family, dp, sp, tp, mode, quant = run
    got = ranks[_key(run)]
    scores, ref, cand = one_process(family, mode, quant)
    tol = dict(rtol=0, atol=0) if quant else PORT_TOL
    torch.testing.assert_close(got["ref"], ref, **tol)
    torch.testing.assert_close(got["cand"], cand, **tol)
    np.testing.assert_allclose(_amplitudes(got["scores"]), _amplitudes(scores), rtol=0,
                               atol=0 if quant else AMPLITUDE_TOL)
    calls = got["calls"]
    assert ("all_reduce_sum/tp" in calls) == (tp > 1)
    assert ("all_gather/sp" in calls) == (sp > 1)
    # the uncached reference, the candidate in evaluate_candidate and again
    assert calls.get("all_gather/dp", 0) == (3 if dp > 1 else 0)
    if quant == "int8":
        assert "all_reduce_max/tp" in calls  # the row-parallel token scales


@pytest.mark.parametrize("family", ["pixart", "flux"])
def test_mesh_evaluation_matches_reference_single_device(ranks, data, family):
    """Every mesh run of a family against the JAX package's single-device
    evaluation of the same candidate."""
    jscores, jref = _jax_scores(data, family)
    for run in RUNS_2 + RUNS_4:
        if run[0] != family or run[5] is not None:
            continue
        got = ranks[_key(run)]
        np.testing.assert_allclose(got["ref"].numpy(), np.asarray(jref), **JAX_TOL)
        np.testing.assert_allclose(_amplitudes(got["scores"]), _amplitudes(jscores), rtol=0,
                                   atol=AMPLITUDE_TOL)


@pytest.mark.parametrize("family,layout", [("pixart", (1, 1, 2)), ("flux", (1, 2, 1))],
                         ids=["pixart-tp2", "flux-sp2"])
def test_mesh_evaluation_matches_reference_mesh(ranks, data, family, layout):
    """One tp case and one sp case against the JAX package's evaluation on
    its own mesh (GSPMD on the 8-device CPU mesh)."""
    import jax

    from ecad_tpu.parallel import create_mesh as jcreate

    dp, sp, tp = layout
    mesh = jcreate(dp=dp, tp=tp, sp=sp, devices=jax.devices()[: dp * sp * tp])
    jscores, jref = _jax_scores(data, family, mesh)
    got = ranks[_key((family, dp, sp, tp, "dynamic", None))]
    np.testing.assert_allclose(got["ref"].numpy(), np.asarray(jref), **JAX_TOL)
    np.testing.assert_allclose(_amplitudes(got["scores"]), _amplitudes(jscores), rtol=0,
                               atol=AMPLITUDE_TOL)


def test_flux_caches_keep_the_reference_layout(ranks):
    """Under tp every cached component is the reduced, replicated tensor
    (``single_attn`` gathered to its whole width) but ``single_proj_mlp``,
    the rank's MLP slice, as the reference's `logical_constraint` keeps
    them; under sp every cache holds the rank's tokens."""
    c = tfx.FluxConfig.tiny()
    hidden, tokens = c.dim * c.mlp_ratio, c.text_len + (FLUX_SIDE // 16) ** 2
    tp = ranks[_key(("flux", 1, 1, 2, "dynamic", None))]["shapes"]
    assert tp["single_proj_mlp_0"] == [2, tokens, hidden // 2]
    assert tp["single_attn_0"] == tp["single_proj_out_0"] == [2, tokens, c.dim]
    assert tp["full_ff_0"] == [2, 16, c.dim] and tp["full_attn_0"] == [[2, 16, c.dim],
                                                                      [2, 8, c.dim]]
    sp = ranks[_key(("flux", 1, 2, 1, "dynamic", None))]["shapes"]
    assert sp["single_proj_mlp_0"] == [2, tokens // 2, hidden]
    assert sp["full_attn_0"] == [[2, 8, c.dim], [2, 4, c.dim]]
    both = ranks[_key(("flux", 1, 2, 2, "dynamic", None))]["shapes"]
    assert both["single_proj_mlp_0"] == [2, tokens // 2, hidden // 2]


def test_cooperative_evaluation_refuses_host_scorers_and_images(data):
    """The reference's ValueError (:206-215): a mesh over the processes
    scores on the device only (fidelity, no images)."""
    ev = build("pixart", data)
    ev.mesh = tmesh.Mesh(tmesh.rank_layout(2, 1, 1, 2), rank=0)
    for cfg in (dict(scorer="mock", return_images=False),
                dict(scorer="fidelity", return_images=True)):
        ev.config = tev.EvalConfig(**cfg)
        with pytest.raises(ValueError, match="cooperative evaluation"):
            ev.evaluate_candidate(schedule("pixart"))


def test_cooperative_chunk_that_dp_does_not_divide_raises(data):
    """A chunk of the (prompt × image) batch that dp does not divide is
    refused, as the reference's ``device_put`` onto the dp sharding refuses
    it: no rank quietly runs the whole chunk."""
    ev = build("pixart", data)
    ev.mesh = tmesh.Mesh(tmesh.rank_layout(2, 1, 1, 2), rank=0)
    ev.config = tev.EvalConfig(scorer="fidelity", return_images=False, batch_size=3)
    with pytest.raises(ValueError, match=r"dp=2 does not divide dim 0"):
        ev.evaluate_candidate(schedule("pixart"))
