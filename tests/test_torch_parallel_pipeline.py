"""Pipeline parallelism (`ecad_tpu_torch.parallel.pipeline`) over spawned
gloo ranks on the CPU: the counterparts of tests/test_pipeline_parallel.py.

A tiny fp32 PixArt with 4 blocks (the JAX package's weights, bridged) runs
its block stage as GPipe over pp=2 stages of 2 blocks: the forward at
(dp, pp, n_micro) ∈ {(1, 2, 2), (1, 2, 4), (2, 2, 2)} with the text-mask
bias, twice (the second step reusing cached components from the stages'
caches), against the plain model; the stage caches against the plain
cache's rows; `PipelinedPopulationDenoiser` and `TGATEPipelinedDenoiser`
against the plain pipelines and, once, against the JAX package's
PopulationDenoiser; the stage's cache and block range; the validation
errors and the quant refusal with the reference's words.

Tolerances (fp32): a stage runs the plain model's blocks on rows of the
batch, the same sums in the same order, so the pp=2 forward and the
trajectories equal the plain ones bit for bit where the microbatch keeps
the GEMMs' shapes' results (checked at atol = rtol = 1e-6, a few ulps:
CPU GEMMs of another M may block their sums otherwise); against the JAX
package 1e-4, as the port's one-process tests hold it."""

import json

import numpy as np
import pytest
import torch

from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.parallel import mesh as tmesh
from ecad_tpu_torch.parallel import pipeline as tpipe
from ecad_tpu_torch.parallel.launch import spawn
from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
from ecad_tpu_torch.pipelines.pixart_pipeline import PopulationDenoiser
from ecad_tpu_torch.pipelines.tgate import TGATEPixArtPipeline

STEPS = 4
NB = 4
B = 4
TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
LAYOUTS = [(1, 2, 2), (1, 2, 4), (2, 2, 2)]  # (dp, pp, n_micro)


def config():
    return tpx.PixArtConfig.tiny(dtype=torch.float32, num_blocks=NB)


def inputs():
    rng = np.random.default_rng(41)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))  # noqa: E731
    latents, text, neg = t(B, 8, 8, 4), t(B, 8, 32), t(B, 8, 32)
    text_mask = torch.ones(B, 8)
    text_mask[:, 5:] = 0
    text_mask[1, 2:] = 0
    masks = np.random.default_rng(3).random((STEPS, NB, 3)) < 0.5
    masks[0] = True
    return latents, text, neg, text_mask, masks


def step_masks():
    """A forward's two masks: all recomputed, then a partial reuse."""
    second = np.ones((NB, 3), bool)
    second[0, 0] = second[1, 2] = second[2, 1] = second[3, 0] = False
    return np.ones((NB, 3), bool), second


def _pp_rank(rank, world, layouts, state_path, out):
    state = torch.load(state_path)
    latents, text, neg, text_mask, masks = inputs()
    rows = {}
    for dp, pp, n_micro in layouts:
        if dp * pp != world:
            continue
        mesh = tpipe.create_pp_mesh(pp, dp)
        c = config()
        model = tpx.init_model(c, device="cpu", state=state)
        fwd = tpipe.build_pp_forward(model, mesh, n_micro)
        lat, txt, tm = (tmesh.batch_sharding(mesh, a) for a in (latents, text, text_mask))
        cache = tpx.init_cache(c, lat.shape[0], device="cpu", blocks=len(model.blocks))
        t = torch.full((lat.shape[0],), 500.0)
        outs = []
        with torch.inference_mode():
            for mask in step_masks():
                o, cache = fwd(lat, txt, t, cache, mask, text_mask=tm)
                outs.append(o)
        pipe = PixArtPipeline(PixArtPipelineConfig(c, STEPS),
                              tpx.init_model(c, device="cpu", state=state))
        den = tpipe.PipelinedPopulationDenoiser(pipe, mesh, n_micro).denoise(
            masks, latents, text, neg, text_mask, text_mask)
        tg = TGATEPixArtPipeline(PixArtPipelineConfig(c, STEPS),
                                 tpx.init_model(c, device="cpu", state=state), gate_step=2)
        tgate = tpipe.TGATEPipelinedDenoiser(tg, mesh, n_micro).denoise(
            latents, text, neg, text_mask, text_mask)
        rows[f"{dp},{pp},{n_micro}"] = {
            "stage": [model.stage.start, model.stage.stop], "dp": mesh.coord("dp"),
            "outs": [o.tolist() for o in outs],
            "cache": {k: torch.stack(v).tolist() for k, v in cache.items()},
            "denoise": den.tolist(), "tgate": tgate.tolist(),
            "blocks": len(model.blocks), "calls": dict(mesh.calls),
        }
    (out / f"rank{rank}.json").write_text(json.dumps(rows))


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    import jax
    from flax import linen as fnn

    from ecad_tpu.models import pixart as jpx
    from ecad_tpu_torch.models.bridge import pixart_state_dict

    jcfg = jpx.PixArtConfig.tiny(dtype=jax.numpy.float32, num_blocks=NB)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jpx.init_params(jcfg, 0)[1]))
    path = tmp_path_factory.mktemp("pp") / "state.pt"
    torch.save(pixart_state_dict(params), path)
    return {"path": path, "params": params, "jcfg": jcfg}


@pytest.fixture(scope="module")
def ranks(state, tmp_path_factory):
    results = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"pp{world}")
        spawn(_pp_rank, world, (LAYOUTS, str(state["path"]), out), timeout_s=180, threads=1,
              init_dir=out)
        for r in range(world):
            for key, row in json.loads((out / f"rank{r}.json").read_text()).items():
                results.setdefault(key, []).append(row)
    return results


@pytest.fixture(scope="module")
def plain(state):
    """The plain model's two forwards (outputs and final cache) on the whole
    batch, and the plain trajectories."""
    c = config()
    st = torch.load(state["path"])
    model = tpx.init_model(c, device="cpu", state=st)
    latents, text, neg, text_mask, masks = inputs()
    cache = tpx.init_cache(c, B, device="cpu")
    t = torch.full((B,), 500.0)
    outs = []
    with torch.inference_mode():
        for mask in step_masks():
            o, cache = model(latents, text, t, cache, tuple(map(tuple, mask.tolist())),
                             text_mask=text_mask)
            outs.append(o)
    pipe = PixArtPipeline(PixArtPipelineConfig(c, STEPS), model)
    den = PopulationDenoiser(pipe).denoise(masks, latents, text, neg, text_mask, text_mask)
    tg = TGATEPixArtPipeline(PixArtPipelineConfig(c, STEPS), model, gate_step=2)
    return {"outs": outs, "cache": {k: torch.stack(v) for k, v in cache.items()}, "denoise": den,
            "tgate": tg.denoise(latents, text, neg, text_mask, text_mask)}


@pytest.mark.parametrize("dp,pp,n_micro", LAYOUTS, ids=[f"dp{a}-pp{b}-m{c}" for a, b, c in LAYOUTS])
def test_pp_forward_and_cache_reuse_match_plain(ranks, plain, dp, pp, n_micro):
    """Two forwards (all recomputed, then cached components read from the
    stages' caches), with the text-mask bias: every rank's output equals the
    plain model's on its dp rows, and each stage's cache the plain cache's
    rows of its blocks; a stage holds only its blocks."""
    rows = ranks[f"{dp},{pp},{n_micro}"]
    assert sorted(r["stage"][0] for r in rows) == sorted([0, 2] * dp)
    for r in rows:
        assert r["blocks"] == NB // pp
        sl = slice(r["dp"] * B // dp, (r["dp"] + 1) * B // dp)
        for got, want in zip(r["outs"], plain["outs"]):
            np.testing.assert_allclose(np.array(got), want[sl].numpy(), **TOL)
        lo, hi = r["stage"]
        for k, v in r["cache"].items():
            np.testing.assert_allclose(np.array(v), plain["cache"][k][lo:hi, sl].numpy(), **TOL)
        # stage 0 hands on each microbatch of each forward; the last stage
        # broadcasts its outputs
        sends = r["calls"].get("send/pp", 0)
        assert sends == (0 if lo else 2 * n_micro + STEPS * n_micro + 4 * n_micro)


@pytest.mark.parametrize("dp,pp,n_micro", LAYOUTS, ids=[f"dp{a}-pp{b}-m{c}" for a, b, c in LAYOUTS])
def test_pipelined_denoisers_match_plain(ranks, plain, dp, pp, n_micro):
    """`PipelinedPopulationDenoiser` (a random mask array) and
    `TGATEPipelinedDenoiser` (gate at step 2: the CFG batch, then the
    negative one through the stages) equal the plain pipelines on every
    rank, the latents gathered over dp."""
    for r in ranks[f"{dp},{pp},{n_micro}"]:
        np.testing.assert_allclose(np.array(r["denoise"]), plain["denoise"].numpy(), **TOL)
        np.testing.assert_allclose(np.array(r["tgate"]), plain["tgate"].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_pipelined_denoiser_matches_reference(ranks, state):
    """The pp=2 trajectory against the JAX package's single-device
    PopulationDenoiser on the same weights and inputs."""
    from ecad_tpu.pipelines import pixart_pipeline as jpp

    latents, text, neg, text_mask, masks = inputs()
    jpipe = jpp.PixArtPipeline(jpp.PixArtPipelineConfig(state["jcfg"], STEPS), state["params"])
    want = jpp.PopulationDenoiser(jpipe).denoise(masks, latents.numpy(), text.numpy(),
                                                 neg.numpy(), text_mask.numpy(),
                                                 text_mask.numpy())
    np.testing.assert_allclose(np.array(ranks["1,2,2"][0]["denoise"]), np.asarray(want),
                               **JAX_TOL)


def test_build_pp_forward_stages_once_and_serves_the_pipeline_loop():
    """`build_pp_forward` keeps the stage's blocks and makes the pp
    schedule the model's forward, once; the pipelines' per-block cache is
    then the stage's (`init_cache` with its block count); a DiT plan is
    refused."""
    c = config()
    mesh = tmesh.Mesh(np.arange(2).reshape(1, 2), rank=1, names=("dp", "pp"))
    assert tpipe.stage_range(NB, mesh) == range(NB // 2, NB)
    model = tpx.init_model(c, device="cpu", seed=3)
    one = tpipe.create_pp_mesh(1)
    assert tpipe.build_pp_forward(model, one, 2) is model
    blocks = list(model.blocks)
    assert tpipe.build_pp_forward(model, one, 4) is model  # already staged: nothing changes
    assert isinstance(model, tpipe.PixArtStage) and model.n_micro == 2
    assert list(model.blocks) == blocks and model.stage == range(NB)
    cache = tpx.init_cache(c, 3, device="cpu", blocks=NB // 2)
    assert set(cache) == set(tpx.COMPONENTS)
    assert len(cache["ff"]) == NB // 2 and cache["ff"][0].shape == (3, c.tokens, c.dim)
    latents, text, *_ = inputs()
    with pytest.raises(NotImplementedError, match="no DiT plan"):
        model(latents, text, torch.full((B,), 1.0), tpx.init_cache(c, B, device="cpu"),
              np.ones((NB, 3), bool), plan=(0, 1))


def test_pp_validation_errors():
    """The reference's errors: a rank count that is not dp·pp, blocks that
    do not divide by pp, a batch that does not divide by n_micro, a TGATE
    batch that does not split into dp-divisible microbatches."""
    with pytest.raises(ValueError, match=r"dp\*pp=4 != 1 ranks"):
        tpipe.create_pp_mesh(2, dp=2)
    pp3 = tmesh.Mesh(np.arange(3).reshape(1, 3), rank=0, names=("dp", "pp"))
    with pytest.raises(ValueError, match="not divisible by pp"):
        tpipe.build_pp_forward(tpx.init_model(config(), device="cpu"), pp3, 2)
    one = tpipe.create_pp_mesh(1)
    model = tpx.init_model(config(), device="cpu")
    fwd = tpipe.build_pp_forward(model, one, 3)
    latents, text, *_ = inputs()
    cache = tpx.init_cache(config(), B, device="cpu")
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        fwd(latents, text, torch.full((B,), 1.0), cache, np.ones((NB, 3), bool))
    tg = TGATEPixArtPipeline(PixArtPipelineConfig(config(), STEPS),
                             tpx.init_model(config(), device="cpu"), gate_step=2)
    with pytest.raises(ValueError, match="TGATE pp phase 2 batch"):
        tpipe.TGATEPipelinedDenoiser(tg, one, 3).denoise(latents, text, text)


def test_pp_refuses_quant():
    model = tpx.init_model(tpx.PixArtConfig.tiny(dtype=torch.float32, quant="int8"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="quant=None only"):
        tpipe.build_pp_forward(model, tpipe.create_pp_mesh(1), 2)


def test_pp_of_one_stage_is_the_plain_model():
    """pp=1: the stage is every block, no point-to-point call, and the
    forward equals the plain model's."""
    c = config()
    model = tpx.init_model(c, device="cpu", seed=3)
    plain_model = tpx.init_model(c, device="cpu", seed=3)
    mesh = tpipe.create_pp_mesh(1)
    fwd = tpipe.build_pp_forward(model, mesh, 2)
    latents, text, _, text_mask, _ = inputs()
    t = torch.full((B,), 300.0)
    with torch.inference_mode():
        got, _ = fwd(latents, text, t, tpx.init_cache(c, B, device="cpu"),
                     np.ones((NB, 3), bool), text_mask=text_mask)
        want, _ = plain_model(latents, text, t, tpx.init_cache(c, B, device="cpu"),
                              tpx.full_step_mask(c), text_mask=text_mask)
    torch.testing.assert_close(got, want, **TOL)
    assert model.stage == range(NB) and not mesh.calls
