"""chip_smoke.py's launch-count rules against a tiny FLUX trajectory on the
CPU: the modulated-norm launches that `flux_modlnorm_streams` assigns to
the image and text streams together (the pair), and to the image, text
and joint streams alone, are the calls made at those widths, and they sum
to the count `flux_expected_counts` holds the card's runs to. chip_smoke.py
gives K3's FLUX rows these per-stream launches."""

import importlib.util
import pathlib
from collections import Counter

import numpy as np
import torch

from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.pipelines import FluxPipeline, FluxPipelineConfig
from ecad_tpu_torch.schedules import FluxCacheSchedule

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flux_modlnorm_streams_split_the_norms_by_width(monkeypatch):
    """The tiny FLUX (2 dual + 3 single blocks, 8 text tokens) at 64² (16
    image tokens) under a seeded mask that caches about 40 % of the slots:
    every single modulated norm's x is counted by its token count, every
    pair by the token counts of its two segments."""
    cs = _chip_smoke()
    cfg = tfx.FluxConfig.tiny(dtype=torch.float32)
    steps = 4
    rng = np.random.default_rng(1)
    n_slots = (cfg.num_blocks + cfg.num_single_blocks) * 3
    recompute = rng.random(steps * n_slots) < 0.6
    # dual block 0 at step 1 recomputes full_ff_context with full_ff cached,
    # so that the text stream's norm also launches alone
    recompute.reshape(steps, n_slots)[1, 1:3] = (False, True)
    sched = FluxCacheSchedule.from_numpy(recompute, steps, cfg.num_blocks,
                                         num_single_blocks=cfg.num_single_blocks)
    pcfg = FluxPipelineConfig(cfg, steps, height=64, width=64)
    pipe = FluxPipeline(pcfg, tfx.init_model(cfg, 0, "cpu"), sched)
    widths = Counter()
    norm, pair = tfx.modulated_layer_norm, tfx.modulated_layer_norm_pair
    monkeypatch.setattr(tfx, "modulated_layer_norm",
                        lambda x, s, h: widths.update([x.shape[1]]) or norm(x, s, h))
    monkeypatch.setattr(tfx, "modulated_layer_norm_pair",
                        lambda a, b: widths.update([(a[0].shape[1], b[0].shape[1])])
                        or pair(a, b))
    inputs = (rng.standard_normal((1, pcfg.image_seq_len, cfg.in_channels)),
              rng.standard_normal((1, cfg.text_len, cfg.joint_dim)),
              rng.standard_normal((1, cfg.pooled_dim)))
    with torch.inference_mode():
        pipe.denoise(*(torch.from_numpy(a.astype(np.float32)) for a in inputs))
    streams = cs.flux_modlnorm_streams(pipe.masks, cfg.num_blocks)
    img, txt = pcfg.image_seq_len, cfg.text_len
    # the dual blocks' full_ff and full_ff_context are each recomputed alone
    # a different number of times, so a split that swapped them would show
    full = np.array(pipe.masks)[:, :cfg.num_blocks]
    ff, ffc = full[..., 1], full[..., 2]
    assert (ff & ~ffc).sum() != (ffc & ~ff).sum() and (ff & ffc).sum() > 0
    assert img != txt and min(streams.values()) > 0
    assert widths == Counter({(img, txt): streams["pair"], img: streams["img"],
                              txt: streams["txt"], img + txt: streams["joint"]})
    want = cs.flux_expected_counts(pipe.masks, cfg.num_blocks, "attention")["modlnorm"]
    assert sum(streams.values()) == want


def _counting(monkeypatch, cs, tally):
    """Counts each attention call under the counter of its route
    (`attention_counter`) and each modulated norm, as the card's wrappers
    count their launches."""
    from ecad_tpu_torch.models import common, pixart

    attn, norm = common.fused_attention, pixart.modulated_layer_norm

    def counted_attention(q, k, v, bias=None):
        tally.update([cs.attention_counter(q.shape, k.shape[1], bias)])
        return attn(q, k, v, bias)

    def counted_norm(x, scale, shift):
        tally.update(["modlnorm"])
        return norm(x, scale, shift)

    monkeypatch.setattr(common, "fused_attention", counted_attention)
    monkeypatch.setattr(pixart, "modulated_layer_norm", counted_norm)


def test_search_counts_sum_candidates_and_the_reference(monkeypatch, tmp_path):
    """A generation of the tiny PixArt evaluated with the fidelity scorer
    makes, over the whole run, the launches of every candidate's
    step-0-forced masks plus one uncached reference trajectory; with no
    text mask the cross-attention counts under the bias-free counter of its
    route, as `search_expected_counts` has it."""
    from ecad_tpu_torch.genetic.evaluate import CandidateEvaluator, EvalConfig
    from ecad_tpu_torch.genetic.population_io import PixArtPopulationIOManager
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model, schedule_mask_array
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    cs = _chip_smoke()
    cfg = PixArtConfig.tiny(dtype=torch.float32)
    steps, pop, prompts = 3, 4, 2
    mgr = PixArtPopulationIOManager(
        "count", tmp_path / "p", tmp_path / "b", population_size=pop,
        num_inference_steps=steps,
        default_schedule=PixArtCacheSchedule.default(steps, cfg.num_blocks))
    X = np.random.default_rng(2).random((pop, mgr.n_var)) < 0.5
    X[1, :6] = False  # a candidate that asks for cache reuse at step 0
    mgr.save_population(X)
    pipe = PixArtPipeline(PixArtPipelineConfig(cfg, steps), init_model(cfg, 0, "cpu"))
    gen = torch.Generator().manual_seed(0)
    text, neg = (torch.randn(prompts, cfg.text_len, cfg.caption_dim, generator=gen)
                 for _ in range(2))
    ev = CandidateEvaluator(pipe, text, neg, ["a", "b"],
                            EvalConfig(scorer="fidelity", return_images=False))
    tally = Counter()
    _counting(monkeypatch, cs, tally)
    ev.evaluate_generation(mgr, verbose=False)
    masks = [schedule_mask_array(s, cfg) for _, s in mgr.load_population_schedules()]
    reference = np.ones((steps, cfg.num_blocks, 3), dtype=bool)
    want = cs.search_expected_counts(masks + [reference], cfg, prompts)
    assert {k: n for k, n in want.items() if n} == dict(tally)
    assert want["attention"] > 0 and want["attention_bias"] == 0
    # the same run with one reference per candidate would count more
    assert cs.search_expected_counts(masks + [reference] * pop, cfg, prompts) != want


def test_search_cross_attention_route_without_a_text_mask():
    """At PixArt-α 256² (256 queries, 120 text keys, D=72) the search's
    cross-attention without a text mask takes the exact single-tile route
    under ``attention`` (K1); served with its key-padding bias it counts
    under ``attention_bias`` (K2), as ATTENTION_KERNELS[256] says."""
    from ecad_tpu_torch.models.pixart import PixArtConfig

    cs = _chip_smoke()
    c = PixArtConfig()
    shape = (8, c.tokens, c.num_heads, c.head_dim)
    assert cs.attention_counter(shape, c.text_len) == "attention"
    assert cs.attention_counter(shape, c.tokens) == "attention"
    bias = torch.zeros(8, 1, 1, c.text_len)
    assert cs.attention_counter(shape, c.text_len, bias) == cs.ATTENTION_KERNELS[256][1]
    counts = cs.search_expected_counts([np.ones((20, 28, 3), bool)], c, 4)
    served = cs.expected_counts([tuple(((True,) * 3,) * 28)] * 20)
    assert counts["attention"] == served["attention"] + served["attention_bias"] == 1120
    assert counts["attention_bias"] == 0 and counts["modlnorm"] == served["modlnorm"]
