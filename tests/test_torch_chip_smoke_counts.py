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
