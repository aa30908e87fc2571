"""Analytic MACs/FLOPs accounting for cache schedules (the port's own copy
of ``ecad_tpu/macs.py``; the same numbers bit for bit).

The reference computes MACs by running calflops (torch module hooks) over the
edited transformer once per inference step, exploiting that cached components
never execute (ecad/benchmark/compute_macs.py:255-303). calflops counts only
Linear/Conv modules as MACs — scaled-dot-product-attention matmuls are NOT
counted. That makes the measurement an exact linear function of the
recompute mask, which we evaluate analytically — instant, no profiler, no
device — with per-component cost tables derived from the model shapes and
verified to reproduce every `metrics.by_inference_step` value committed in
the reference's schedule JSONs bit-for-bit (see tests/test_macs.py).

Semantics mirrored from the reference:

* **Step-0 cache-miss forcing** — on the first step every component executes
  regardless of the mask, because the block cache is empty and the cached
  strategy recomputes on a miss (cached_transformer_block.py:344-352).
* **TGATE half batch** — the TGATE pipeline drops CFG at the gate step, so
  from `gate_step` onward all costs are counted at batch 1 instead of 2
  (compute_macs.py:306-364, tgate.py:328-341).
* FLOPs = 2·MACs for every maskable component; the per-step constant differs
  (norm/activation FLOPs that have no MACs), so both constants are carried.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .schedules.cache_schedule import CacheSchedule
from .schedules.flux import FluxCacheSchedule
from .schedules.pixart import PixArtCacheSchedule

TERA = 1e12


@dataclass(frozen=True)
class CostTable:
    """Per-step cost model: a constant plus one cost per schedule slot.

    Costs are for the full batch (CFG batch 2 unless noted); `per_sample_*`
    retain the batch-1 values for the TGATE half-batch rule.
    """

    batch: int
    const_macs_per_sample: int
    # extra FLOPs (beyond 2×macs) in the per-step constant, per sample
    const_extra_flops_per_sample: int
    comp_macs_per_sample: Mapping[str, int]  # component name → macs (batch 1)
    # extra FLOPs beyond 2×macs per component (GELU elementwise ops inside
    # FeedForward modules; attention components carry none — softmax/SDPA is
    # not counted by calflops)
    comp_extra_flops_per_sample: Mapping[str, int] = None  # type: ignore[assignment]
    # batch-independent per-step FLOPs (e.g. size-condition projection ops in
    # the 1024 PixArt checkpoint; identified from TGATE half-batch data)
    const_fixed_flops: int = 0

    def slot_extra_flops(self, schedule: CacheSchedule, batch: int | None = None) -> np.ndarray:
        b = self.batch if batch is None else batch
        extra = self.comp_extra_flops_per_sample or {}
        return np.array(
            [extra.get(c, 0) * b for _, c in schedule.slot_names()],
            dtype=np.int64,
        )

    def slot_macs(self, schedule: CacheSchedule, batch: int | None = None) -> np.ndarray:
        b = self.batch if batch is None else batch
        return np.array(
            [self.comp_macs_per_sample[c] * b for _, c in schedule.slot_names()],
            dtype=np.int64,
        )

    def const_macs(self, batch: int | None = None) -> int:
        b = self.batch if batch is None else batch
        return self.const_macs_per_sample * b

    def const_flops(self, batch: int | None = None) -> int:
        b = self.batch if batch is None else batch
        return (2 * self.const_macs_per_sample + self.const_extra_flops_per_sample) * b


# ---------------------------------------------------------------------------
# PixArt (α and Σ share the architecture: d=1152, 28 blocks, GELU-approx FF 4×)
# ---------------------------------------------------------------------------


def pixart_cost_table(
    height: int = 256,
    width: int = 256,
    *,
    text_tokens: int = 120,
    batch: int = 2,
    dim: int = 1152,
    patch_size: int = 2,
    vae_scale: int = 8,
    in_channels: int = 4,
    out_channels: int = 8,
    caption_dim: int = 4096,
    use_additional_conditions: bool | None = None,
) -> CostTable:
    """Exact calflops-equivalent cost table for PixArt-α/Σ.

    Derived (and test-verified) decomposition, per sample:
      attn1 = 4·d²·T            (qkv + out projections)
      attn2 = 2·d²·T + 2·d²·L   (q/out over latents, kv over text)
      ff    = 8·d²·T            (d→4d→d)
      const = patch-embed conv + caption projection + adaln-single MLP
              + adaln linear (6d²) + final proj, plus resolution/aspect
              embedders (size_emb_dim=384) when use_additional_conditions
              (the 1024 checkpoint; diffusers sets it for sample_size 128).
    """
    T = (height // vae_scale // patch_size) * (width // vae_scale // patch_size)
    L = text_tokens
    d = dim
    if use_additional_conditions is None:
        use_additional_conditions = (height // vae_scale) == 128
    const = (
        T * (in_channels * patch_size * patch_size) * d  # PatchEmbed conv
        + L * caption_dim * d + L * d * d  # caption projection MLP
        + (256 * d + d * d)  # timestep embedding MLP (sincos 256 → d → d)
        + 6 * d * d  # adaln_single linear (d → 6d)
        + T * d * (patch_size * patch_size * out_channels)  # proj_out
    )
    if use_additional_conditions:
        # resolution embedder runs on the flattened (h,w) pair → 2 samples
        # per batch element; aspect-ratio embedder on 1. size_emb_dim = 384.
        emb = 256 * 384 + 384 * 384
        const += 2 * emb + 1 * emb
    # flops beyond 2×macs in the constant (norms/activations), anchored to the
    # reference measurements at T=256 (135,367,164·? see test); calflops
    # counts these per executed elementwise op. We carry the measured values
    # at the two published resolutions and a linear-in-T interpolation
    # elsewhere (flops are reporting-only; the NSGA-II objective is MACs).
    extra_flops = _pixart_extra_flops(T, L, d)
    return CostTable(
        batch=batch,
        const_macs_per_sample=const,
        const_extra_flops_per_sample=extra_flops,
        const_fixed_flops=100 if use_additional_conditions else 0,
        comp_macs_per_sample={
            "attn1": 4 * d * d * T,
            "attn2": 2 * d * d * T + 2 * d * d * L,
            "ff": 8 * d * d * T,
        },
        comp_extra_flops_per_sample={"ff": 4 * d * T},  # GELU in d→4d→d
    )


def _pixart_extra_flops(T: int, L: int, d: int) -> int:
    # Anchors measured from reference JSONs (per sample):
    #   T=256 : (3,132,262,908 − 2·1,498,447,872)/2 = 67,683,582
    #   T=4096: (8,566,102,980,308 − 2·4,281,442,172,928 + 2·28·2·152,839,913,472…)
    # reduced to per-sample extra. Linear interpolation in T between anchors.
    anchors = {256: 67_683_582, 4096: 1_080_834_872}
    if T in anchors:
        return anchors[T]
    t0, t1 = 256, 4096
    v0, v1 = anchors[t0], anchors[t1]
    return int(round(v0 + (v1 - v0) * (T - t0) / (t1 - t0)))


# ---------------------------------------------------------------------------
# FLUX.1 (d=3072, 19 dual-stream + 38 single-stream blocks)
# ---------------------------------------------------------------------------


def flux_cost_table(
    height: int = 256,
    width: int = 256,
    *,
    text_tokens: int = 512,
    batch: int = 2,
    dim: int = 3072,
    vae_scale: int = 8,
    packed_channels: int = 64,
    caption_dim: int = 4096,
    pooled_dim: int = 768,
) -> CostTable:
    """Exact calflops-equivalent cost table for FLUX.1-dev.

    Per sample, with S = T_img + T_txt joint tokens:
      full_attn       = 4·S·d²  (qkv both streams + per-stream out projs)
      full_ff         = 8·T_img·d²
      full_ff_context = 8·T_txt·d²
      single_attn     = 3·S·d²  (qkv only; out fused into proj_out)
      single_proj_mlp = 4·S·d²
      single_proj_out = 5·S·d²  ((d+4d)→d)
      const = x_embedder + context_embedder + time/guidance/pooled-text
              embedders + per-block adaln linears (always execute: they
              produce the gates) + norm_out adaln + final proj_out.
    """
    T_img = (height // vae_scale // 2) * (width // vae_scale // 2)
    T_txt = text_tokens
    S = T_img + T_txt
    d = dim
    const = (
        T_img * packed_channels * d  # x_embedder
        + T_txt * caption_dim * d  # context_embedder
        + (256 * d + d * d)  # timestep embedder
        + (256 * d + d * d)  # guidance embedder (flux-dev)
        + (pooled_dim * d + d * d)  # pooled text embedder
        + 19 * 2 * 6 * d * d  # dual-block AdaLayerNormZero linears (img+txt)
        + 38 * 3 * d * d  # single-block AdaLayerNormZeroSingle linears
        + 2 * d * d  # norm_out AdaLayerNormContinuous linear
        + T_img * d * packed_channels  # proj_out
    )
    extra_flops = _flux_extra_flops(T_img, T_txt, d)
    return CostTable(
        batch=batch,
        const_macs_per_sample=const,
        const_extra_flops_per_sample=extra_flops,
        comp_macs_per_sample={
            "full_attn": 4 * S * d * d,
            "full_ff": 8 * T_img * d * d,
            "full_ff_context": 8 * T_txt * d * d,
            "single_attn": 3 * S * d * d,
            "single_proj_mlp": 4 * S * d * d,
            "single_proj_out": 5 * S * d * d,
        },
        # GELU is a counted nn.GELU module inside diffusers FeedForward but
        # plain functional in the single-stream proj_mlp path → no extra there
        comp_extra_flops_per_sample={
            "full_ff": 4 * d * T_img,
            "full_ff_context": 4 * d * T_txt,
        },
    )


def _flux_extra_flops(T_img: int, T_txt: int, d: int) -> int:
    # Anchors (per sample): 256→(41,445,568,518−2·19,643,498,496)/2;
    # 1024→(58,338,619,298−2·22,663,397,376)/2.
    anchors = {256: 1_079_285_763, 4096: 6_505_912_273}
    if T_img in anchors:
        return anchors[T_img]
    t0, t1 = 256, 4096
    v0, v1 = anchors[t0], anchors[t1]
    return int(round(v0 + (v1 - v0) * (T_img - t0) / (t1 - t0)))


# ---------------------------------------------------------------------------
# Schedule metric computation
# ---------------------------------------------------------------------------


def table_for_schedule(schedule: CacheSchedule) -> CostTable:
    cfg = schedule.top_level_config or {}
    h = cfg.get("height", 256)
    w = cfg.get("width", 256)
    if isinstance(schedule, FluxCacheSchedule):
        return flux_cost_table(h, w)
    if isinstance(schedule, PixArtCacheSchedule):
        weights = cfg.get("transformer_weights", "")
        use_addl = "1024" in weights or h >= 1024
        if use_addl:
            return pixart_cost_table(1024, 1024, use_additional_conditions=True)
        return pixart_cost_table(h, w)
    raise TypeError(f"no cost table for {type(schedule).__name__}")


def _gate_step(schedule: CacheSchedule) -> int | None:
    pipe = (schedule.top_level_config or {}).get("pipeline") or {}
    if pipe.get("name") == "tgate":
        return int(pipe.get("kwargs", {}).get("gate_step"))
    return None


def compute_schedule_metrics(
    schedule: CacheSchedule, table: CostTable | None = None
) -> dict:
    """Produce the reference metrics dict (compute_macs.py:224-236):
    {"by_inference_step": {"000": {"flops":…, "macs":…}, …},
     "total_flops", "total_flops_T", "total_macs", "total_macs_T"}."""
    if table is None:
        table = table_for_schedule(schedule)
    slot_macs_b1 = table.slot_macs(schedule, batch=1)
    slot_extra_b1 = table.slot_extra_flops(schedule, batch=1)
    mask = schedule.mask.copy()
    mask[0, :] = True  # step-0 cache-miss forcing
    gate = _gate_step(schedule)
    by_step = {}
    total_macs = 0
    total_flops = 0
    for step in range(schedule.num_inference_steps):
        b = table.batch
        if gate is not None and step >= gate:
            b = table.batch // 2
        comp = int(mask[step] @ slot_macs_b1) * b
        comp_extra = int(mask[step] @ slot_extra_b1) * b
        macs = table.const_macs_per_sample * b + comp
        flops = (
            (2 * table.const_macs_per_sample + table.const_extra_flops_per_sample)
            * b
            + table.const_fixed_flops
            + 2 * comp
            + comp_extra
        )
        by_step[f"{step:03}"] = {"flops": flops, "macs": macs}
        total_macs += macs
        total_flops += flops
    return {
        "by_inference_step": by_step,
        "total_flops": total_flops,
        "total_flops_T": total_flops / TERA,
        "total_macs": total_macs,
        "total_macs_T": total_macs / TERA,
    }


def _sdpa_macs_per_sample(
    schedule: CacheSchedule,
    dim: int | None = None,
    hw: tuple[int, int] | None = None,
) -> Mapping[str, int]:
    """Per-sample MACs of the SDPA matmuls (q·kᵀ and p·v) per component.

    These are deliberately EXCLUDED from the schedule metrics above —
    the NSGA-II objective matches the reference's calflops numbers, and
    calflops' module hooks never see torch SDPA (compute_macs.py:279-286)
    — but they are real tensor-core work, so pct-of-peak reporting must count
    them. A cached attention component skips its SDPA too, so these follow
    the same schedule mask. `dim` overrides the full-width model dim for
    width-reduced serving variants (e.g. FLUX dim 1536); `hw` overrides
    the schedule config's resolution for transfer serving (a 256-evolved
    schedule RUN at 1024² must count 1024² SDPA)."""
    cfg = schedule.top_level_config or {}
    h, w = hw if hw is not None else (
        cfg.get("height", 256), cfg.get("width", 256)
    )
    if isinstance(schedule, FluxCacheSchedule):
        d = dim or 3072
        T_img = (h // 8 // 2) * (w // 8 // 2)
        S = T_img + 512
        return {"full_attn": 2 * S * S * d, "single_attn": 2 * S * S * d}
    if isinstance(schedule, PixArtCacheSchedule):
        d = dim or 1152
        weights = cfg.get("transformer_weights", "")
        if "1024" in weights or h >= 1024:
            h = w = 1024
        T = (h // 8 // 2) * (w // 8 // 2)
        L = 120
        return {"attn1": 2 * T * T * d, "attn2": 2 * T * L * d}
    raise TypeError(f"no SDPA table for {type(schedule).__name__}")


def hardware_flops_per_image(
    schedule: CacheSchedule,
    table: CostTable | None = None,
    dim: int | None = None,
    hw: tuple[int, int] | None = None,
) -> int:
    """Total device FLOPs to denoise ONE image under `schedule`: the
    calflops-parity total_flops PLUS the SDPA matmul FLOPs the reference's
    profiler never counts (module hooks don't see torch SDPA). CFG batch
    and the TGATE half-batch rule follow compute_schedule_metrics. This is
    the numerator for the bench ladder's tflops_per_sec / pct_peak rows
    (VAE decode accounted separately via vae_decoder_flops). For serving
    variants that differ from the reference cost model — width-reduced
    FLUX, or FLUX's real batch-1 no-CFG serving vs the reference's
    batch-2 calflops convention — pass an explicit `table` (e.g.
    flux_cost_table(batch=1, dim=1536)) and matching `dim`."""
    if table is None:
        table = table_for_schedule(schedule)
    base = compute_schedule_metrics(schedule, table)["total_flops"]
    sdpa = _sdpa_macs_per_sample(schedule, dim, hw)
    slot_sdpa_b1 = np.array(
        [sdpa.get(c, 0) for _, c in schedule.slot_names()], dtype=np.int64
    )
    mask = schedule.mask.copy()
    mask[0, :] = True
    gate = _gate_step(schedule)
    sdpa_macs = 0
    for step in range(schedule.num_inference_steps):
        b = table.batch
        if gate is not None and step >= gate:
            b = table.batch // 2
        sdpa_macs += int(mask[step] @ slot_sdpa_b1) * b
    return base + 2 * sdpa_macs


def vae_decoder_flops(
    height: int = 256, width: int = 256, config=None
) -> int:
    """Analytic FLOPs (2×MACs) of one VAEDecoder forward at the given
    output resolution, replaying models/vae.py:VAEDecoder structurally
    (post_quant 1×1 → conv_in → mid resnet/attn/resnet → 4 up blocks of
    layers_per_block+1 resnets with ×2 upsampling → conv_out). Included in
    the ladder's MFU numerator because the timed protocol includes the
    decode."""
    from .models.vae import VAEConfig

    c = config or VAEConfig()
    h, w = height // 8, width // 8
    lc = c.latent_channels
    rev = tuple(reversed(c.block_out_channels))

    macs = h * w * lc * lc  # post_quant_conv 1x1
    ch = rev[0]
    macs += h * w * 9 * lc * ch  # conv_in 3x3

    def resnet(h, w, cin, cout):
        m = h * w * 9 * cin * cout + h * w * 9 * cout * cout
        if cin != cout:
            m += h * w * cin * cout  # 1x1 shortcut
        return m

    # mid: resnet, single-head spatial attention, resnet
    macs += resnet(h, w, ch, ch)
    n = h * w
    macs += 4 * n * ch * ch + 2 * n * n * ch  # q/k/v/out denses + SDPA
    macs += resnet(h, w, ch, ch)

    cin = ch
    for bi, cout in enumerate(rev):
        for _ in range(c.layers_per_block + 1):
            macs += resnet(h, w, cin, cout)
            cin = cout
        if bi < len(rev) - 1:
            h, w = h * 2, w * 2
            macs += h * w * 9 * cout * cout  # post-upsample 3x3 conv
    macs += h * w * 9 * cin * c.out_channels  # conv_out
    return 2 * macs


def attach_metrics(schedule: CacheSchedule, table: CostTable | None = None) -> dict:
    """Write metrics into the schedule (merging with any existing metrics,
    as the reference writes into the schedule JSON in place)."""
    metrics = compute_schedule_metrics(schedule, table)
    schedule.metrics.update(metrics)
    return metrics


def compute_dit_schedule_metrics(schedule, table: CostTable | None = None) -> dict:
    """Metrics for a DiT topology schedule (ecad_tpu_torch.graph.DiTSchedule):
    each executed block (skips drop it, repeats/parallel count every
    execution) costs the full per-block component sum; the per-step constant
    is unchanged. Mirrors how calflops would count the reference's fx graphs
    (only executed modules cost)."""
    if table is None:
        table = pixart_cost_table()
    per_block_b1 = sum(table.comp_macs_per_sample.values())
    per_block_extra_b1 = sum(
        (table.comp_extra_flops_per_sample or {}).values()
    )
    b = table.batch
    by_step = {}
    total_macs = 0
    total_flops = 0
    for step in range(schedule.num_inference_steps):
        n_exec = len(schedule.block_sequence(step))
        macs = (table.const_macs_per_sample + n_exec * per_block_b1) * b
        flops = (
            2 * table.const_macs_per_sample
            + table.const_extra_flops_per_sample
            + n_exec * (2 * per_block_b1 + per_block_extra_b1)
        ) * b + table.const_fixed_flops
        by_step[f"{step:03}"] = {"flops": flops, "macs": macs}
        total_macs += macs
        total_flops += flops
    return {
        "by_inference_step": by_step,
        "total_flops": total_flops,
        "total_flops_T": total_flops / TERA,
        "total_macs": total_macs,
        "total_macs_T": total_macs / TERA,
    }
