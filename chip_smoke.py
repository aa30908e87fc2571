"""Chip smoke test of ecad_tpu_torch on one Hopper GPU (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. Require CUDA on a compute-capability-9.0 card; print the card's name and
   power limit as nvidia-smi gives them.
2. Build the kernels from the checkout's sources: ``nvcc`` for
   ``ecad_tpu_torch/csrc/*.cu`` (one process per source, started together).
3. Kernels (``kernels``): hold each kernel against its plain PyTorch
   version on the card, at the main paths' shapes in bf16, at the odd
   shapes of the reference's kernel tests, and in fp32 at a tight
   tolerance — the exact-softmax attention (K1/K2; K1 also at FLUX-256's
   (4, 768, 24, 128)), the modulated LayerNorm (K3), the clamp-softmax
   attention of the transposed route (K4, both variants) and of the
   row-block route (K5, both variants; at FLUX-1024's (1, 4608, 24, 128)
   and at the reference's TestRowBlockAttention shapes at D=128); the
   clamp kernels also at q×1e4, compared by value, and in bf16 at a
   tolerance scaled to the output, shown to reject a plain version that
   drops or repeats one 64-key tile at 4096 (K4) and 4608 (K5) keys, and
   one 128-key tile at 4608; the streaming exact softmax (K6) at
   PixArt-2048's (2, 16384, 16, 72), at FLUX.1-dev-1536²'s (1, 9728, 24,
   128), in its key-padding variant and at the reference's
   TestFlashAttention shapes (fp32 and bf16, and at q×1e4 and logits ×6),
   in bf16 at a tolerance derived from its measured error
   (`flash_bf16_tol`), shown to reject a plain version that drops or
   repeats one 64-key tile at 16384 keys and one 128-key tile at 16384 and
   9728; the plain versions of K6 run per (batch·head) slice, since the
   fp32 scores of the served shape would take 34 GB. bf16 calls without a
   bias run on the Hopper body (``csrc/attention_sm90.cu``: wgmma fed by
   TMA) — K1, K4 and K6 at head dims 72 and 128, K5 at 128 — and so do bf16
   calls with a key-padding bias on the single-tile route (K2, at 72 and
   128), on the clamp routes (K4 with a bias at 72 and 128, K5 with a bias
   at 128) and on the streaming route (K6 with a bias at 72 and 128, at
   PixArt-2048's shape with lengths 15384 / 9000 and at FLUX-1536's with
   9000 keys kept, each reached through the router with the launch
   counters set to 0 just before and read just after, and named by a
   profile); they are held against their plain versions at ragged
   shapes (tq=30, tk=300 at d=72 and d=128; K6 also at 1600 keys, two of
   the reference's 1536-key blocks; K2 with key-padding lengths [100, 200,
   256]; K4 and K5 with biases in bf16 and fp32, per batch and broadcast
   over it, at Tk=300, and K4 at PixArt-Σ-2048's cross-attention (2,
   16384, 16, 72) → 120), logits near ±40 (log2) and q×1e4, and shown to
   reject a plain version that drops or repeats one 128-key tile (the
   body's step) at 768 (K1), 4096 (K4), 4608 (K5), 9728 and 16384 (K6,
   also with its bias) keys; K4 and K5 with a bias also in all-masked text rows, whose output
   must be Σv/Tk_pad within 2^-7 relative, a check shown to reject the
   pad keys counted twice (Σv/(Tk_pad + n_pad)); a call whose operands TMA
   cannot map, or whose bias the body does not read (fp16), raises there.
   The rest run on ``csrc/attention.cu``. The exact kernels
   of both (K2 in bf16 on the Hopper body and in fp32 on attention.cu, K6
   with a bias at d=72 and d=128) are also held against the plain versions
   in rows whose every key has a bias of −1e9 or −2e9, where the
   reference's pad keys take their share; and a dense bias past the
   single tile ((1, 2048, 2, 72) × 1100 keys, fp32 and bf16, on
   attention.cu), which the reference sends to XLA without pad keys, is
   held to its plain version with none, and its −1e9 and −2e9 rows to
   Σv/Tk. Time kernel (with the
   SM clock, power and temperature sampled before and after), plain
   version and (attention) one ``scaled_dot_product_attention`` call as a
   yardstick the port never calls. K3 (``csrc/modlnorm_sm90.cu``) also at
   each width a served path gives it: PixArt-1024's (4, 4096, 1152),
   PixArt-Σ-2048's (2, 16384, 1152) and FLUX.1-dev-1024's image, text and
   joint streams (1, 4096 / 512 / 4608, 3072), and FLUX-1024's image and
   text streams of one dual-block site in one launch
   (`modulated_layer_norm_pair`), each with its byte bound and its
   launches per trajectory (from the paths' runs below); batch-1 rows
   beside one ``F.layer_norm`` call with weight 1 + scale and bias shift
   (two at the pair), which is first held to the plain version; the pair
   shown to reject a text segment computed with the image segment's
   scale; K3 also in fp32, at d = 72 on strided rows and 8-byte-aligned
   ones, and in bf16 at d = 64, 96 and 99 (single elements).
4. The attention-variant harness (``variants``): the port of the JAX
   package's ``scripts/exp_attn_variants.py`` at its three shapes
   (2, 4608, 24, 128), (8, 4096, 16, 72) and (64, 1024, 16, 72) in bf16.
   Each of its kernels (X1 matmul only, X2 no max, X3 max on a pre-scaled
   q, X4 clamp with the denominator from the p·v product; K4 for the
   ``transposed`` rows) is held against its plain version on a 2-head
   slice at a tolerance derived from its measured error and shown to
   reject a dropped or repeated 64-key tile at 4096 keys (X1 also a
   128-key one, the Hopper body's step); all four run on the Hopper body
   (``attn_xmatmul_sm90_kernel``, ``attn_xnomax_sm90_kernel``,
   ``attn_xmax_sm90_kernel``, ``attn_xfd_sm90_kernel``, which a profile of
   one call each at every shape they take must name); X2's inf/NaN
   positions at q×64 against its plain version's; Tk = 200 refused by
   X1-X3 and the harness's K4 rows (and by the Hopper C entry in X1's,
   X2's and X3's modes), and X4 right there; X1-X4 refused at head dim 80
   and in fp32; the harness's ``main``
   once per shape (20 rows in all), with the launch counters checked
   against its calls; plain versions timed two heads at a time, one
   ``scaled_dot_product_attention`` call per shape as the yardstick (X1,
   whose output is unnormalised, has none: its row carries the two cuBLAS
   products bf16(q·kᵀ) then ·v, ``two_call_ms``, instead).
5. Main path at 256² (``main256``): full-width PixArt-α 256 (28 blocks,
   d=1152) with seeded random bf16 weights, batch 8 with CFG 4.5, 20
   DPM-Solver++ steps, the ECAD ``ours_fast`` schedule and the
   all-recompute default, each followed by the random bf16 VAE decode to
   (8, 256, 256, 3) uint8. Checks the kernel launch counts of each
   trajectory against its schedule, and a small fp32 trajectory on the card
   against the plain path on the CPU.
6. Checkpoints (``checkpoints``): a checkpoint tree in the public
   HuggingFace/diffusers layout, written under ``build/ecad_tpu_torch/ckpt``
   by chip_smoke's own safetensors writer from seeded arrays made on the
   card (the card has no ``safetensors``): PixArt-α 256's transformer at
   full width and depth in fp32, T5-XXL at full width and depth (24
   layers) in four BF16 shards and the SD VAE under the 1024-MS pipeline
   repo; FLUX.1-dev's repo in its public layout (CLIP-L in
   ``text_encoder/``, T5-XXL in ``text_encoder_2/``, hard links to the
   same shards; the 16-channel VAE and the transformer at full width cut
   to 2 dual + 2 single blocks, in bf16). Served through the generators'
   weights branches: ``PixArtAlphaImageGenerator(weights_root=…)`` at
   batch 8 under ``ours_fast`` and the default, 8 prompts of
   ``prompts/ImageRewardPrompts.json``, T5-XXL attached with a word-hash
   tokenizer stand-in (the card has no ``transformers``); PNGs written,
   VAE-decoded at 256²; K1, K2 and K3 launches equal to the masks' (the
   cross-attention with the tokenizer's mask lengths); each trajectory
   bit-equal to the same model built in memory from the same arrays
   (``bridge.pixart_state_dict``); ms/img in turns with a random-weight
   generator (the random bf16 VAE) on the same embeddings, beside
   ``main256``'s; one profiled ``ours_fast`` trajectory; T5-XXL's encode
   at 120 tokens (batch 2: a prompt and "") and 512 (batch 1); two T5-XXL
   layers in bf16 against the same module in fp32 on the CPU
   (`T5_BF16_TOL`, shown to reject one layer less). Then the cut FLUX at
   256², one prompt, ``flux_256/ours_fast``'s masks of its blocks: PNG,
   launches, a trajectory
   bit-equal to the in-memory build; CLIP-L at 77 tokens timed and its
   pooled output against the CPU's. Load seconds and GB/s of each
   directory (warm: just written), peak memory with the encoder resident.
   Its numbers go on a line of their own. PixArt-α 256's transformer and
   the SD VAE stay for the scorers phase.
7. The benchmark tier (``benchmark``): the port's tools in this process at
   full-width PixArt-α 256² (random bf16 weights), in a scratch directory
   on copies of the schedule JSONs: ``generate_embeddings`` over the first
   8 prompts of ``prompts/ImageRewardPrompts.json`` (hash encoder, text
   masks); ``generate_images --schedule-dir`` over ``ours_fast``,
   ``ours_faster`` and the default at batch 8 (one resident generator,
   each schedule swapped in), with the K1 (self), K2 (masked cross) and K3
   launches checked against the masks, the PNG counts, and a rerun that
   skips every schedule with no launch; one profiled trajectory of the
   tier's generator (``ours_fast`` with the random VAE) that must name the
   Hopper kernels; ``compute_macs`` (``ours_fast``'s total_macs
   2134989471744); ``score_images --scorer mock``; ``compute_fid
   --extractor pixel_stats`` (the default tree against its own stats
   within 1e-6, ``ours_fast`` against it finite and above 0);
   ``compute_latency --random-vae`` on ``ours_fast`` and the default (2
   warmups, 3 samples, batch 8; launches checked, ``metrics.latency.gpu``
   the card's name). Then ``ecad_tpu_torch.bench``'s protocol at batch 32
   (no text mask: the cross-attention on K1; each arm's launches checked),
   uncached and ``ours_fast`` in 3 turns after 2 warmups each, and one
   profiled run of each arm for its device idle share. Its numbers go on a
   line of their own.
8. The scorer towers (``scorers``): seeded full-width checkpoints written
   under ``build/ecad_tpu_torch/ckpt/scorers`` in each one's published
   layout — ImageReward.pt (fp32, ``torch.save``: ViT-L/16 at 224², 24
   layers × 1024, 16×64 heads, 197 tokens; BLIP's BERT-base with
   cross-attention, 12 layers × 768, vocab 30524, 35 tokens, encoder width
   1024; the 768→1024→128→64→16→1 head) with a vocab.txt, a ViT-B/32
   CLIP directory (config.json and safetensors) and a pt_inception
   checkpoint with batchnorm statistics. Each tower on the card (IEEE
   fp32: no TF32) against the same module on the CPU from the same arrays
   within `tower_tol`, each check shown to reject the CPU's output on a
   perturbed input (the top two patch rows black, or a prompt changed),
   and the ViT with TF32 on measured against the same bound; ms an image
   of each tower at batch 8 and 32 on 256² uint8 images on the card;
   ``score_images --scorer image_reward``, ``compute_clip`` (its default
   ``--scorer clip``) and ``compute_fid --extractor inception`` and
   ``clip_vision`` over the benchmark phase's PNGs, their outputs' counts
   and shapes checked; then ``genetic.train.main --scorer image_reward
   --image-reward-dir`` at PixArt-α 256² served from the checkpoints
   phase's tree (its transformer and SD VAE), 8 candidates × 4 prompts,
   one cycle and a resume: K1 and K3 launches equal to the evaluated
   candidates' masks, decoded images uint8 on the card, one candidate
   evaluated again to the same score, and an ``ours_fast`` candidate's
   time beside its scoring alone. The card has no ``transformers``: the
   ImageReward and CLIP scorers are built with the word-hash tokenizer
   and put in the registry's resident slots. Its numbers go on a line of
   their own. The phase deletes the checkpoint tree.
9. The search loop (``search``): ``ecad_tpu_torch.genetic.train.main`` in
   this process at full-width PixArt-α 256² (random bf16 weights and
   prompt embeddings, 20 steps, the weight-free fidelity scorer), 8
   candidates × 4 prompts a generation, gen 0 seeded with the default
   schedule, ``ours_fast`` and random genomes: one NSGA-II cycle, then a
   resume for one more. Checks the checkpoint, every evaluated candidate's
   scores.json and analytic MACs, the default candidate at exactly 200 dB
   (its trajectory makes the same launches on the same inputs as the
   uncached reference), ``ours_fast`` below it, K1 at the search's
   cross-attention shape (no text mask: 256 → 120 keys on the exact route)
   against its plain version, and the launch counts over both runs against
   every evaluated candidate's masks plus each run's reference trajectory;
   times each generation and profiles one candidate's evaluation.
10. Main path at 1024² (``main1024``): full-width PixArt-α 1024 (4096 image
   tokens, the resolution and aspect-ratio conditions), batch 2 with CFG,
   under the repo's ``default_1024x1024`` schedule, ``ours_fast`` and the
   TGATE schedule ``tgate_m_010_sp_003_fi_001_warmup_002`` (gate at step
   10), each decoded by the random VAE to (2, 1024, 1024, 3) uint8, with
   the launch counts of K4 (self- and cross-attention) and K3 checked
   against each schedule; and a tiny fp32 1024-style trajectory (size
   conditions, TGATE, 2304 tokens so that both K4 variants run) on the card
   against the plain path on the CPU.
11. Serving quantization (``quant``): the int8 product (``torch._int_mm``
   through ``ops/quant.py`` `int8_matmul`) held exact against the float64
   product of its int8 operands at PixArt-1024's and FLUX-1024's
   projection shapes (and FLUX's adaLN linear at one row, padded to 17),
   each timed beside its bound, one bf16 ``F.linear`` and the whole
   `int8_linear`; then full-width PixArt-α 1024² at batch 2 with CFG under
   ``ours_fast`` and ``default_1024x1024``, bf16 and the four modes
   (``int8``, ``int8_static``, ``int8_w``, ``int8_w_static``) on the same
   weights (int8_w quantized from the bf16 model, the static modes
   calibrated by the generator), each mode's K4, K3 and int8-product
   launches checked against the masks, its one-forward and final-latents
   error against bf16, ms/img from one synchronized pass with bf16, peak
   memory, and one profiled ``ours_fast`` run each split into the int8
   product, the quantize and dequant passes, the other GEMMs and the rest.
   FLUX.1-dev 1024² in ``int8_w`` and ``int8_w_static`` runs inside the
   flux phase, on its weights (below).
12. Main path at 2048² (``main2048``): full-width PixArt-Σ at 2048²
   (16384 image tokens, a 256×256 latent, no size conditions, position
   embedding interpolated by 4), batch 1 with CFG, under Σ's
   ``gen_default/default.json`` and ``pixart_sigma_256/ours_fast.json``
   in turns, each decoded by the random VAE to (1, 2048, 2048, 3) uint8
   (its mid-attention over 65536 tokens in query blocks), with the launch
   counts of K6 (self-attention), K4's bias variant (cross-attention,
   16384 → 120) and K3 checked against each schedule; and a tiny fp32
   trajectory with 8464 tokens, past 8192 so that self-attention takes the
   streaming route, on the card against the plain path on the CPU.
13. FLUX (``flux``): full-width FLUX.1-dev (19 dual + 38 single blocks,
   d=3072, 24×128 heads, 512 text tokens, guidance embedding; 11.9 B
   seeded random bf16 parameters) from hash-encoder prompts, 20 flow-match
   Euler steps at guidance 5: 1024² at batch 1 under
   ``default_1024x1024_gs_5.0_steps_20`` and ``fast_256_to_1024`` (joint
   attention through K5), 1536² at batch 1 (9728 joint tokens: the
   streaming route, K6 at D=128) under the all-recompute default and
   ``fast_256_to_1024``'s masks served at 1536², 256² at batch 4 under
   ``flux_256/ours_fast`` and the default (through K1), each decoded by the
   random 16-channel VAE to uint8, with the launch counts of K5, K6, K1 and
   K3 checked against each schedule; ``flux_256/ours_fast`` again with the
   caches stored as ``float8_e4m3fn`` (the same seeded weights), held to
   the same checks and set beside the bf16 caches' latents; one cycle of the
   search loop on the same resident model at 256² (4 candidates × 1 prompt,
   the fidelity scorer, checked as the PixArt search); the quant phase's
   FLUX part (`flux_quant`): ``int8_w`` quantized from the resident bf16
   model (which is then freed) and ``int8_w_static`` calibrated on it, at
   1024² batch 1 under the default and ``fast_256_to_1024``, with the
   launches of K5, K3 and the int8 products (the batch-1 adaLN linears'
   among them, through the padded product) checked, the latents against
   the bf16 runs' at the same noise, one timed run each, peak memory,
   weight bytes and one profiled ``fast`` run of ``int8_w`` split as
   PixArt's (the uncached 1024², 1536² and 256² trajectories are counted
   and timed, not profiled, to keep the run under 900 s); and a tiny fp32 FLUX
   trajectory (1536 joint tokens at D=128, the row-block route) on the
   card against the plain path on the CPU.
14. Entry points (``cli``): ``ecad_tpu_torch.inference.cli
   PixArtAlphaImageGenerator`` with a prompt file, random weights and
   ``ours_fast``, again with the 1024 TGATE schedule at batch size 2,
   ``PixArtSigmaImageGenerator`` at ``--height 2048 --width 2048
   --batch-size 1`` with Σ's ``ours_fast`` and one prompt, and
   ``FluxImageGenerator`` with ``flux_256/ours_fast`` and two prompts;
   checks their PNGs and launch counts. Without checkpoints the PNGs are
   the latent visualisation, as the reference writes them (256×256 for a
   2048² generation).

Prints a summary line, the ``benchmark``, ``checkpoints`` and
``scorers`` phases' lines, a ``{"kernels": [...]}`` line (X1's rows with ``two_call_ms``
beside the contract's keys), then as its last line
``{"ok": true, "device": {...}}``. A longer report (every check's error,
device and host times, per-trajectory profiles, each phase's seconds, the
nvcc/ptxas log) goes to ``--report`` (default
``build/ecad_tpu_torch/chip_smoke_report.json``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import struct
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ecad_tpu_torch.ops.quant import MODES as QUANT_MODES
from ecad_tpu_torch.ops.quant import STATIC_MODES, WEIGHT_MODES
from ecad_tpu_torch.utils.timing import (
    BF16_FLOPS,
    HBM_BYTES_PER_S,
    INT8_OPS,
    card_name,
    device_ms,
    sampled_device_ms,
)

ROOT = Path(__file__).resolve().parent
OURS_FAST = ROOT / "schedules/schedules_in_paper/pixart_alpha_256/ours_fast.json"
OURS_FASTER = ROOT / "schedules/schedules_in_paper/pixart_alpha_256/ours_faster.json"
DEFAULT_256 = ROOT / "schedules/alpha_cache_schedules/gen_default/default.json"
DEFAULT_1024 = (
    ROOT / "schedules/alpha_cache_schedules/gen_default_1024x1024/default_1024x1024.json"
)
TGATE_1024 = (
    ROOT / "schedules/alpha_cache_schedules/gen_tgate_1024"
    / "tgate_m_010_sp_003_fi_001_warmup_002.json"
)
SIGMA_OURS_FAST = ROOT / "schedules/schedules_in_paper/pixart_sigma_256/ours_fast.json"
SIGMA_DEFAULT = ROOT / "schedules/sigma_cache_schedules/gen_default/default.json"
FLUX_DEFAULT_1024 = (
    ROOT / "schedules/flux_cache_schedules/gen_default/default_1024x1024_gs_5.0_steps_20.json"
)
FLUX_FAST_1024 = ROOT / "schedules/schedules_in_paper/flux_256_to_1024/fast_256_to_1024.json"
FLUX_OURS_FAST_256 = ROOT / "schedules/schedules_in_paper/flux_256/ours_fast.json"
FLUX_DEFAULT_256 = (
    ROOT / "schedules/flux_cache_schedules/gen_default_varied_guidance_256"
    / "default_256x256_gs_5.json"
)
BATCH = 8
BATCH_1024 = 2
BATCH_2048 = 1  # the caches take 6.3 GB per image at 2048²
BATCH_FLUX_1024 = 1  # one 1024² image per request, as FLUX.1-dev is served
BATCH_FLUX_1536 = 1  # its caches take ≈ 16 GB per image at 9728 joint tokens
BATCH_FLUX_256 = 4
STEPS = 20
BF16_TOL = (2e-2, 2e-2)  # (atol, rtol): about two bf16 ulps of an O(1) output
FP32_TOL = (1e-5, 1e-5)  # fp32 kernels against fp32 plain versions
# fp32 clamp softmax at q×1e4: the logits are ~1e4, so their fp32 sums (in
# another order on each side) differ by ~1e-3 in absolute terms, which
# moves the weight of a key near the clamp's top by ~1e-3 relative
HOT_FP32_TOL = (1e-3, 1e-3)
REPORT: dict = {}
COUNTERS = ("attention", "attention_bias", "attention_long", "attention_long_bias",
            "attention_rowblock", "attention_rowblock_bias", "attention_flash",
            "attention_flash_bias", "xattn_matmul_only", "xattn_nomax", "xattn_max",
            "xattn_fd", "modlnorm", "int8_matmul")
def std_bf16_tol(share: float):
    """The (atol, rtol) rule for a bf16 attention output over many keys, as
    a function of the plain version's output `want`: one bf16 ulp relative
    (2^-7, the rounding of the output itself) plus `share` of the output's
    standard deviation. With q, k, v ~ N(0, 1) an output averages about
    Tk/e values of v, so its size falls like Tk^-1/2 (≈0.026 at 4096 keys,
    ≈0.013 at 16384): a fixed atol fitted to O(1) outputs would pass a
    kernel that drops one key tile."""
    return lambda want: (share * float(want.float().std()), 2.0 ** -7)


# the clamp kernels (K4, K5): a tenth of the std, which the run shows
# rejects a dropped or repeated 64-key tile at 4096 and 4608 keys
clamp_bf16_tol = std_bf16_tol(0.1)
# the streaming kernel (K6): over 16384 keys dropping one 64-key tile moves
# an output by only ≈ √(64e)/16384 ≈ 8e-4, below a tenth of its std, so the
# share comes from the kernel's measured error: the least atol that passes
# it (beside the 2^-7 rtol) was at most 0.0117·std on the H100 (16384 keys
# with the key-padding bias; 0.0108 without it, 0.0107 at 9728 keys, ≤
# 0.0072 at the reference's shapes; the report's `least_atol_per_std`), and
# this is twice that, rounded up; the run shows that it rejects the fault
flash_bf16_tol = std_bf16_tol(0.025)


def by_slices(plain, q, k, v, bias=None) -> torch.Tensor:
    """A plain attention version run one (batch, head) slice at a time, so
    that its fp32 scores fit the card at 16384 keys (34 GB for the whole
    of PixArt-2048's self-attention)."""
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        bb = None if bias is None else bias[b : b + 1] if bias.shape[0] > 1 else bias
        for h in range(q.shape[2]):
            sl = (slice(b, b + 1), slice(None), slice(h, h + 1))
            out[sl] = plain(q[sl], k[sl], v[sl], bb)
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    smi = card_name()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from ecad_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    REPORT["build_s"] = time.perf_counter() - t0
    REPORT["build_logs"] = dict(_build.BUILD_LOGS)
    log(f"built {sorted(_build.BUILD_LOGS) or 'nothing new'} in {REPORT['build_s']:.1f} s")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def timed_ms(label: str, fn, reps: int = 7, inner: int = 20, clocks: bool = False) -> float:
    """Device ms of one call (`device_ms`: CUDA events behind a spin
    kernel, median of `reps` means of `inner` calls); the host ms per call
    goes to the report beside it, and with `clocks` the card's SM clock,
    power draw and temperature sampled just before and just after."""
    if clocks:
        dev_ms, host_ms, sample = sampled_device_ms(fn, reps, inner)
    else:
        (dev_ms, host_ms), sample = device_ms(fn, reps, inner), None
    REPORT.setdefault("timing_ms", {})[label] = {"device": dev_ms, "host": host_ms,
                                                 **({"clocks": sample} if clocks else {})}
    return dev_ms


def beyond(got: torch.Tensor, want: torch.Tensor, tol) -> tuple[int, float, float, tuple]:
    """Elements of `got` beyond atol + rtol·|want|, the largest error, the
    least atol that would pass with this rtol as a share of `want`'s
    standard deviation (what flash_bf16_tol's share is derived from) and the
    (atol, rtol) used; `tol` is a pair or a function of `want` that gives
    one."""
    got32, want32 = got.float(), want.float()
    atol, rtol = tol(want32) if callable(tol) else tol
    err = (got32 - want32).abs()
    n_bad = int((err > atol + rtol * want32.abs()).sum())
    least = float((err - rtol * want32.abs()).max().clamp(min=0))
    return n_bad, float(err.max()), least / (float(want32.std()) or 1.0), (atol, rtol)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    n_bad, max_err, least_per_std, (atol, rtol) = beyond(got, want, tol)
    REPORT.setdefault("cases", {})[name] = max_err
    REPORT.setdefault("least_atol_per_std", {})[name] = least_per_std
    log(f"  {name}: max |kernel - plain| = {max_err:.3g} (atol {atol:.3g}, rtol {rtol:.3g})")
    if n_bad:
        raise AssertionError(
            f"{name}: {n_bad} elements beyond atol {atol} + rtol {rtol}"
            f" (max err {max_err:.3g})"
        )
    return max_err


def rejects(name: str, faulty: torch.Tensor, want: torch.Tensor, tol) -> None:
    """Raises unless the check `compare` makes with `tol` fails `faulty`, a
    plain version with a deliberate fault, against `want`: shows that the
    check would catch a kernel with that fault at this shape."""
    n_bad, max_err, _, (atol, rtol) = beyond(faulty, want, tol)
    REPORT.setdefault("faults_rejected", {})[name] = {
        "elements_beyond": n_bad, "of": want.numel(), "max_err": max_err,
    }
    log(f"  fault {name}: {n_bad} of {want.numel()} elements beyond atol {atol:.3g}"
        f" + rtol {rtol:.3g} (max err {max_err:.3g})")
    if not n_bad:
        raise AssertionError(f"fault {name} passes the tolerance it should fail")


def refused(name: str, fn, *args) -> None:
    """Raises unless `fn(*args)` raises ValueError: a call the Hopper body
    cannot map with TMA is refused, not sent to another body."""
    try:
        fn(*args)
    except ValueError as err:
        REPORT.setdefault("refused", {})[name] = str(err)
        log(f"  {name}: refused ({err})")
        return
    raise AssertionError(f"{name}: accepted operands TMA cannot map")


def key_padding_bias(lengths, tk, fill, dtype=torch.float32):
    keep = torch.arange(tk, device="cuda")[None, :] < torch.tensor(
        lengths, device="cuda"
    )[:, None]
    return torch.where(keep, 0.0, fill).to(dtype)[:, None, None, :]


def attention_cases() -> None:
    from ecad_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
        fused_attention,
        fused_attention_reference,
        rowblock_attention,
        rowblock_attention_reference,
        transposed_attention,
        transposed_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"

        def case(name, q, k, v, bias=None):
            compare(f"attention/{tag}/{name}",
                    fused_attention(q, k, v, bias),
                    fused_attention_reference(q, k, v, bias), tol)

        # bf16 at d=72 and d=128 without a bias: the Hopper body's K1
        for d in (72, 128):
            case(f"unaligned_tq30_tk300_d{d}",
                 rnd(2, 30, 3, d, dtype=dtype), rnd(2, 300, 3, d, dtype=dtype),
                 rnd(2, 300, 3, d, dtype=dtype))
            case(f"logits_near_40_d{d}",
                 rnd(1, 16, 1, d, dtype=dtype, scale=6.0),
                 rnd(1, 256, 1, d, dtype=dtype), rnd(1, 256, 1, d, dtype=dtype))
            case(f"one_key_tile_tq200_tk120_d{d}",
                 rnd(3, 200, 2, d, dtype=dtype), rnd(3, 120, 2, d, dtype=dtype),
                 rnd(3, 120, 2, d, dtype=dtype))
            # K2: the same with a key-padding bias (on the Hopper body in
            # bf16), per batch with lengths [100, 200, 256]
            case(f"key_padding_100_200_256_tq30_tk300_d{d}",
                 rnd(3, 30, 2, d, dtype=dtype), rnd(3, 300, 2, d, dtype=dtype),
                 rnd(3, 300, 2, d, dtype=dtype), key_padding_bias([100, 200, 256], 300, -1e9))
            case(f"key_padding_logits_near_40_d{d}",
                 rnd(1, 16, 1, d, dtype=dtype, scale=6.0), rnd(1, 256, 1, d, dtype=dtype),
                 rnd(1, 256, 1, d, dtype=dtype), key_padding_bias([200], 256, -1e4))
            hot = fused_attention(rnd(1, 128, 1, d, dtype=dtype, scale=1e4),
                                  rnd(1, 256, 1, d, dtype=dtype), rnd(1, 256, 1, d, dtype=dtype),
                                  key_padding_bias([200], 256, -1e4))
            if not torch.isfinite(hot.float()).all():
                raise AssertionError(f"attention_bias/{tag}: q×1e4 gave non-finite output"
                                     f" at d={d}")
        # rows whose every key has a bias of −1e9 (the reference's output
        # there is Σv/Tk_pad) or −2e9 (0), beside a ragged row: K2 (at d=72
        # on the Hopper body in bf16, on attention.cu in fp32 and at d=64)
        # and K6's bias variant (at d=72 and 128, on the Hopper body in
        # bf16), against the repaired plain versions
        from ecad_tpu_torch.ops.attention import _takes_sm90

        for fill in (-1e9, -2e9):
            for d in (64, 72, 128):
                qm, km, vm = (rnd(2, 8, 2, d, dtype=dtype), rnd(2, 300, 2, d, dtype=dtype),
                              rnd(2, 300, 2, d, dtype=dtype))
                bias_m = key_padding_bias([0, 280], 300, fill)
                on_sm90 = dtype == torch.bfloat16 and d != 64
                if (_takes_sm90("attention", qm, bias_m), _takes_sm90(
                        "attention_flash", qm, bias_m)) != (on_sm90, on_sm90):
                    raise AssertionError(f"every_key_biased_{fill:g} at d={d}: wrong body")
                if d != 128:
                    case(f"every_key_biased_{fill:g}" + ("" if d == 64 else f"_d{d}"),
                         qm, km, vm, bias_m)
                if d != 64:
                    # K6 with a bias (on the Hopper body in bf16): the streaming
                    # route's 84 pad keys
                    compare(f"attention_flash_bias/{tag}/every_key_biased_{fill:g}"
                            + ("" if d == 72 else f"_d{d}"),
                            flash_attention(qm, km, vm, bias_m),
                            flash_attention_reference(qm, km, vm, bias_m), tol)
        dense_bias_past_the_tile(rnd, dtype, tol)
        for d in (16, 64):
            case(f"d{d}", rnd(2, 16, 3, d, dtype=dtype),
                 rnd(2, 24, 3, d, dtype=dtype), rnd(2, 24, 3, d, dtype=dtype))
        case("per_batch_key_padding_100_200_256",
             rnd(3, 128, 2, 72, dtype=dtype), rnd(3, 256, 2, 72, dtype=dtype),
             rnd(3, 256, 2, 72, dtype=dtype),
             key_padding_bias([100, 200, 256], 256, -1e9))
        case("batch_broadcast_bias_1_1_1_tk",
             rnd(3, 32, 2, 64, dtype=dtype), rnd(3, 256, 2, 64, dtype=dtype),
             rnd(3, 256, 2, 64, dtype=dtype), key_padding_bias([100], 256, -1e9))
        case("dense_bias",
             rnd(2, 40, 3, 64, dtype=dtype), rnd(2, 70, 3, 64, dtype=dtype),
             rnd(2, 70, 3, 64, dtype=dtype), rnd(2, 3, 40, 70))
        # head dim not a multiple of 8, and rows off 16-byte alignment:
        # the element-wise (non-cp.async) load path
        case("unaligned_tq130_tk300_d36",
             rnd(2, 130, 2, 36, dtype=dtype), rnd(2, 300, 2, 36, dtype=dtype),
             rnd(2, 300, 2, 36, dtype=dtype))
        wide = rnd(2, 64, 3, 80, dtype=dtype)
        misaligned = (wide[..., 1:73], wide[..., 3:75], wide[..., 5:77])
        if dtype == torch.bfloat16:
            # the Hopper body refuses what TMA cannot map, with or without
            # K2's bias, and a bias it does not read; none of them is sent
            # to attention.cu
            refused("attention/bf16/misaligned_rows_d72", fused_attention, *misaligned)
            refused("attention_bias/bf16/misaligned_rows_d72_key_padding", fused_attention,
                    *misaligned, key_padding_bias([64, 50], 64, -1e9))
            refused("attention_long/bf16/misaligned_rows_d72", transposed_attention,
                    *misaligned)
            refused("attention_flash/bf16/misaligned_rows_d72", flash_attention, *misaligned)
            refused("attention_bias/bf16/fp16_bias", fused_attention,
                    rnd(2, 16, 2, 72, dtype=dtype), rnd(2, 120, 2, 72, dtype=dtype),
                    rnd(2, 120, 2, 72, dtype=dtype),
                    key_padding_bias([7, 60], 120, -1e4, torch.float16))
        else:
            case("misaligned_rows_d72", *misaligned)
        case("logits_near_40",
             rnd(1, 16, 1, 64, dtype=dtype, scale=6.0),
             rnd(1, 256, 1, 64, dtype=dtype), rnd(1, 256, 1, 64, dtype=dtype))
        for d in (72, 128):
            hot = fused_attention(rnd(1, 128, 1, d, dtype=dtype, scale=1e4),
                                  rnd(1, 256, 1, d, dtype=dtype),
                                  rnd(1, 256, 1, d, dtype=dtype))
            if not torch.isfinite(hot.float()).all():
                raise AssertionError(f"attention/{tag}: q×1e4 gave non-finite output at d={d}")

        # the clamp softmax (K4) at the reference's TestTransposedAttention
        # shapes (tests/test_ops.py:289-328)
        def clamp_case(name, q, k, v, bias=None,
                       tol=clamp_bf16_tol if dtype == torch.bfloat16 else tol):
            compare(f"attention_long/{tag}/{name}",
                    transposed_attention(q, k, v, bias),
                    transposed_attention_reference(q, k, v, bias), tol)

        clamp_case("multiblock_q_256_384_d72", rnd(2, 256, 2, 72, dtype=dtype),
                   rnd(2, 384, 2, 72, dtype=dtype), rnd(2, 384, 2, 72, dtype=dtype))
        clamp_case("multichunk_kv_128_512_d72", rnd(2, 128, 2, 72, dtype=dtype),
                   rnd(2, 512, 2, 72, dtype=dtype), rnd(2, 512, 2, 72, dtype=dtype))
        clamp_case("unaligned_tq130_tk300_d36", rnd(2, 130, 2, 36, dtype=dtype),
                   rnd(2, 300, 2, 36, dtype=dtype), rnd(2, 300, 2, 36, dtype=dtype))
        clamp_case("batch_broadcast_bias_1_1_1_tk", rnd(3, 128, 2, 72, dtype=dtype),
                   rnd(3, 256, 2, 72, dtype=dtype), rnd(3, 256, 2, 72, dtype=dtype),
                   key_padding_bias([100], 256, -1e9))
        clamp_case("per_batch_key_padding_100_200_256", rnd(3, 128, 2, 72, dtype=dtype),
                   rnd(3, 256, 2, 72, dtype=dtype), rnd(3, 256, 2, 72, dtype=dtype),
                   key_padding_bias([100, 200, 256], 256, -1e9))
        if dtype == torch.bfloat16:
            # K4 and K5 with a bias refuse what TMA cannot map and a bias
            # they do not read, as K2 does
            refused("attention_long_bias/bf16/misaligned_rows_d72_key_padding",
                    transposed_attention, *misaligned, key_padding_bias([64, 50], 64, -1e9))
            for name, fn, d in (("attention_long_bias", transposed_attention, 72),
                                ("attention_rowblock_bias", rowblock_attention, 128)):
                refused(f"{name}/bf16/fp16_bias_d{d}", fn,
                        rnd(2, 16, 2, d, dtype=dtype), rnd(2, 120, 2, d, dtype=dtype),
                        rnd(2, 120, 2, d, dtype=dtype),
                        key_padding_bias([7, 60], 120, -1e4, torch.float16))
            # the text bias in bf16, as the models make it, per batch and
            # broadcast over it, at an unaligned Tk
            for d in (72, 128):
                clamp_case(f"ragged_tq30_tk300_key_padding_bf16_d{d}",
                           rnd(3, 30, 2, d, dtype=dtype), rnd(3, 300, 2, d, dtype=dtype),
                           rnd(3, 300, 2, d, dtype=dtype),
                           key_padding_bias([7, 120, 300], 300, -10000.0, dtype))
                clamp_case(f"batch_broadcast_bias_bf16_d{d}", rnd(3, 64, 2, d, dtype=dtype),
                           rnd(3, 120, 2, d, dtype=dtype), rnd(3, 120, 2, d, dtype=dtype),
                           key_padding_bias([60], 120, -10000.0, dtype))
            clamp_case("key_padding_logits_times_6_d72", rnd(1, 16, 1, 72, dtype=dtype, scale=6.0),
                       rnd(1, 256, 1, 72, dtype=dtype), rnd(1, 256, 1, 72, dtype=dtype),
                       key_padding_bias([200], 256, -1e4, dtype))
        else:
            clamp_case("misaligned_rows_d72", *misaligned)
        clamp_case("q_times_1e4", rnd(1, 128, 1, 72, dtype=dtype, scale=1e4),
                   rnd(1, 256, 1, 72, dtype=dtype), rnd(1, 256, 1, 72, dtype=dtype),
                   **({} if dtype == torch.bfloat16 else {"tol": HOT_FP32_TOL}))
        # the Hopper body's K4 at the reference's K1 acceptance shapes, and
        # at d=128 (transposed_attention takes it; the router never does)
        for d in (72, 128):
            clamp_case(f"ragged_tq30_tk300_d{d}", rnd(2, 30, 2, d, dtype=dtype),
                       rnd(2, 300, 2, d, dtype=dtype), rnd(2, 300, 2, d, dtype=dtype))
            clamp_case(f"logits_times_6_d{d}", rnd(1, 16, 1, d, dtype=dtype, scale=6.0),
                       rnd(1, 256, 1, d, dtype=dtype), rnd(1, 256, 1, d, dtype=dtype))
        clamp_case("q_times_1e4_d128", rnd(1, 128, 1, 128, dtype=dtype, scale=1e4),
                   rnd(1, 256, 1, 128, dtype=dtype), rnd(1, 256, 1, 128, dtype=dtype),
                   **({} if dtype == torch.bfloat16 else {"tol": HOT_FP32_TOL}))

        # the row-block clamp softmax (K5) at the reference's
        # TestRowBlockAttention shapes (tests/test_ops.py:143-188), at the
        # head dim the route serves (128)
        def rowblock_case(name, q, k, v, bias=None,
                          tol=clamp_bf16_tol if dtype == torch.bfloat16 else tol):
            compare(f"attention_rowblock/{tag}/{name}",
                    rowblock_attention(q, k, v, bias),
                    rowblock_attention_reference(q, k, v, bias), tol)

        rowblock_case("multiblock_q_48_384_d128", rnd(2, 48, 2, 128, dtype=dtype),
                      rnd(2, 384, 2, 128, dtype=dtype), rnd(2, 384, 2, 128, dtype=dtype))
        rowblock_case("ragged_tq30_tk300_d128", rnd(2, 30, 2, 128, dtype=dtype),
                      rnd(2, 300, 2, 128, dtype=dtype), rnd(2, 300, 2, 128, dtype=dtype))
        rowblock_case("ragged_tk300_key_padding_250_300", rnd(2, 30, 2, 128, dtype=dtype),
                      rnd(2, 300, 2, 128, dtype=dtype), rnd(2, 300, 2, 128, dtype=dtype),
                      key_padding_bias([250, 300], 300, -1e9))
        rowblock_case("batch_broadcast_bias_b3_1_1_1_tk", rnd(3, 32, 2, 128, dtype=dtype),
                      rnd(3, 256, 2, 128, dtype=dtype), rnd(3, 256, 2, 128, dtype=dtype),
                      key_padding_bias([100], 256, -1e9))
        rowblock_case("per_batch_key_padding_100_200_256", rnd(3, 32, 2, 128, dtype=dtype),
                      rnd(3, 256, 2, 128, dtype=dtype), rnd(3, 256, 2, 128, dtype=dtype),
                      key_padding_bias([100, 200, 256], 256, -1e9))
        rowblock_case("logits_times_6", rnd(1, 16, 1, 128, dtype=dtype, scale=6.0),
                      rnd(1, 256, 1, 128, dtype=dtype), rnd(1, 256, 1, 128, dtype=dtype))
        rowblock_case("q_times_1e4", rnd(1, 16, 1, 128, dtype=dtype, scale=1e4),
                      rnd(1, 256, 1, 128, dtype=dtype), rnd(1, 256, 1, 128, dtype=dtype),
                      **({} if dtype == torch.bfloat16 else {"tol": HOT_FP32_TOL}))
        if dtype == torch.bfloat16:
            rowblock_case("ragged_tk300_key_padding_bf16_250_300",
                          rnd(2, 30, 2, 128, dtype=dtype), rnd(2, 300, 2, 128, dtype=dtype),
                          rnd(2, 300, 2, 128, dtype=dtype),
                          key_padding_bias([250, 300], 300, -10000.0, dtype))
            rowblock_case("batch_broadcast_bias_bf16_b3", rnd(3, 32, 2, 128, dtype=dtype),
                          rnd(3, 256, 2, 128, dtype=dtype), rnd(3, 256, 2, 128, dtype=dtype),
                          key_padding_bias([100], 256, -10000.0, dtype))
            all_masked_rows(rnd)

        # the streaming exact softmax (K6) at the reference's
        # TestFlashAttention shapes (tests/test_ops.py:58-122), at their
        # head dims and at the served 72 and 128; q×1e4 gives one-hot rows
        def flash_case(name, q, k, v, bias=None):
            compare(f"attention_flash/{tag}/{name}", flash_attention(q, k, v, bias),
                    flash_attention_reference(q, k, v, bias),
                    flash_bf16_tol if dtype == torch.bfloat16 else tol)

        for d0 in (None, 72, 128):
            d64, d32 = d0 or 64, d0 or 32  # the reference's head dims, or d0
            flash_case(f"multiblock_kv_48_384_d{d64}", rnd(2, 48, 2, d64, dtype=dtype),
                       rnd(2, 384, 2, d64, dtype=dtype), rnd(2, 384, 2, d64, dtype=dtype))
            flash_case(f"unaligned_tq24_tk300_d{d32}", rnd(2, 24, 2, d32, dtype=dtype),
                       rnd(2, 300, 2, d32, dtype=dtype), rnd(2, 300, 2, d32, dtype=dtype))
            flash_case(f"key_padding_120_of_256_d{d64}", rnd(2, 32, 2, d64, dtype=dtype),
                       rnd(2, 256, 2, d64, dtype=dtype), rnd(2, 256, 2, d64, dtype=dtype),
                       key_padding_bias([120, 120], 256, -1e9))
            flash_case(f"batch_broadcast_bias_b3_d{d64}", rnd(3, 32, 2, d64, dtype=dtype),
                       rnd(3, 256, 2, d64, dtype=dtype), rnd(3, 256, 2, d64, dtype=dtype),
                       key_padding_bias([100], 256, -1e9))
        for d in (72, 128):
            flash_case(f"q_times_1e4_d{d}", rnd(1, 32, 1, d, dtype=dtype, scale=1e4),
                       rnd(1, 256, 1, d, dtype=dtype), rnd(1, 256, 1, d, dtype=dtype))
            flash_case(f"ragged_tq30_tk300_d{d}", rnd(2, 30, 2, d, dtype=dtype),
                       rnd(2, 300, 2, d, dtype=dtype), rnd(2, 300, 2, d, dtype=dtype))
        # two of the reference's 1536-key blocks: 1600 keys pad to 3072 (n_pad
        # 1472), whose pad keys the body's epilogue adds
        flash_case("two_key_blocks_tk1600_d72", rnd(2, 48, 2, 72, dtype=dtype),
                   rnd(2, 1600, 2, 72, dtype=dtype), rnd(2, 1600, 2, 72, dtype=dtype))
        flash_case("logits_times_6_d128", rnd(1, 16, 1, 128, dtype=dtype, scale=6.0),
                   rnd(1, 256, 1, 128, dtype=dtype), rnd(1, 256, 1, 128, dtype=dtype))


def all_masked_rows(rnd) -> None:
    """K4 and K5 with a bias in an all-masked text row (batch row 0 keeps
    no key): every logit clamps at −100 and the reference's Tk_pad −
    Tk pad keys weigh 2^-100 as well, so the output there is Σv/Tk_pad
    (the keys past Tk at weight 0, the pad keys added once). Each case is
    held against its plain version, its all-masked row against Σv/Tk_pad
    within 2^-7 relative, and that check is shown to reject the pad keys
    counted twice, Σv/(Tk_pad + n_pad) — which the std-scaled tolerance
    alone passes at 120 keys."""
    from ecad_tpu_torch.ops import (
        rowblock_attention,
        rowblock_attention_reference,
        transposed_attention,
        transposed_attention_reference,
    )

    bf = torch.bfloat16
    row_tol = (1e-6, 2.0 ** -7)
    for name, fn, plain, d, tk, fill, bias_dtype in (
        ("attention_long_bias", transposed_attention, transposed_attention_reference,
         72, 120, -10000.0, bf),
        ("attention_long_bias", transposed_attention, transposed_attention_reference,
         72, 300, -1e9, torch.float32),
        ("attention_long_bias", transposed_attention, transposed_attention_reference,
         128, 300, -10000.0, bf),
        ("attention_rowblock_bias", rowblock_attention, rowblock_attention_reference,
         128, 300, -10000.0, bf),
        ("attention_rowblock_bias", rowblock_attention, rowblock_attention_reference,
         128, 300, -1e9, torch.float32),
    ):
        case = f"{name}/bf16/all_masked_row_tk{tk}_{fill:g}_d{d}"
        q = rnd(2, 256, 2, d, dtype=bf)
        k, v = rnd(2, tk, 2, d, dtype=bf), rnd(2, tk, 2, d, dtype=bf)
        bias = key_padding_bias([0, tk - 20], tk, fill, bias_dtype)
        got = fn(q, k, v, bias)
        compare(case, got, plain(q, k, v, bias), clamp_bf16_tol)
        tk_pad = (tk + 127) // 128 * 128
        mean_v = (v[:1].float().sum(1, keepdim=True) / tk_pad).expand_as(got[:1])
        compare(f"{case}/mean_v", got[:1], mean_v, row_tol)
        rejects(f"{case}/pad_keys_counted_twice", mean_v * tk_pad / (2 * tk_pad - tk),
                mean_v, row_tol)


def dense_bias_past_the_tile(rnd, dtype, tol) -> None:
    """A dense (1, 2, 2048, 1100) bias past the single tile (a 9.4 MB score
    tile): the reference sends it to XLA, which adds no pad keys, so the
    route is "exact_xla" and the kernel (csrc/attention.cu's exact variant,
    counted under ``attention_bias``) gets n_pad = 0. Held to its plain
    version with no pad keys at `tol`; the rows whose every key has a bias
    of −1e9 (rows 0-7) or −2e9 (rows 8-15) to Σv/Tk within 2^-7 relative,
    a check shown to reject the single-tile route's pad-key count there
    (Σv/1152 and 0)."""
    from ecad_tpu_torch.ops import (
        attention_route,
        fused_attention,
        fused_attention_reference,
        launch_counts,
        reset_launch_counts,
    )

    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    tk = 1100
    q, k, v = (rnd(1, 2048, 2, 72, dtype=dtype), rnd(1, tk, 2, 72, dtype=dtype),
               rnd(1, tk, 2, 72, dtype=dtype))
    bias = rnd(1, 2, 2048, tk)
    bias[:, :, :8] = -1e9
    bias[:, :, 8:16] = -2e9
    if attention_route(tuple(q.shape), tk, bias) != "exact_xla":
        raise AssertionError("the dense bias past the tile did not take the XLA route")
    reset_launch_counts()
    got = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    if launch_counts() != {**dict.fromkeys(COUNTERS, 0), "attention_bias": 1}:
        raise AssertionError(f"dense bias past the tile: launches {launch_counts()}")
    name = f"attention_bias/{tag}/dense_bias_past_the_tile_1x2048x2x72_to_{tk}"
    compare(name, got, fused_attention_reference(q, k, v, bias, 0), tol)
    row_tol = (1e-6, 2.0 ** -7)
    mean_v = (v.float().sum(1, keepdim=True) / tk).expand(1, 16, 2, 72)
    compare(f"{name}/masked_rows_mean_v", got[:, :16], mean_v, row_tol)
    rejects(f"{name}/minus_1e9_rows_with_pad_keys", mean_v[:, :8] * tk / 1152, mean_v[:, :8],
            row_tol)
    rejects(f"{name}/minus_2e9_rows_with_pad_keys", torch.zeros_like(mean_v[:, 8:]),
            mean_v[:, 8:], row_tol)


# K3 at each width a served path gives it, by row name: x's (B, T, d) —
# PixArt-1024's and PixArt-Σ-2048's blocks and final norm, FLUX.1-dev-1024's
# image stream (its dual blocks and final norm), text stream (dual blocks)
# and joint stream (single blocks); their launches come from those paths'
# runs (`flux_modlnorm_streams` splits FLUX's by stream)
K3_SERVED = {
    "modlnorm_pixart1024": (2 * BATCH_1024, 4096, 1152),
    "modlnorm_pixart2048": (2 * BATCH_2048, 16384, 1152),
    "modlnorm_flux1024_img": (BATCH_FLUX_1024, 4096, 3072),
    "modlnorm_flux1024_txt": (BATCH_FLUX_1024, 512, 3072),
    "modlnorm_flux1024_joint": (BATCH_FLUX_1024, 4608, 3072),
}


def kernel_phase(b2: int, b2_1024: int) -> dict:
    """Checks every kernel and times it at the main paths' shapes (2B = b2
    rows of CFG batch at 256², b2_1024 at 1024²). Returns the per-kernel
    measurements."""
    import torch.nn.functional as F

    from ecad_tpu_torch.ops import (
        fused_attention,
        fused_attention_reference,
        launch_counts,
        modulated_layer_norm,
        modulated_layer_norm_reference,
        reset_launch_counts,
        transposed_attention_reference,
    )

    log("kernel phase")
    attention_cases()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    h, t, l, d, dim = 16, 256, 120, 72, 1152

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(b2, t, h, d), rnd(b2, t, h, d), rnd(b2, t, h, d)
    kc, vc = rnd(b2, l, h, d), rnd(b2, l, h, d)
    lengths = [(7, 60, 120)[i % 3] for i in range(b2)]
    # the main path's text bias: (1 − mask)·−10000 in fp32, cast to bf16
    bias = key_padding_bias(lengths, l, -10000.0, bf)
    x = rnd(b2, t, dim)
    mods = rnd(b2, 6, dim) * 0.1
    scale, shift = mods[:, 1:2], mods[:, 0:1]  # strided views, as in the block

    out = {}
    err1 = compare("attention/bf16/main_self_256x256_d72",
                   fused_attention(q, k, v), fused_attention_reference(q, k, v),
                   BF16_TOL)
    err2 = compare("attention/bf16/main_cross_256x120_d72_key_padding",
                   fused_attention(q, kc, vc, bias),
                   fused_attention_reference(q, kc, vc, bias), BF16_TOL)
    err3 = compare("modlnorm/bf16/main_2Bx256x1152",
                   modulated_layer_norm(x, scale, shift),
                   modulated_layer_norm_reference(x, scale, shift), BF16_TOL)
    x32, s32, h32 = x.float(), scale.float(), shift.float()
    compare("modlnorm/fp32/main_2Bx256x1152",
            modulated_layer_norm(x32, s32, h32),
            modulated_layer_norm_reference(x32, s32, h32), FP32_TOL)
    compare("modlnorm/fp32/d72_ragged",
            modulated_layer_norm(x32[:3, :5, :72], s32[:3, :, :72], h32[:3, :, :72]),
            modulated_layer_norm_reference(x32[:3, :5, :72], s32[:3, :, :72],
                                           h32[:3, :, :72]), FP32_TOL)
    # rows 8 bytes off 16: the kernel's 8-byte vectors
    compare("modlnorm/fp32/d72_ragged_8_byte_aligned",
            modulated_layer_norm(x32[:3, :5, 2:74], s32[:3, :, 2:74], h32[:3, :, 2:74]),
            modulated_layer_norm_reference(x32[:3, :5, 2:74], s32[:3, :, 2:74],
                                           h32[:3, :, 2:74]), FP32_TOL)
    # the small widths of the tests, and a width only single elements tile
    for dk in (64, 96, 99):
        xk, mk = rnd(3, 5, dk), rnd(3, 6, dk) * 0.1
        compare(f"modlnorm/bf16/d{dk}", modulated_layer_norm(xk, mk[:, 1:2], mk[:, 0:1]),
                modulated_layer_norm_reference(xk, mk[:, 1:2], mk[:, 0:1]), BF16_TOL)

    def nbytes(*ts):
        return sum(tt.numel() * tt.element_size() for tt in ts)

    def bound(bytes_, flops):
        tb, tf = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kct, vct = (a.transpose(1, 2).contiguous() for a in (kc, vc))
    o = torch.empty_like(q)
    b1, by1 = bound(nbytes(q, k, v, o), 4 * b2 * h * t * t * d)
    b2_ms, by2 = bound(nbytes(q, kc, vc, o, bias), 4 * b2 * h * t * l * d)
    b3, by3 = bound(nbytes(x, x, scale, shift), 8 * x.numel())
    rows = [
        dict(name="attention", route="cuda",
             source="ecad_tpu_torch/csrc/attention_sm90.cu",
             replaces="ecad_tpu/ops/attention.py:58 (_attn_kernel)",
             max_abs_err=err1,
             ms=timed_ms("attention", lambda: fused_attention(q, k, v), clocks=True),
             plain_ms=timed_ms("attention/plain",
                               lambda: fused_attention_reference(q, k, v)),
             bound_ms=b1, bound_by=by1,
             library_ms=timed_ms("attention/sdpa",
                                 lambda: F.scaled_dot_product_attention(qt, kt, vt))),
        dict(name="attention_bias", route="cuda",
             source="ecad_tpu_torch/csrc/attention_sm90.cu",
             replaces="ecad_tpu/ops/attention.py:75 (_attn_kernel_bias)",
             max_abs_err=err2,
             ms=timed_ms("attention_bias", lambda: fused_attention(q, kc, vc, bias),
                         clocks=True),
             plain_ms=timed_ms("attention_bias/plain",
                               lambda: fused_attention_reference(q, kc, vc, bias)),
             bound_ms=b2_ms, bound_by=by2,
             library_ms=timed_ms("attention_bias/sdpa",
                                 lambda: F.scaled_dot_product_attention(
                                     qt, kct, vct, attn_mask=bias))),
        dict(name="modlnorm", route="cuda",
             source="ecad_tpu_torch/csrc/modlnorm_sm90.cu",
             replaces="ecad_tpu/ops/fused.py:20 (_modlnorm_kernel)",
             max_abs_err=err3,
             ms=timed_ms("modlnorm", lambda: modulated_layer_norm(x, scale, shift),
                         clocks=True),
             plain_ms=timed_ms("modlnorm/plain",
                               lambda: modulated_layer_norm_reference(x, scale, shift)),
             bound_ms=b3, bound_by=by3, library_ms=None),
    ]

    # the clamp softmax (K4) at PixArt-1024's shapes (self-attention over
    # 4096 tokens, cross-attention to 120 text keys with the text bias) and
    # at PixArt-512's self-attention, reached through the router
    t4 = 4096
    q4, k4, v4 = rnd(b2_1024, t4, h, d), rnd(b2_1024, t4, h, d), rnd(b2_1024, t4, h, d)
    kc4, vc4 = rnd(b2_1024, l, h, d), rnd(b2_1024, l, h, d)
    bias4 = key_padding_bias([(7, 60, 120)[i % 3] for i in range(b2_1024)], l, -10000.0, bf)
    q5, k5, v5 = (rnd(b2, 1024, h, d) for _ in range(3))
    reset_launch_counts()
    got = {
        "self_1024": fused_attention(q4, k4, v4),
        "cross_1024": fused_attention(q4, kc4, vc4, bias4),
        "self_512": fused_attention(q5, k5, v5),
    }
    torch.cuda.synchronize()
    routed = launch_counts()
    if (routed["attention_long"], routed["attention_long_bias"]) != (2, 1) or (
        routed["attention"] or routed["attention_bias"]
    ):
        raise AssertionError(f"PixArt-512/1024 shapes did not route to K4: {routed}")
    want4 = transposed_attention_reference(q4, k4, v4)
    err4 = compare(f"attention_long/bf16/main_self_1024_{b2_1024}x4096x16x72",
                   got["self_1024"], want4, clamp_bf16_tol)
    # the same check must fail a kernel that skips or repeats one key tile
    # of the 4096: 64 keys (the mma.sync body's step) or 128 (the Hopper
    # body's)
    for n, tag in ((64, ""), (128, "128_")):
        rejects(f"self_1024_drops_{tag}key_tile_1",
                transposed_attention_reference(q4, torch.cat((k4[:, :n], k4[:, 2 * n:]), 1),
                                               torch.cat((v4[:, :n], v4[:, 2 * n:]), 1)),
                want4, clamp_bf16_tol)
        rejects(f"self_1024_repeats_{tag}key_tile_1",
                transposed_attention_reference(q4, torch.cat((k4[:, :2 * n], k4[:, n:]), 1),
                                               torch.cat((v4[:, :2 * n], v4[:, n:]), 1)),
                want4, clamp_bf16_tol)
    del want4
    err5 = compare(f"attention_long/bf16/main_cross_1024_{b2_1024}x4096_to_120_key_padding",
                   got["cross_1024"],
                   transposed_attention_reference(q4, kc4, vc4, bias4), clamp_bf16_tol)
    compare(f"attention_long/bf16/self_512_{b2}x1024x16x72", got["self_512"],
            transposed_attention_reference(q5, k5, v5), clamp_bf16_tol)
    q5t, k5t, v5t = (a.transpose(1, 2).contiguous() for a in (q5, k5, v5))
    # K4 with a bias at PixArt-Σ-2048's cross-attention, 16384 queries to 120
    # text keys, through the router
    q2k = rnd(2 * BATCH_2048, 16384, h, d)
    kc2k, vc2k = rnd(2 * BATCH_2048, l, h, d), rnd(2 * BATCH_2048, l, h, d)
    bias2k = key_padding_bias([(7, 60, 120)[i % 3] for i in range(2 * BATCH_2048)], l,
                              -10000.0, bf)
    compare(f"attention_long_bias/bf16/cross_2048_{2 * BATCH_2048}x16384_to_120_key_padding",
            fused_attention(q2k, kc2k, vc2k, bias2k),
            transposed_attention_reference(q2k, kc2k, vc2k, bias2k), clamp_bf16_tol)
    q2kt, kc2kt, vc2kt = (a.transpose(1, 2).contiguous() for a in (q2k, kc2k, vc2k))
    timed_ms("attention_long_bias_2048", lambda: fused_attention(q2k, kc2k, vc2k, bias2k),
             clocks=True)
    timed_ms("attention_long_bias_2048/sdpa", lambda: F.scaled_dot_product_attention(
        q2kt, kc2kt, vc2kt, attn_mask=bias2k))
    REPORT["attention_long_bias_2048_bound_ms"] = bound(
        nbytes(q2k, kc2k, vc2k, q2k, bias2k), 4 * 2 * BATCH_2048 * h * 16384 * l * d)
    del q2k, kc2k, vc2k, bias2k, q2kt, kc2kt, vc2kt
    timed_ms("attention_long_512", lambda: fused_attention(q5, k5, v5))
    timed_ms("attention_long_512/plain", lambda: transposed_attention_reference(q5, k5, v5))
    timed_ms("attention_long_512/sdpa", lambda: F.scaled_dot_product_attention(q5t, k5t, v5t))
    REPORT["attention_long_512_bound_ms"] = bound(
        nbytes(q5, k5, v5, q5), 4 * b2 * h * 1024 * 1024 * d
    )
    del got, q5, k5, v5, q5t, k5t, v5t
    qf, kf, vf = (rnd(1, 2048, 2, 72, dtype=torch.float32) for _ in range(3))
    kcf, vcf = rnd(1, 120, 2, 72, dtype=torch.float32), rnd(1, 120, 2, 72, dtype=torch.float32)
    biasf = key_padding_bias([60], l, -10000.0)
    compare("attention_long/fp32/self_1x2048x2x72", fused_attention(qf, kf, vf),
            transposed_attention_reference(qf, kf, vf), FP32_TOL)
    compare("attention_long/fp32/cross_1x2048_to_120_key_padding",
            fused_attention(qf, kcf, vcf, biasf),
            transposed_attention_reference(qf, kcf, vcf, biasf), FP32_TOL)

    q4t, k4t, v4t = (a.transpose(1, 2).contiguous() for a in (q4, k4, v4))
    kc4t, vc4t = (a.transpose(1, 2).contiguous() for a in (kc4, vc4))
    o4 = torch.empty_like(q4)
    b4_ms, by4 = bound(nbytes(q4, k4, v4, o4), 4 * b2_1024 * h * t4 * t4 * d)
    b5_ms, by5 = bound(nbytes(q4, kc4, vc4, o4, bias4.float()), 4 * b2_1024 * h * t4 * l * d)
    rows += [
        dict(name="attention_long", route="cuda",
             source="ecad_tpu_torch/csrc/attention_sm90.cu",
             replaces="ecad_tpu/ops/attention.py:344 (_transposed_kernel_nobias)",
             max_abs_err=err4,
             ms=timed_ms("attention_long", lambda: fused_attention(q4, k4, v4), reps=5,
                         clocks=True),
             plain_ms=timed_ms("attention_long/plain",
                               lambda: transposed_attention_reference(q4, k4, v4),
                               reps=3, inner=5),
             bound_ms=b4_ms, bound_by=by4,
             library_ms=timed_ms("attention_long/sdpa",
                                 lambda: F.scaled_dot_product_attention(q4t, k4t, v4t),
                                 reps=5)),
        dict(name="attention_long_bias", route="cuda",
             source="ecad_tpu_torch/csrc/attention_sm90.cu",
             replaces="ecad_tpu/ops/attention.py:285 (_transposed_kernel)",
             max_abs_err=err5,
             ms=timed_ms("attention_long_bias",
                         lambda: fused_attention(q4, kc4, vc4, bias4), clocks=True),
             plain_ms=timed_ms("attention_long_bias/plain",
                               lambda: transposed_attention_reference(q4, kc4, vc4, bias4)),
             bound_ms=b5_ms, bound_by=by5,
             library_ms=timed_ms("attention_long_bias/sdpa",
                                 lambda: F.scaled_dot_product_attention(
                                     q4t, kc4t, vc4t, attn_mask=bias4))),
    ]
    del q4t, k4t, v4t, kc4t, vc4t
    rows += flux_kernel_rows(rnd, bound, nbytes)
    rows += flash_kernel_rows(rnd, bound, nbytes)

    rows += k3_served_rows(rnd, bound, nbytes)
    for r in rows:
        r["clocks"] = REPORT["timing_ms"][r["name"]]["clocks"]
        out[r["name"]] = r
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library {r['library_ms']})")
    return out


def layer_norm_yardstick(segments):
    """The one PyTorch call that computes K3 on a batch-1 segment:
    ``F.layer_norm`` with weight 1 + scale and bias shift, made here,
    outside any timed window, in x's dtype (PyTorch on the card refuses
    fp32 ones beside bf16 x; bf16 rounds 1 + scale once more, by at most
    2^-9 of it); one call a segment."""
    import torch.nn.functional as F

    args = [(x, (1.0 + s.float()).reshape(-1).to(x.dtype), h.reshape(-1)) for x, s, h in segments]
    return lambda: [F.layer_norm(x, (x.shape[-1],), w, b, 1e-6) for x, w, b in args]


def k3_served_rows(rnd, bound, nbytes) -> list[dict]:
    """K3 at each served width (`K3_SERVED`) and FLUX-1024's pair (image and
    text streams of one dual-block site, one launch): checked against the
    plain version, timed against it, its byte bound (one read of x and the
    per-sample scale and shift, one write of the output, for every
    segment) and, on batch-1 rows, `layer_norm_yardstick`'s time, after its
    output is held to the plain version too. The pair's check is shown to
    reject a text segment computed with the image segment's scale."""
    from ecad_tpu_torch.ops import (
        launch_counts,
        modulated_layer_norm,
        modulated_layer_norm_pair,
        modulated_layer_norm_reference,
        reset_launch_counts,
    )

    def segment(bk, tk, dk):
        xk, mk = rnd(bk, tk, dk), rnd(bk, 6, dk) * 0.1
        return xk, mk[:, 1:2], mk[:, 0:1]  # strided views, as in the blocks

    cases = {name: (segment(*shape),) for name, shape in K3_SERVED.items()}
    cases["modlnorm_flux1024_pair"] = (
        segment(BATCH_FLUX_1024, 4096, 3072), segment(BATCH_FLUX_1024, 512, 3072))
    rows = []
    for name, segs in cases.items():
        if len(segs) == 1:
            kernel = lambda segs=segs: [modulated_layer_norm(*segs[0])]  # noqa: E731
        else:
            kernel = lambda segs=segs: list(modulated_layer_norm_pair(*segs))  # noqa: E731
        want = [modulated_layer_norm_reference(*sg) for sg in segs]
        reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        if launch_counts()["modlnorm"] != 1:
            raise AssertionError(f"{name}: {launch_counts()['modlnorm']} modlnorm launches, not 1")
        shape = "+".join("x".join(map(str, sg[0].shape)) for sg in segs)
        err = max(compare(f"modlnorm/bf16/{name}_{shape}/{i}", g, w, BF16_TOL)
                  for i, (g, w) in enumerate(zip(got, want)))
        if len(segs) == 2:
            x1, _, h1 = segs[1]
            rejects(f"{name}/text_with_the_image_scale",
                    modulated_layer_norm_reference(x1, segs[0][1], h1), want[1], BF16_TOL)
        library = None
        if all(sg[0].shape[0] == 1 for sg in segs):
            lib = layer_norm_yardstick(segs)
            for i, (g, w) in enumerate(zip(lib(), want)):
                compare(f"modlnorm/bf16/{name}_layer_norm/{i}", g, w, BF16_TOL)
            library = timed_ms(f"{name}/layer_norm", lib)
        del got, want
        b_ms, b_by = bound(nbytes(*(t for x, sc, sh in segs for t in (x, x, sc, sh))),
                           8 * sum(sg[0].numel() for sg in segs))
        rows.append(dict(
            name=name, route="cuda", source="ecad_tpu_torch/csrc/modlnorm_sm90.cu",
            replaces="ecad_tpu/ops/fused.py:20 (_modlnorm_kernel)", max_abs_err=err,
            ms=timed_ms(name, kernel, clocks=True),
            plain_ms=timed_ms(f"{name}/plain",
                              lambda segs=segs: [modulated_layer_norm_reference(*sg)
                                                 for sg in segs]),
            bound_ms=b_ms, bound_by=b_by, library_ms=library))
    return rows


def flux_kernel_rows(rnd, bound, nbytes) -> list[dict]:
    """FLUX's joint attention: the row-block clamp kernel (K5) at FLUX-1024's
    shape (1, 4608, 24, 128), with the tile-fault check at 4608 keys and
    its bias variant timed at the same shape; the exact kernel (K1) at
    FLUX-256's (4, 768, 24, 128), with the tile-fault check at 768 keys;
    each reached through the router, checked
    against its plain version and timed against it, one
    ``scaled_dot_product_attention`` call and its bound."""
    import torch.nn.functional as F

    from ecad_tpu_torch.ops import (
        fused_attention,
        fused_attention_reference,
        launch_counts,
        reset_launch_counts,
        rowblock_attention,
        rowblock_attention_reference,
    )

    h, d, t1024, t256 = 24, 128, 4608, 768
    q, k, v = (rnd(BATCH_FLUX_1024, t1024, h, d) for _ in range(3))
    qs, ks, vs = (rnd(BATCH_FLUX_256, t256, h, d) for _ in range(3))
    reset_launch_counts()
    got, got256 = fused_attention(q, k, v), fused_attention(qs, ks, vs)
    torch.cuda.synchronize()
    routed = launch_counts()
    if routed != {**dict.fromkeys(COUNTERS, 0), "attention_rowblock": 1, "attention": 1}:
        raise AssertionError(f"FLUX shapes did not route to K5 / K1: {routed}")
    want = rowblock_attention_reference(q, k, v)
    err5 = compare(f"attention_rowblock/bf16/flux1024_{BATCH_FLUX_1024}x4608x24x128",
                   got, want, clamp_bf16_tol)
    # the same check must fail a kernel that skips or repeats one key tile:
    # 64 keys (the mma.sync body's step) or 128 (the Hopper body's)
    for n in (64, 128):
        rejects(f"flux1024_drops_{n}_key_tile_1",
                rowblock_attention_reference(q, torch.cat((k[:, :n], k[:, 2 * n:]), 1),
                                             torch.cat((v[:, :n], v[:, 2 * n:]), 1)),
                want, clamp_bf16_tol)
        rejects(f"flux1024_repeats_{n}_key_tile_1",
                rowblock_attention_reference(q, torch.cat((k[:, :2 * n], k[:, n:]), 1),
                                             torch.cat((v[:, :2 * n], v[:, n:]), 1)),
                want, clamp_bf16_tol)
    del want, got
    want256 = fused_attention_reference(qs, ks, vs)
    err1 = compare(f"attention/bf16/flux256_{BATCH_FLUX_256}x768x24x128", got256,
                   want256, clamp_bf16_tol)
    # and one 128-key tile (the Hopper body's step) of K1's 768 keys
    rejects("flux256_drops_128_key_tile_1",
            fused_attention_reference(qs, torch.cat((ks[:, :128], ks[:, 256:]), 1),
                                      torch.cat((vs[:, :128], vs[:, 256:]), 1)),
            want256, clamp_bf16_tol)
    rejects("flux256_repeats_128_key_tile_1",
            fused_attention_reference(qs, torch.cat((ks[:, :256], ks[:, 128:]), 1),
                                      torch.cat((vs[:, :256], vs[:, 128:]), 1)),
            want256, clamp_bf16_tol)
    del want256
    # the bias variant at the served shape, with a key-padding bias
    bias = key_padding_bias([t1024 - 100] * BATCH_FLUX_1024, t1024, -1e9)
    err5b = compare("attention_rowblock_bias/bf16/flux1024_key_padding",
                    rowblock_attention(q, k, v, bias),
                    rowblock_attention_reference(q, k, v, bias), clamp_bf16_tol)

    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    o = torch.empty_like(q)
    b5, by5 = bound(nbytes(q, k, v, o), 4 * BATCH_FLUX_1024 * h * t1024 * t1024 * d)
    row5 = dict(
        name="attention_rowblock", route="cuda",
        source="ecad_tpu_torch/csrc/attention_sm90.cu",
        replaces="ecad_tpu/ops/attention.py:274 (_rowblock_kernel_nobias)",
        max_abs_err=err5,
        ms=timed_ms("attention_rowblock", lambda: fused_attention(q, k, v), reps=5,
                    clocks=True),
        plain_ms=timed_ms("attention_rowblock/plain",
                          lambda: rowblock_attention_reference(q, k, v), reps=3, inner=5),
        bound_ms=b5, bound_by=by5,
        library_ms=timed_ms("attention_rowblock/sdpa",
                            lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=5),
    )
    b5b, by5b = bound(nbytes(q, k, v, o, bias), 4 * BATCH_FLUX_1024 * h * t1024 * t1024 * d)
    row5b = dict(
        name="attention_rowblock_bias", route="cuda",
        source="ecad_tpu_torch/csrc/attention_sm90.cu",
        replaces="ecad_tpu/ops/attention.py:255 (_rowblock_kernel)",
        max_abs_err=err5b,
        ms=timed_ms("attention_rowblock_bias", lambda: rowblock_attention(q, k, v, bias),
                    reps=5, clocks=True),
        plain_ms=timed_ms("attention_rowblock_bias/plain",
                          lambda: rowblock_attention_reference(q, k, v, bias),
                          reps=3, inner=5),
        bound_ms=b5b, bound_by=by5b,
        library_ms=timed_ms("attention_rowblock_bias/sdpa",
                            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias),
                            reps=5),
    )
    del qt, kt, vt
    qst, kst, vst = (a.transpose(1, 2).contiguous() for a in (qs, ks, vs))
    b1, by1 = bound(nbytes(qs, ks, vs, qs), 4 * BATCH_FLUX_256 * h * t256 * t256 * d)
    # K1 again, at FLUX-256's head dim 128 (its own row: the `attention`
    # row holds PixArt-256's D=72)
    row1 = dict(
        name="attention_flux256", route="cuda",
        source="ecad_tpu_torch/csrc/attention_sm90.cu",
        replaces="ecad_tpu/ops/attention.py:58 (_attn_kernel)",
        max_abs_err=err1,
        ms=timed_ms("attention_flux256", lambda: fused_attention(qs, ks, vs), clocks=True),
        plain_ms=timed_ms("attention_flux256/plain",
                          lambda: fused_attention_reference(qs, ks, vs), reps=3, inner=5),
        bound_ms=b1, bound_by=by1,
        library_ms=timed_ms("attention_flux256/sdpa",
                            lambda: F.scaled_dot_product_attention(qst, kst, vst)),
    )
    return [row5, row5b, row1]


def flash_kernel_rows(rnd, bound, nbytes) -> list[dict]:
    """The streaming exact softmax (K6): at PixArt-2048's self-attention
    (2, 16384, 16, 72) and FLUX.1-dev-1536²'s joint attention (1, 9728, 24,
    128), both reached through the router, and in its key-padding variant
    at both shapes (lengths 15384 / 9000 at 2048², 9000 of 9728 keys at
    1536²), each run with the launch counters set to 0 just before and read
    just after (the rows' launches) and named by a profile
    (``attn_flash_sm90_kernel``); each checked against its plain version
    (run per slice) with `flash_bf16_tol`, which the run shows rejects a
    plain version that drops or repeats one 64-key tile (the mma.sync
    body's step) or one 128-key tile (the Hopper body's) of the 16384, and
    a 128-key tile of the 9728 and of each bias row's keys; timed against
    the plain version, one ``scaled_dot_product_attention`` call (with the
    bias as a float mask) and its bound."""
    import torch.nn.functional as F

    from ecad_tpu_torch.ops import (
        flash_attention_reference,
        fused_attention,
        launch_counts,
        reset_launch_counts,
    )

    t2k, t1536 = 16384, 9728
    q, k, v = (rnd(2 * BATCH_2048, t2k, 16, 72) for _ in range(3))
    qd, kd, vd = (rnd(1, t1536, 24, 128) for _ in range(3))
    bias = key_padding_bias([t2k - 1000, 9000], t2k, -1e9)
    bias_d = key_padding_bias([9000], t1536, -1e9)
    reset_launch_counts()
    got = fused_attention(q, k, v)
    got_d = fused_attention(qd, kd, vd)
    torch.cuda.synchronize()
    routed = launch_counts()
    if routed != {**dict.fromkeys(COUNTERS, 0), "attention_flash": 2}:
        raise AssertionError(f"2048²/1536² shapes did not route to K6: {routed}")
    # K6 with a bias, one path run each: the launches of its rows
    got_bias, launches = {}, REPORT.setdefault("flash_bias_launches", {})
    for name, args in (("attention_flash_bias", (q, k, v, bias)),
                       ("attention_flash_bias_d128", (qd, kd, vd, bias_d))):
        reset_launch_counts()
        got_bias[name] = fused_attention(*args)
        torch.cuda.synchronize()
        routed = launch_counts()
        if routed != {**dict.fromkeys(COUNTERS, 0), "attention_flash_bias": 1}:
            raise AssertionError(f"{name} did not route to K6 with a bias: {routed}")
        launches[name] = routed["attention_flash_bias"]
        kernels = device_kernel_names(lambda: fused_attention(*args))
        if not any("attn_flash_sm90_kernel" in n for n in kernels) or any(
                "attn_flash_bf16_kernel" in n for n in kernels):
            raise AssertionError(f"{name} ran {kernels}, not attn_flash_sm90_kernel")
        REPORT.setdefault("flash_bias_device_kernels", {})[name] = kernels

    def plain(q_, k_, v_, b_=None):
        return by_slices(flash_attention_reference, q_, k_, v_, b_)

    def tile_faults(name, want, q_, k_, v_, b_=None, sizes=(128,)):
        # the same check must fail a kernel that skips or repeats one key
        # tile: 64 keys (the mma.sync body's step) or 128 (the Hopper body's)
        for n in sizes:
            tag = "" if n == 64 else f"{n}_"
            cut = (lambda x: torch.cat((x[:, :n], x[:, 2 * n:]), 1),
                   lambda x: torch.cat((x[:, :2 * n], x[:, n:]), 1))
            for fault, f in zip(("drops", "repeats"), cut):
                bf = None if b_ is None else f(b_.transpose(1, 3)).transpose(1, 3)
                rejects(f"{name}_{fault}_{tag}key_tile_1", plain(q_, f(k_), f(v_), bf), want,
                        flash_bf16_tol)

    want = plain(q, k, v)
    REPORT["flash_out_std"] = float(want.float().std())
    err = compare(f"attention_flash/bf16/pixart2048_self_{2 * BATCH_2048}x16384x16x72",
                  got, want, flash_bf16_tol)
    tile_faults("pixart2048", want, q, k, v, sizes=(64, 128))
    del want, got
    want = plain(q, k, v, bias)
    err_b = compare("attention_flash_bias/bf16/pixart2048_key_padding_15384_9000",
                    got_bias["attention_flash_bias"], want, flash_bf16_tol)
    tile_faults("pixart2048_key_padding", want, q, k, v, bias)
    del want
    want_d = plain(qd, kd, vd)
    err_d = compare("attention_flash/bf16/flux1536_1x9728x24x128", got_d, want_d,
                    flash_bf16_tol)
    # and a 128-key tile, the Hopper body's step, at the 9728 keys it serves
    tile_faults("flux1536", want_d, qd, kd, vd)
    del got_d, want_d
    want_d = plain(qd, kd, vd, bias_d)
    err_db = compare("attention_flash_bias/bf16/flux1536_key_padding_9000",
                     got_bias["attention_flash_bias_d128"], want_d, flash_bf16_tol)
    tile_faults("flux1536_key_padding", want_d, qd, kd, vd, bias_d)
    del want_d, got_bias

    o, od = torch.empty_like(q), torch.empty_like(qd)
    flops, flops_d = 4 * q.shape[0] * 16 * t2k * t2k * 72, 4 * 24 * t1536 * t1536 * 128
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    qdt, kdt, vdt = (a.transpose(1, 2).contiguous() for a in (qd, kd, vd))
    common = dict(route="cuda", replaces="ecad_tpu/ops/attention.py:151 (_flash_kernel)",
                  source="ecad_tpu_torch/csrc/attention_sm90.cu")
    rows = []
    for name, max_err, args, (bnd, by), sdpa in (
        ("attention_flash", err, (q, k, v), bound(nbytes(q, k, v, o), flops),
         lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        ("attention_flash_bias", err_b, (q, k, v, bias), bound(nbytes(q, k, v, o, bias), flops),
         lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)),
        ("attention_flash_d128", err_d, (qd, kd, vd), bound(nbytes(qd, kd, vd, od), flops_d),
         lambda: F.scaled_dot_product_attention(qdt, kdt, vdt)),
        ("attention_flash_bias_d128", err_db, (qd, kd, vd, bias_d),
         bound(nbytes(qd, kd, vd, od, bias_d), flops_d),
         lambda: F.scaled_dot_product_attention(qdt, kdt, vdt, attn_mask=bias_d)),
    ):
        rows.append(dict(
            name=name, **common, max_abs_err=max_err,
            ms=timed_ms(name, lambda: fused_attention(*args), reps=5, inner=5, clocks=True),
            plain_ms=timed_ms(f"{name}/plain", lambda: plain(*args), reps=3, inner=2),
            bound_ms=bnd, bound_by=by,
            library_ms=timed_ms(f"{name}/sdpa", sdpa, reps=5, inner=5),
        ))
    return rows


# ---------------------------------------------------------------------------
# the attention-variant harness (X1-X4)
# ---------------------------------------------------------------------------

# kernel counter → (plain version's name in ecad_tpu_torch.ops, the Pallas
# bodies it replaces in scripts/exp_attn_variants.py, its bf16 tolerance).
# The shares are twice the largest least atol per std that the kernel
# needed on the H100 at the harness's shapes, rounded up (the report's
# `least_atol_per_std`): X1 0.0011 (its output is unnormalised, ≈ 10³, and
# a flipped bf16 rounding of one s moves it by ≈ 0.06), X2 and X4 0.0051
# (only sum orders differ), X3 0.0106 (p rounded against a running max, as
# K6: 0.0117), measured on csrc/attention.cu; on the Hopper body X2 needs
# 0.0051, X3 0.0104 (128-key tiles) and X4 0.0051; K4 keeps its own rule.
# The run shows each one rejects a dropped and a repeated 64-key tile at
# 4096 keys, and X1 (on the Hopper body since X1's 0.0011 was measured) a
# dropped and a repeated 128-key one.
XATTN = {
    "xattn_matmul_only": ("matmul_only_attention", ":103 (k_matmul_only)",
                          std_bf16_tol(0.0025)),
    "xattn_nomax": ("nomax_attention", ":115 (k_nomax)", std_bf16_tol(0.011)),
    "xattn_max": ("max_exp2_attention", ":129 (k_rowblock; :144 k_chunk2)",
                  std_bf16_tol(0.025)),
    "xattn_fd": ("clamp_fd_attention",
                 ":288 (k_transposed_fd; :349 k_transposed_subk_fd)", std_bf16_tol(0.011)),
    "attention_long": ("transposed_attention", ":190 (k_transposed; :317 k_transposed_subk)",
                       clamp_bf16_tol),
}


# the harness's kernels on the Hopper body (csrc/attention_sm90.cu) at its
# head dims, by counter: the device kernel each must launch
SM90_XATTN = {"xattn_matmul_only": "attn_xmatmul_sm90_kernel",
              "xattn_nomax": "attn_xnomax_sm90_kernel", "xattn_max": "attn_xmax_sm90_kernel",
              "xattn_fd": "attn_xfd_sm90_kernel"}


def device_kernel_names(fn) -> list[str]:
    """The device kernels that a call of `fn` launches, from torch.profiler.
    `fn` runs once before the profile, so that each of its kernels is
    loaded before it is traced (a profile of the first call of X1's kernel
    in the process named only X2's and X3's), and twice inside it: a
    profile taken after two earlier ones was seen to miss the first kernel
    it traced (X2's, ahead of X3's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def by_head_pairs(plain, q, k, v) -> torch.Tensor:
    """A plain version run two heads at a time, so that its fp32 scores stay
    near 1 GB at the harness's shapes (8.6 GB for all 16 heads of
    (8, 4096, 16, 72))."""
    out = torch.empty_like(q)
    for h in range(0, q.shape[2], 2):
        sl = (slice(None), slice(None), slice(h, h + 2))
        out[sl] = plain(q[sl], k[sl], v[sl])
    return out


def variants_phase() -> dict:
    """The port of the attention-variant harness at its full shapes: each
    of X1-X4 (and K4 in its ``transposed`` rows) held against its plain
    version on a 2-head slice at every harness shape; the tolerance shown
    to reject a dropped or repeated 64-key tile at 4096 keys (X1: a 128-key
    one too); X1-X4 on the Hopper body's kernels by name (a profile of one
    call each); X2's inf/NaN where its plain version has them; the Tk % 128
    rule on the card, in the wrappers and in the Hopper body's C entry (X4
    takes any Tk), and the head dims and dtype X1-X4 refuse; the
    harness's ``main`` once per shape with the launch
    counters set to 0 just before and read just after; timings of each
    kernel's plain version (two heads at a time) and one
    ``scaled_dot_product_attention`` call per shape (X1: its two cuBLAS
    products instead). Returns the rows of the ``kernels`` line."""
    import torch.nn.functional as F

    import ecad_tpu_torch.ops as ops
    from ecad_tpu_torch.scripts import exp_attn_variants as harness
    from ecad_tpu_torch.utils.timing import bound_ms

    log("variants phase: the attention-variant harness (X1-X4)")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def kernel(counter):
        return getattr(ops, XATTN[counter][0])

    def plain(counter):
        return getattr(ops, XATTN[counter][0] + "_reference")

    def counters(d):
        return [c for c in XATTN if d % 128 or c not in ("xattn_fd", "attention_long")]

    # parity at each shape, kernel on the whole tensor, plain on 2 heads
    errs = {}
    for shape, s in harness.SHAPES.items():
        q, k, v = (rnd(s["b"], s["t"], s["h"], s["d"]) for _ in range(3))
        q2, k2, v2 = (a[:, :, :2] for a in (q, k, v))
        # X1, X2 and X3 launch the Hopper body's kernels at every shape, X4
        # at D=72
        on_sm90 = {c: n for c, n in SM90_XATTN.items() if c in counters(s["d"])}
        names = device_kernel_names(lambda: [kernel(c)(q, k, v) for c in on_sm90])
        for c, name in on_sm90.items():
            if not any(name in n for n in names):
                raise AssertionError(f"{c} at {shape} ran {names}, not {name}")
        if any("_bf16_kernel" in n for n in names):
            raise AssertionError(f"X1-X4 at {shape} reached csrc/attention.cu: {names}")
        REPORT.setdefault("xattn_device_kernels", {})[shape] = names
        for c in counters(s["d"]):
            want = plain(c)(q2, k2, v2)
            errs[c, shape] = compare(f"{c}/bf16/{shape}", kernel(c)(q, k, v)[:, :, :2],
                                     want, XATTN[c][2])
            if shape == "pixart1024" and c != "attention_long":
                # the same check must fail a plain version that drops or
                # repeats one 64-key tile of the 4096 (the mma.sync body's
                # step) and, for X1, one 128-key tile (the Hopper body's)
                for n in (64, 128) if c == "xattn_matmul_only" else (64,):
                    tag = "" if n == 64 else f"{n}_"
                    faults = {"drops": lambda a: torch.cat((a[:, :n], a[:, 2 * n:]), 1),
                              "repeats": lambda a: torch.cat((a[:, :2 * n], a[:, n:]), 1)}
                    for fault, cut in faults.items():
                        rejects(f"{c}/{shape}_{fault}_{tag}key_tile_1",
                                plain(c)(q2, cut(k2), cut(v2)), want, XATTN[c][2])
        del q, k, v, q2, k2, v2, want

    # limits: X2 overflows where its plain version does (q×64 on every
    # other row at D=128 puts s far past 128 there, and near 6 elsewhere)
    q, k, v = rnd(1, 1024, 2, 128), rnd(1, 1024, 2, 128), rnd(1, 1024, 2, 128)
    q[:, ::2] *= 64
    got, want = ops.nomax_attention(q, k, v), ops.nomax_attention_reference(q, k, v)
    finite, want_finite = torch.isfinite(got), torch.isfinite(want)
    REPORT["xattn_nomax_overflow"] = {"non_finite": int((~finite).sum()),
                                      "of": finite.numel()}
    if not (torch.equal(finite, want_finite) and 0 < int(finite.sum()) < finite.numel()):
        raise AssertionError("xattn_nomax: inf/NaN positions differ from the plain version's")
    compare("xattn_nomax/bf16/finite_rows_of_q_times_64", got[:, 1::2], want[:, 1::2],
            XATTN["xattn_nomax"][2])
    log(f"  xattn_nomax: {int((~finite).sum())} of {finite.numel()} outputs non-finite"
        " at q×64, at the plain version's positions")
    # Tk % 128 != 0: refused by X1-X3 and the harness's K4 rows; X4 masks
    q, k, v = rnd(2, 256, 2, 72), rnd(2, 200, 2, 72), rnd(2, 200, 2, 72)
    for name, fn in (("matmul_only_attention", ops.matmul_only_attention),
                     ("nomax_attention", ops.nomax_attention),
                     ("max_exp2_attention", ops.max_exp2_attention),
                     ("harness transposed", harness.TRANSPOSED["transposed"]),
                     ("harness transposed_subk", harness.TRANSPOSED["transposed_subk"])):
        try:
            fn(q, k, v)
        except ValueError:
            continue
        raise AssertionError(f"{name} accepted Tk=200")
    # the C entry of the Hopper body refuses it too in X1's, X2's and X3's
    # modes
    from ecad_tpu_torch.ops import attention as A
    for c in ("xattn_matmul_only", "xattn_nomax", "xattn_max"):
        try:
            A._launch_sm90(q, k, v, c)
        except RuntimeError as err:
            if "status 1 " not in str(err):  # cudaErrorInvalidValue
                raise
            continue
        raise AssertionError(f"the Hopper body's {c} mode accepted Tk=200")
    for name, fn in (("matmul_only_attention", ops.matmul_only_attention),
                     ("nomax_attention", ops.nomax_attention)):
        try:
            fn(q.float(), q.float(), q.float())
        except TypeError:
            continue
        raise AssertionError(f"{name} accepted fp32 on the card")
    # X1-X4 run only on the Hopper body, which takes head dims 72 and 128
    # (X4 72 only)
    q80 = rnd(1, 256, 2, 80)
    for name, fn in (("matmul_only_attention", ops.matmul_only_attention),
                     ("nomax_attention", ops.nomax_attention),
                     ("max_exp2_attention", ops.max_exp2_attention),
                     ("clamp_fd_attention", ops.clamp_fd_attention)):
        try:
            fn(q80, q80, q80)
        except ValueError:
            continue
        raise AssertionError(f"{name} accepted head dim 80")
    compare("xattn_fd/bf16/tq256_tk200_d72", ops.clamp_fd_attention(q, k, v),
            ops.clamp_fd_attention_reference(q, k, v), XATTN["xattn_fd"][2])
    del q, k, v, q80, got, want

    # the harness through its main, one shape at a time
    harness_rows, launches = {}, {}
    for shape, s in harness.SHAPES.items():
        ops.reset_launch_counts()
        rows = harness.main([f"--shape={shape}"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        calls = Counter()
        for row in rows:
            calls[row["detail"]["kernel_counter"]] += row["detail"]["calls"]
            if not (row["value"] > 0 and (row["metric"].endswith("matmul_only")
                                          or row["detail"]["max_abs_err_vs_plain_bf16"] < 1)):
                raise AssertionError(f"harness row {row}")
            harness_rows[row["metric"]] = row
        if len(rows) != len(harness.rows_of(s["d"])) or counts != {
                **dict.fromkeys(COUNTERS, 0), **calls}:
            raise AssertionError(f"harness at {shape}: {len(rows)} rows, launches {counts}"
                                 f" against its calls {dict(calls)}")
        launches[shape] = counts
    if len(harness_rows) != 20:
        raise AssertionError(f"the harness printed {len(harness_rows)} rows, not 20")
    REPORT["harness"] = harness_rows

    # timings and the kernels line's rows
    label = {"xattn_matmul_only": "matmul_only", "xattn_nomax": "nomax",
             "xattn_max": "rowblock", "xattn_fd": "transposed_fd",
             "attention_long": "transposed"}
    out = {}
    for shape, s in harness.SHAPES.items():
        b, h, t, d = s["b"], s["h"], s["t"], s["d"]
        q, k, v = (rnd(b, t, h, d) for _ in range(3))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa = timed_ms(f"xattn/{shape}/sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        reps=5, inner=5)
        # X1's yardstick: its function as two cuBLAS products, S = q·kᵀ
        # rounded once to bf16 and written to device memory, then S·v (in
        # the (B, H, T, D) layout); two calls, so not `library_ms`
        two_call = timed_ms(f"xattn_matmul_only_{shape}/two_call",
                            lambda: (qt @ kt.transpose(-1, -2)) @ vt, reps=5, inner=5)
        got2 = ((qt[:, :2] @ kt[:, :2].transpose(-1, -2)) @ vt[:, :2]).transpose(1, 2)
        _, err2, least2, _ = beyond(got2, plain("xattn_matmul_only")(
            q[:, :, :2], k[:, :, :2], v[:, :, :2]), XATTN["xattn_matmul_only"][2])
        REPORT.setdefault("xattn_two_call_vs_plain", {})[shape] = {
            "max_abs_err": err2, "least_atol_per_std": least2}
        del qt, kt, vt, got2
        bnd, by = bound_ms(4 * q.numel() * q.element_size(), 4 * b * h * t * t * d)
        for c in counters(d):
            out[f"{c}_{shape}"] = dict(
                name=f"{c}_{shape}", route="cuda",
                source="ecad_tpu_torch/csrc/attention_sm90.cu",
                replaces="scripts/exp_attn_variants.py" + XATTN[c][1],
                launches=launches[shape][c], max_abs_err=errs[c, shape],
                ms=harness_rows[f"exp_{shape}_{label[c]}"]["value"],
                plain_ms=timed_ms(f"{c}_{shape}/plain",
                                  lambda: by_head_pairs(plain(c), q, k, v), reps=3, inner=1),
                bound_ms=bnd, bound_by=by,
                # bf16(q·kᵀ)·v unnormalised has no one-call PyTorch counterpart
                library_ms=None if c == "xattn_matmul_only" else sdpa,
                **({"two_call_ms": two_call} if c == "xattn_matmul_only" else {}),
            )
        del q, k, v
    for r in out.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA {r['library_ms']}, two calls "
            f"{r.get('two_call_ms')}), {r['launches']} launches in the harness run")
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


# the kernels of PixArt's self- and cross-attention at each image side: the
# exact kernels (K1/K2) at 256², the clamp kernel (K4) in both of its
# variants at 1024², the streaming kernel (K6) and K4's bias variant at
# 2048² (16384 → 120 keys is an 8 MiB score tile: the clamp route)
ATTENTION_KERNELS = {
    256: ("attention", "attention_bias"),
    1024: ("attention_long", "attention_long_bias"),
    2048: ("attention_flash", "attention_long_bias"),
}
# the device kernel under each attention family of a served path's profile:
# bf16 self-attention without a bias runs on the Hopper body
# (csrc/attention_sm90.cu) at every side, and so does the cross-attention
# with its text bias: K2 at 256², K4 with a bias at 1024² and 2048² (the
# profile files the bias forms apart by their template flag); every
# modulated norm runs csrc/modlnorm_sm90.cu
SERVED_KERNELS = {
    "pixart256": {"attention": "attn_exact_sm90_kernel",
                  "attention_bias": "attn_exact_sm90_kernel"},
    "pixart1024": {"attention_long": "attn_clamp_sm90_kernel",
                   "attention_long_bias": "attn_clamp_sm90_kernel"},
    "pixart2048": {"attention_flash": "attn_flash_sm90_kernel",
                   "attention_long_bias": "attn_clamp_sm90_kernel"},
    "flux256": {"attention": "attn_exact_sm90_kernel"},
    "flux1024": {"attention_rowblock": "attn_rowblock_sm90_kernel"},
    "flux1536": {"attention_flash": "attn_flash_sm90_kernel"},
}
for _kernels in SERVED_KERNELS.values():
    _kernels["modlnorm"] = "modlnorm_sm90_kernel"


def expected_counts(masks, side: int = 256, quant=None) -> dict[str, int]:
    """Launches per trajectory that a schedule's masks imply: one
    self-attention per recomputed attn1, one cross-attention per attn2 (in
    the kernels of ATTENTION_KERNELS[side]), one modlnorm per attn1 and ff
    and one per step for the final norm; under a `quant` mode the int8
    products of `pixart_int8_products`."""
    arr = np.array(masks, dtype=bool)  # (steps, blocks, 3), step 0 forced
    self_kernel, cross_kernel = ATTENTION_KERNELS[side]
    return {
        **dict.fromkeys(COUNTERS, 0),
        self_kernel: int(arr[..., 0].sum()),
        cross_kernel: int(arr[..., 1].sum()),
        "modlnorm": int(arr[..., 0].sum() + arr[..., 2].sum()) + arr.shape[0],
        "int8_matmul": pixart_int8_products(arr) if quant else 0,
    }


def pixart_int8_products(masks) -> int:
    """The int8 products of one PixArt trajectory under a quant mode: four
    per recomputed attn1 (q, k, v, out), two per attn2 (q, out: its k and v
    are computed once a trajectory, two per block, from the text) and two
    per ff (in, out)."""
    arr = np.array(masks, dtype=bool)
    return int(4 * arr[..., 0].sum() + 2 * arr[..., 1].sum() + 2 * arr[..., 2].sum()
               + 2 * arr.shape[1])


def flux_int8_products(masks, num_blocks: int, quant) -> int:
    """The int8 products of one FLUX trajectory under a quant mode: eight per
    recomputed full_attn (q, k, v and out of each stream), two per full_ff
    and per full_ff_context, three per single_attn (q, k, v), one per
    single_proj_mlp and per single_proj_out; in the weight-storage modes
    also every adaLN linear at every step (two a dual block, one a single
    block), recomputed or not: the gates need them."""
    arr = np.array(masks, dtype=bool)  # (steps, blocks + single blocks, 3)
    full, single = arr[:, :num_blocks], arr[:, num_blocks:]
    n = int(8 * full[..., 0].sum() + 2 * full[..., 1].sum() + 2 * full[..., 2].sum()
            + 3 * single[..., 0].sum() + single[..., 1].sum() + single[..., 2].sum())
    if quant in WEIGHT_MODES:
        n += arr.shape[0] * (2 * num_blocks + single.shape[1])
    return n


def flux_expected_counts(masks, num_blocks: int, attention: str,
                         quant=None) -> dict[str, int]:
    """Launches per FLUX trajectory that a schedule's masks imply: one joint
    attention per recomputed full_attn or single_attn on the counter
    `attention` of its route (FLUX-256's 768 tokens: the exact kernel K1,
    ``attention``; FLUX-1024's 4608: the row-block clamp kernel K5,
    ``attention_rowblock``; FLUX-1536's 9728: the streaming kernel K6,
    ``attention_flash``); one modlnorm for both streams of a recomputed
    full_attn, one for full_ff with full_ff_context when both are
    recomputed and one for either alone, one per single block whose
    attention or MLP projection is recomputed (they share its norm), and
    one per step for the final norm; under a `quant` mode the int8
    products of `flux_int8_products`."""
    arr = np.array(masks, dtype=bool)  # (steps, blocks + single blocks, 3)
    full, single = arr[:, :num_blocks], arr[:, num_blocks:]
    attn = int(full[..., 0].sum() + single[..., 0].sum())
    return {
        **dict.fromkeys(COUNTERS, 0),
        attention: attn,
        "modlnorm": sum(flux_modlnorm_streams(masks, num_blocks).values()),
        "int8_matmul": flux_int8_products(masks, num_blocks, quant) if quant else 0,
    }


def flux_modlnorm_streams(masks, num_blocks: int) -> dict[str, int]:
    """The modlnorm launches of `flux_expected_counts` by what they
    normalise: both dual-block streams in one launch (``pair``: a
    recomputed full_attn's norms, and full_ff's with full_ff_context's when
    both are recomputed), the image stream alone (full_ff's norm when
    full_ff_context is cached, and the final norm), the text stream alone
    (full_ff_context's when full_ff is cached) and the joint one (a single
    block's)."""
    arr = np.array(masks, dtype=bool)  # (steps, blocks + single blocks, 3)
    full, single = arr[:, :num_blocks], arr[:, num_blocks:]
    ff, ffc = full[..., 1], full[..., 2]
    return {"pair": int(full[..., 0].sum() + (ff & ffc).sum()),
            "img": int((ff & ~ffc).sum()) + arr.shape[0],
            "txt": int((ffc & ~ff).sum()),
            "joint": int((single[..., 0] | single[..., 1]).sum())}


# the launch counter of each route of `fused_attention` (`attention_route`)
ROUTE_COUNTERS = {"exact": "attention", "exact_xla": "attention", "clamp": "attention_long",
                  "rowblock": "attention_rowblock", "flash": "attention_flash"}


def attention_counter(q_shape: tuple, tk: int, bias=None) -> str:
    """The launch counter a `fused_attention` call of these shapes counts
    under: its route's (`attention_route`), ``_bias`` when it has a bias."""
    from ecad_tpu_torch.ops import attention_route

    name = ROUTE_COUNTERS[attention_route(tuple(q_shape), tk, bias)]
    return name if bias is None else name + "_bias"


def search_expected_counts(mask_arrays, config, batch: int,
                           text_mask: bool = False) -> dict[str, int]:
    """Launches of PixArt denoise calls, one (steps, blocks, 3) step-0-forced
    mask array per call (on the search path each evaluated candidate's, and
    each run's uncached reference trajectory's), each attention under the
    counter of its route (`attention_counter`). The evaluator passes no
    text mask (as the reference's does), so there the cross-attention
    counts without a bias — at PixArt-256's 256 queries → 120 keys the
    exact single-tile route, K1 (``attention``), not K2; the benchmark
    tier's embeddings carry masks (``text_mask``), so its cross-attention
    counts with the key-padding bias — K2 (``attention_bias``) there."""
    shape = (2 * batch, config.tokens, config.num_heads, config.head_dim)
    self_kernel = attention_counter(shape, config.tokens)
    bias = torch.zeros(2 * batch, 1, 1, config.text_len) if text_mask else None
    cross_kernel = attention_counter(shape, config.text_len, bias)
    total = Counter(dict.fromkeys(COUNTERS, 0))
    for arr in mask_arrays:
        arr = np.asarray(arr, dtype=bool)
        total[self_kernel] += int(arr[..., 0].sum())
        total[cross_kernel] += int(arr[..., 1].sum())
        total["modlnorm"] += int(arr[..., 0].sum() + arr[..., 2].sum()) + arr.shape[0]
    return dict(total)


def sum_counts(counts) -> dict[str, int]:
    """The launch counts of several runs added up, key by key."""
    total = Counter(dict.fromkeys(COUNTERS, 0))
    for c in counts:
        total.update(c)
    return dict(total)


def small_reference_check(side: int = 256) -> dict:
    """A tiny fp32 trajectory through the kernels on the card against the
    same weights and noise through the plain versions on the CPU.

    side=256: PixArt-256 style (64 tokens, exact-softmax kernels), 20
    steps that reuse attn2 and ff on odd steps. side=1024: 1024 style —
    the size conditions (dim 96, a multiple of 3), a 96×96 latent (2304
    tokens, so self-attention and the 2304→8 cross-attention both take the
    clamp kernel) and TGATE gating at step 4 of 8. side=2048: a 184×184
    latent (8464 tokens: past 8192 keys, so self-attention takes the
    streaming kernel K6, and the 8464→8 cross-attention the clamp kernel),
    two heads of 32, one prompt (2B=2, to keep the CPU's plain attention
    at 1.1 GB of scores), 4 steps."""
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines import (
        PixArtPipeline,
        PixArtPipelineConfig,
        TGATEPixArtPipeline,
    )
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    batch = 2
    if side == 1024:
        cfg = PixArtConfig.tiny(dtype=torch.float32, dim=96, sample_size=96,
                                use_additional_conditions=True)
        steps, cls, kwargs = 8, TGATEPixArtPipeline, {"gate_step": 4}
    elif side == 2048:
        cfg = PixArtConfig.tiny(dtype=torch.float32, num_heads=2, head_dim=32,
                                sample_size=184)
        steps, cls, kwargs, batch = 4, PixArtPipeline, {}, 1
    else:
        cfg = PixArtConfig.tiny(dtype=torch.float32)
        steps, cls, kwargs = STEPS, PixArtPipeline, {}
    cpu_model = init_model(cfg, 3, "cpu")
    gpu_model = init_model(cfg, 3, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    arr = np.ones((steps, cfg.num_blocks, 3), dtype=bool)
    # reuse attn2 and ff on odd steps (before the gate: TGATE recomputes ff after it)
    arr[1:kwargs.get("gate_step", steps):2, :, 1:] = False
    sched = PixArtCacheSchedule.from_numpy(arr.reshape(steps, -1), steps, cfg.num_blocks)
    rng = np.random.default_rng(0)
    latent = cfg.sample_size
    noise = torch.from_numpy(
        rng.standard_normal((batch, latent, latent, 4), dtype=np.float32))
    text = torch.from_numpy(rng.standard_normal((batch, 8, 32), dtype=np.float32))
    neg = torch.from_numpy(rng.standard_normal((batch, 8, 32), dtype=np.float32))
    tm = torch.tensor([[1] * 5 + [0] * 3, [1] * 8])[:batch]
    nm = torch.tensor([[1] + [0] * 7] * batch)
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        pipe = cls(PixArtPipelineConfig(cfg, steps), model, sched, **kwargs)
        args = [a.to(dev) for a in (noise, text, neg, tm, nm)]
        reset_launch_counts()
        outs.append(pipe.denoise(*args).cpu())
    counts = launch_counts()
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[0].abs().max())
    label = {256: "256-style", 1024: "1024-style (size conditions, TGATE)",
             2048: "2048-style (8464 tokens, streaming route)"}[side]
    log(f"  tiny fp32 {label} trajectory, card kernels vs CPU plain: max err "
        f"{err:.3g} of max |latent| {scale:.3g}; card launches {counts}")
    if not all(counts[k] > 0 for k in (*ATTENTION_KERNELS[side], "modlnorm")):
        raise AssertionError(f"tiny {label} trajectory missed a kernel: {counts}")
    # fp32 throughout (TF32 off). 256-style: 20 steps of CFG 4.5 amplify
    # per-step rounding differences of ~1e-6 on O(1) latents to ~1e-4.
    # 1024- and 2048-style: random-weight latents grow to O(100s) (x0 =
    # x/α), so the bound is relative to the largest one.
    limit = 1e-3 if side == 256 else 1e-5 * scale
    if not err <= limit:
        raise AssertionError(f"tiny {label} trajectory mismatch {err} > {limit}")
    return {"max_err": err, "max_abs_latent": scale, "launches": counts}


def kernel_family(name: str) -> str:
    """Family of a device kernel, from its (mangled or demangled) name."""
    for kernel, family in (("attn_rowblock_sm90_kernel", "attention_rowblock"),
                           ("attn_flash_sm90_kernel", "attention_flash"),
                           ("attn_exact_sm90_kernel", "attention"),
                           ("attn_clamp_sm90_kernel", "attention_long"),
                           ("attn_clamp_bf16_kernel", "attention_long"),
                           ("attn_rowblock_bf16_kernel", "attention_rowblock"),
                           ("attn_flash_bf16_kernel", "attention_flash"),
                           ("attn_bf16_kernel", "attention")):
        if kernel in name:
            biased = "true>" in name or "ELb1E" in name
            return family + "_bias" if biased else family
    if "modlnorm_sm90_kernel" in name:
        return "modlnorm"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "gemm"
    if any(k in low for k in ("conv", "cudnn", "implicit", "winograd")):
        return "conv"
    return "other"


# the profiler ranges ops/quant.py opens around its quantize pass, its
# product and its dequant pass; on the device timeline each shows as an
# annotation spanning the range's kernels, not as a kernel
QUANT_SPANS = ("int8_quantize", "int8_gemm", "int8_dequant")


def quant_split(prof) -> dict:
    """Device ms of a profiled run by part: the kernels that start inside a
    `QUANT_SPANS` range's device annotation (one stream, so the kernels of
    a range run between its first and last) count for that range, every
    other kernel by `kernel_family` (``gemm`` then is the bf16 GEMMs,
    ``other`` the rest of the elementwise work); the quant parts also by
    kernel name. Each device kernel counts once."""
    import bisect

    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in device if e.name in QUANT_SPANS)
    starts = [r[0] for r in ranges]
    ms, names = Counter(), {}
    for evt in device:
        if evt.name in QUANT_SPANS:
            continue
        t = evt.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        part = ranges[i][2] if i >= 0 and t < ranges[i][1] else None
        us = evt.time_range.elapsed_us()
        ms[part or kernel_family(evt.name)] += us / 1e3
        if part:
            names.setdefault(part, Counter())[evt.name[:100]] += us / 1e3
    return {"device_ms": dict(ms), "total_ms": sum(ms.values()), "ranges": len(ranges),
            "kernels": {p: dict(c.most_common(8)) for p, c in names.items()}}


def profile_trajectory(fn, wall_ms: float, split: bool = False) -> dict:
    """Device time of one trajectory (denoise + decode) by kernel family,
    from torch.profiler, and the device's busy share of the unprofiled
    wall time `wall_ms` of the same work; with `split`, also `quant_split`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams = dict.fromkeys((*COUNTERS, "gemm", "conv", "other"), 0.0)
    names = {}  # the device kernels of each of the port's families
    launches = 0
    host_ops, other = [], []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            host_ops.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key))
            continue
        if evt.key in QUANT_SPANS:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        launches += evt.count
        family = kernel_family(evt.key)
        fams[family] += us / 1e3
        if family in COUNTERS:
            names.setdefault(family, []).append(evt.key[:100])
        if family == "other":
            other.append((us / 1e3, evt.count, evt.key[:120]))
    busy = sum(fams.values())
    host_ops.sort(reverse=True)
    other.sort(reverse=True)
    return {
        **({"split": quant_split(prof)} if split else {}),
        "device_ms": fams,
        "busy_ms": busy,
        "wall_ms": wall_ms,
        "idle_share": 1.0 - busy / wall_ms,
        "kernel_launches": launches,
        "kernels": names,
        # the largest kernels of the elementwise family, by device ms
        "other_top": [{"kernel": k, "calls": n, "device_ms": ms} for ms, n, k in other[:12]],
        # host ops by self CPU ms under the profiler (inflated by it), with calls
        "host_ops_top": [
            {"op": k, "calls": n, "self_cpu_ms_profiled": ms}
            for ms, n, k in host_ops[:15]
        ],
    }


def path_inputs(config, batch: int) -> dict:
    """Seeded bf16 text, negative and noise on the card; text masks of
    random lengths 7..120 and a one-token negative mask."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape_t = (batch, config.text_len, config.caption_dim)
    text = torch.randn(shape_t, generator=gen, device="cuda").to(config.dtype)
    neg = torch.randn(shape_t, generator=gen, device="cuda").to(config.dtype)
    noise = torch.randn(
        (batch, config.sample_size, config.sample_size, config.in_channels),
        generator=gen, device="cuda",
    ).to(config.dtype)
    lengths = torch.randint(7, config.text_len + 1, (batch,), generator=gen, device="cuda")
    text_mask = (torch.arange(config.text_len, device="cuda")[None] < lengths[:, None]).int()
    neg_mask = torch.zeros_like(text_mask)
    neg_mask[:, 0] = 1  # the empty negative prompt keeps one token
    return dict(noise=noise, text=text, neg=neg, text_mask=text_mask, neg_mask=neg_mask)


def drive(pipes: dict, inputs: dict, decode, batch: int, side: int, want_counts,
          order: tuple, kernels: dict, latents_out: dict | None = None,
          profiled: tuple | None = None) -> dict:
    """Each pipeline once with the launch counters set to 0 just before and
    read just after (checked against `want_counts(pipe)`, with the image
    shape and finite latents; each run's latents kept in `latents_out`);
    then ms/img from synchronized runs taken in `order`; then one profiled
    run of each (of those named in `profiled`, if given), whose profile
    must show, for each family of `kernels`, the device kernel named there.
    `decode` turns a trajectory's latents into uint8 images on the card."""
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts

    def run(pipe):
        latents = pipe.denoise(**inputs)
        return latents, decode(latents)

    torch.cuda.reset_peak_memory_stats()
    result = {}
    for name, pipe in pipes.items():
        reset_launch_counts()
        latents, img = run(pipe)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = want_counts(pipe)
        log(f"  {name}: launches {counts}, schedule says {want}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} != schedule {want}")
        if tuple(img.shape) != (batch, side, side, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"{name}: image {tuple(img.shape)} {img.dtype}")
        if not torch.isfinite(latents.float()).all():
            raise AssertionError(f"{name}: non-finite latents")
        result[name] = {"launches": counts, "latents_std": float(latents.float().std())}
        if latents_out is not None:
            latents_out[name] = latents

    times = {name: [] for name in pipes}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(pipes[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / batch)
    for name in pipes:
        result[name]["ms_per_img"] = statistics.median(times[name])
        result[name]["ms_per_img_runs"] = times[name]
        log(f"  {name}: {result[name]['ms_per_img']:.3f} ms/img (runs {times[name]})")
    for name, pipe in pipes.items():
        if profiled is not None and name not in profiled:
            continue
        result[name]["profile"] = profile_trajectory(
            lambda: run(pipe), result[name]["ms_per_img"] * batch
        )
        log(f"  {name} device time by kernel family (ms per trajectory): "
            f"{result[name]['profile']}")
        seen = result[name]["profile"]["kernels"]
        for family, kernel in kernels.items():
            if not any(kernel in k for k in seen.get(family, ())):
                raise AssertionError(f"{name}: the profile shows no {kernel} under "
                                     f"{family}: {seen}")
    # the VAE decode alone, so that a trajectory's time splits into
    # transformer and decode (its convolutions run as cuDNN xmma kernels,
    # which the family test counts as "gemm")
    vae_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(latents)
        torch.cuda.synchronize()
        vae_ms.append((time.perf_counter() - t0) * 1e3)
    result["vae_decode_ms"] = statistics.median(vae_ms)
    result["vae_profile"] = profile_trajectory(
        lambda: decode(latents), result["vae_decode_ms"]
    )
    log(f"  VAE decode of {batch} latents: {result['vae_decode_ms']:.3f} ms, device "
        f"{result['vae_profile']['device_ms']}")
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return result


def main_path() -> dict:
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.models.vae import random_decoder_pipeline
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log("main path: PixArt-α 256, full width, batch 8, 20 steps")
    REPORT["tiny_trajectory"] = small_reference_check(256)
    config = PixArtConfig()
    t0 = time.perf_counter()
    model = init_model(config, 0, "cuda")
    vae = random_decoder_pipeline(4, "cuda")
    torch.cuda.synchronize()
    REPORT["init_s"] = time.perf_counter() - t0
    pcfg = PixArtPipelineConfig(model=config, num_inference_steps=STEPS)
    pipes = {
        "ours_fast": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(OURS_FAST)),
        "default": PixArtPipeline(pcfg, model, PixArtCacheSchedule.default(STEPS)),
    }
    result = drive(pipes, path_inputs(config, BATCH), vae.decode_device, BATCH, 256,
                   lambda pipe: expected_counts(pipe.masks),
                   order=("default", "ours_fast", "ours_fast", "default"),
                   kernels=SERVED_KERNELS["pixart256"])
    result["speedup"] = result["default"]["ms_per_img"] / result["ours_fast"]["ms_per_img"]
    log(f"  ratio default / ours_fast {result['speedup']:.4f}")
    del model, vae, pipes
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# checkpoints: a tree in the HuggingFace layout written here from seeded
# arrays, served through the generators' weights branches
# ---------------------------------------------------------------------------

CKPT = ROOT / "build" / "ecad_tpu_torch" / "ckpt"
PIXART_256_REPO = "PixArt-alpha/PixArt-XL-2-256x256"
PIXART_PIPE_REPO = "PixArt-alpha/PixArt-XL-2-1024-MS"
FLUX_REPO = "black-forest-labs/FLUX.1-dev"
T5_TREE_LAYERS = 24  # T5-XXL's encoder at full depth in the written tree
T5_SHARD_LAYERS = 6  # layers a BF16 shard
T5_CPU_LAYERS = 2  # the depth held against the same module in fp32 on the CPU
# bf16 against fp32 after two full-width T5-XXL layers, fed the same
# bf16-valued weights: the bf16 rounding of the residual stream and of
# each product's output, relative to the output's standard deviation (the
# least atol that passes was 0.062·std on the H100; the run shows that this
# rejects the output of one layer less)
T5_BF16_TOL = std_bf16_tol(0.1)
FLUX_CUT = (2, 2)  # dual and single blocks of the cut-depth FLUX tree
CKPT_PROMPTS = 8
SAFETENSORS_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def write_safetensors(path: Path, tensors: dict) -> int:
    """A ``.safetensors`` file of `tensors` (on any device, written in their
    order): an 8-byte little-endian header length, the JSON header padded
    with spaces to 8 bytes, then each tensor's raw little-endian bytes.
    chip_smoke's own writer: the card has no ``safetensors`` package, and
    the port only reads. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return 8 + len(raw) + offset


def _lin_spec(spec: dict, key: str, n_in: int, n_out: int, bias: bool = True) -> None:
    spec[f"{key}.weight"] = (n_out, n_in)
    if bias:
        spec[f"{key}.bias"] = (n_out,)


def pixart_spec(c) -> dict:
    """diffusers PixArtTransformer2DModel names → shapes, for `c` (256: no
    size conditions)."""
    d, inner = c.dim, c.num_heads * c.head_dim
    s = {"pos_embed.proj.weight": (d, c.in_channels, c.patch_size, c.patch_size),
         "pos_embed.proj.bias": (d,)}
    _lin_spec(s, "adaln_single.emb.timestep_embedder.linear_1", 256, d)
    _lin_spec(s, "adaln_single.emb.timestep_embedder.linear_2", d, d)
    _lin_spec(s, "adaln_single.linear", d, 6 * d)
    _lin_spec(s, "caption_projection.linear_1", c.caption_dim, d)
    _lin_spec(s, "caption_projection.linear_2", d, d)
    for i in range(c.num_blocks):
        b = f"transformer_blocks.{i}"
        s[f"{b}.scale_shift_table"] = (6, d)
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _lin_spec(s, f"{b}.{a}.{n}", d, inner)
            _lin_spec(s, f"{b}.{a}.to_out.0", inner, d)
        _lin_spec(s, f"{b}.ff.net.0.proj", d, c.ff_mult * d)
        _lin_spec(s, f"{b}.ff.net.2", c.ff_mult * d, d)
    s["scale_shift_table"] = (2, d)
    _lin_spec(s, "proj_out", d, c.patch_size * c.patch_size * c.out_channels)
    return s


def t5_spec(c, layers: range) -> dict:
    """transformers T5EncoderModel names → shapes for `layers` of `c` (the
    embedding, position table and final norm with layer 0)."""
    s, inner = {}, c.num_heads * c.d_kv
    if 0 in layers:
        s["shared.weight"] = (c.vocab_size, c.d_model)
        s["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            c.relative_attention_num_buckets, c.num_heads)
        s["encoder.final_layer_norm.weight"] = (c.d_model,)
    for i in layers:
        pre = f"encoder.block.{i}.layer"
        for n in "qkv":
            _lin_spec(s, f"{pre}.0.SelfAttention.{n}", c.d_model, inner, bias=False)
        _lin_spec(s, f"{pre}.0.SelfAttention.o", inner, c.d_model, bias=False)
        s[f"{pre}.0.layer_norm.weight"] = (c.d_model,)
        for n in ("wi_0", "wi_1"):
            _lin_spec(s, f"{pre}.1.DenseReluDense.{n}", c.d_model, c.d_ff, bias=False)
        _lin_spec(s, f"{pre}.1.DenseReluDense.wo", c.d_ff, c.d_model, bias=False)
        s[f"{pre}.1.layer_norm.weight"] = (c.d_model,)
    return s


def vae_spec(c) -> dict:
    """diffusers AutoencoderKL names → shapes of its decoder half."""
    s = {}

    def conv(key, cin, cout, k):
        s[f"{key}.weight"], s[f"{key}.bias"] = (cout, cin, k, k), (cout,)

    def norm(key, ch):
        s[f"{key}.weight"], s[f"{key}.bias"] = (ch,), (ch,)

    def resnet(key, cin, cout):
        norm(f"{key}.norm1", cin)
        conv(f"{key}.conv1", cin, cout, 3)
        norm(f"{key}.norm2", cout)
        conv(f"{key}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{key}.conv_shortcut", cin, cout, 1)

    lc, ch = c.latent_channels, c.block_out_channels[-1]
    conv("post_quant_conv", lc, lc, 1)
    conv("decoder.conv_in", lc, ch, 3)
    for i in range(2):
        resnet(f"decoder.mid_block.resnets.{i}", ch, ch)
    attn = "decoder.mid_block.attentions.0"
    norm(f"{attn}.group_norm", ch)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        _lin_spec(s, f"{attn}.{n}", ch, ch)
    cin = ch
    rev = tuple(reversed(c.block_out_channels))
    for bi, cout in enumerate(rev):
        for ri in range(c.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{bi}.resnets.{ri}", cin, cout)
            cin = cout
        if bi < len(rev) - 1:
            conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", cout, cout, 3)
    norm("decoder.conv_norm_out", cin)
    conv("decoder.conv_out", cin, c.out_channels, 3)
    return s


def flux_spec(c) -> dict:
    """diffusers FluxTransformer2DModel names → shapes, for `c`."""
    s, d = {}, c.dim
    inner, mlp = c.num_heads * c.head_dim, c.mlp_ratio * c.dim
    tte = "time_text_embed"
    _lin_spec(s, "x_embedder", c.in_channels, d)
    _lin_spec(s, "context_embedder", c.joint_dim, d)
    for name, n_in in (("timestep_embedder", 256), ("guidance_embedder", 256),
                       ("text_embedder", c.pooled_dim)):
        _lin_spec(s, f"{tte}.{name}.linear_1", n_in, d)
        _lin_spec(s, f"{tte}.{name}.linear_2", d, d)
    _lin_spec(s, "norm_out.linear", d, 2 * d)
    _lin_spec(s, "proj_out", d, c.in_channels)
    for i in range(c.num_blocks):
        b = f"transformer_blocks.{i}"
        _lin_spec(s, f"{b}.norm1.linear", d, 6 * d)
        _lin_spec(s, f"{b}.norm1_context.linear", d, 6 * d)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            _lin_spec(s, f"{b}.attn.{n}", d, inner)
        _lin_spec(s, f"{b}.attn.to_out.0", inner, d)
        _lin_spec(s, f"{b}.attn.to_add_out", inner, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            s[f"{b}.attn.{n}.weight"] = (c.head_dim,)
        for ff in ("ff", "ff_context"):
            _lin_spec(s, f"{b}.{ff}.net.0.proj", d, mlp)
            _lin_spec(s, f"{b}.{ff}.net.2", mlp, d)
    for i in range(c.num_single_blocks):
        b = f"single_transformer_blocks.{i}"
        _lin_spec(s, f"{b}.norm.linear", d, 3 * d)
        for n in ("to_q", "to_k", "to_v"):
            _lin_spec(s, f"{b}.attn.{n}", d, inner)
        for n in ("norm_q", "norm_k"):
            s[f"{b}.attn.{n}.weight"] = (c.head_dim,)
        _lin_spec(s, f"{b}.proj_mlp", d, mlp)
        _lin_spec(s, f"{b}.proj_out", d + mlp, d)
    return s


def clip_spec(c) -> dict:
    """transformers CLIPTextModel names → shapes, for `c`."""
    s, d, pre = {}, c.hidden_size, "text_model"
    s[f"{pre}.embeddings.token_embedding.weight"] = (c.vocab_size, d)
    s[f"{pre}.embeddings.position_embedding.weight"] = (c.max_position_embeddings, d)
    for i in range(c.num_layers):
        lay = f"{pre}.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin_spec(s, f"{lay}.self_attn.{n}", d, d)
        _lin_spec(s, f"{lay}.mlp.fc1", d, c.intermediate_size)
        _lin_spec(s, f"{lay}.mlp.fc2", c.intermediate_size, d)
        for n in ("layer_norm1", "layer_norm2"):
            s[f"{lay}.{n}.weight"], s[f"{lay}.{n}.bias"] = (d,), (d,)
    s[f"{pre}.final_layer_norm.weight"] = s[f"{pre}.final_layer_norm.bias"] = (d,)
    return s


EMBEDDING_TABLES = ("shared.weight", "token_embedding.weight", "position_embedding.weight",
                    "relative_attention_bias.weight")


def seeded_arrays(spec: dict, seed: int, dtype: torch.dtype, device: str = "cuda") -> dict:
    """Seeded arrays on `device` for `spec`, in `dtype`: weight matrices and
    kernels N(0, 1/fan_in), embedding and position tables N(0, 1),
    PixArt's modulation tables N(0, 1/d), norm weights 1 + N(0, 0.1²),
    biases N(0, 0.02²)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in spec.items():
        t = torch.empty(shape, device=device)
        if name.endswith(EMBEDDING_TABLES):
            t.normal_(0.0, 1.0, generator=gen)
        elif name.endswith("scale_shift_table"):
            t.normal_(0.0, shape[-1] ** -0.5, generator=gen)
        elif name.endswith(".bias"):
            t.normal_(0.0, 0.02, generator=gen)
        elif len(shape) == 1:
            t.normal_(1.0, 0.1, generator=gen)
        else:
            t.normal_(0.0, float(np.prod(shape[1:])) ** -0.5, generator=gen)
        out[name] = t.to(dtype)
    return out


class WordHashTokenizer:
    """Tokenizer stand-in (the card has no ``transformers``): each
    whitespace word becomes a hash id below the vocabulary, then `eos`;
    `bos` first where given; padded with `pad` to max_length. Takes one
    prompt or a list of them and returns numpy ``input_ids`` and
    ``attention_mask`` (one row a prompt) as a HuggingFace tokenizer does."""

    def __init__(self, vocab: int, eos: int, pad: int, bos: int | None = None):
        self.vocab, self.eos, self.pad, self.bos = vocab, eos, pad, bos

    def __call__(self, prompts, padding="max_length", max_length=120, truncation=True,
                 return_tensors="np"):
        import zlib

        rows, lengths = [], []
        for prompt in [prompts] if isinstance(prompts, str) else prompts:
            ids = [] if self.bos is None else [self.bos]
            ids += [2 + zlib.crc32(w.encode()) % (self.vocab - 3) for w in prompt.split()]
            ids = ids[: max_length - 1] + [self.eos]
            lengths.append(len(ids))
            rows.append(ids + [self.pad] * (max_length - len(ids)))
        return {"input_ids": np.array(rows, np.int64),
                "attention_mask": (np.arange(max_length)[None]
                                   < np.array(lengths)[:, None]).astype(np.int64)}


def dir_bytes(d: Path) -> int:
    return sum(p.stat().st_size for p in d.iterdir() if p.is_file())


def timed_load(loads: dict, name: str, d: Path, fn):
    """`fn()` timed from the files to the module on the card, with the
    directory's bytes: seconds and GB/s in `loads[name]`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    loads[name] = {"s": s, "GB": dir_bytes(d) / 1e9, "GBps": dir_bytes(d) / 1e9 / s}
    log(f"  load {name}: {loads[name]['GB']:.3f} GB in {s:.2f} s "
        f"({loads[name]['GBps']:.2f} GB/s)")
    return out


def write_dir(writes: dict, name: str, files: dict) -> None:
    """Each of `files` ({path: tensors}) written with `write_safetensors`;
    seconds and GB/s of the directory in `writes[name]`."""
    t0 = time.perf_counter()
    n = sum(write_safetensors(path, tensors) for path, tensors in files.items())
    s = time.perf_counter() - t0
    writes[name] = {"s": s, "GB": n / 1e9, "GBps": n / 1e9 / s}
    log(f"  wrote {name}: {n / 1e9:.3f} GB in {s:.2f} s")


def check_pngs(label: str, out: Path, n: int, side: int) -> list:
    from PIL import Image

    pngs = sorted(out.rglob("*.png"))
    if len(pngs) != n:
        raise AssertionError(f"{label}: {len(pngs)} PNGs, expected {n}")
    arrays = [np.asarray(Image.open(p)) for p in pngs]
    for p, a in zip(pngs, arrays):
        if a.shape != (side, side, 3) or a.dtype != np.uint8:
            raise AssertionError(f"{label}: {p.name} is {a.shape} {a.dtype}")
    return arrays


def checkpoint_pixart(writes: dict, loads: dict, random_path: dict) -> dict:
    """PixArt-α 256² from the tree: the transformer (fp32, 28 blocks), T5-XXL
    (BF16 shards) and the SD VAE, through `PixArtAlphaImageGenerator`'s
    weights branches with the word-hash tokenizer attached."""
    from ecad_tpu_torch.image_generators import PixArtAlphaImageGenerator
    from ecad_tpu_torch.models.bridge import pixart_state_dict
    from ecad_tpu_torch.models.pixart import init_model
    from ecad_tpu_torch.models.t5 import T5Config, T5EncoderPipeline, load_t5_weights
    from ecad_tpu_torch.models.vae import VAEConfig
    from ecad_tpu_torch.models.weights import convert_pixart_state_dict
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines import PixArtPipeline
    from ecad_tpu_torch.schedules import PixArtCacheSchedule
    from ecad_tpu_torch.utils.timing import wall_ms

    gen = PixArtAlphaImageGenerator(weights_root=CKPT, schedule_path=OURS_FAST,
                                    batch_size=CKPT_PROMPTS)
    config, t5cfg = gen.model_config(), T5Config.xxl()
    tdir = CKPT / PIXART_256_REPO / "transformer"
    edir = CKPT / PIXART_PIPE_REPO / "text_encoder"
    vdir = CKPT / PIXART_PIPE_REPO / "vae"
    arrays = seeded_arrays(pixart_spec(config), 1, torch.float32)
    write_dir(writes, "pixart_transformer", {
        tdir / "diffusion_pytorch_model.safetensors": arrays})
    shards = [range(lo, min(lo + T5_SHARD_LAYERS, T5_TREE_LAYERS))
              for lo in range(0, T5_TREE_LAYERS, T5_SHARD_LAYERS)]
    t0 = time.perf_counter()
    for i, layers in enumerate(shards):
        path = edir / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_dir(writes, f"t5_shard_{i}", {
            path: seeded_arrays(t5_spec(t5cfg, layers), 100 + i, torch.bfloat16)})
    writes["t5_text_encoder"] = {"s": time.perf_counter() - t0, "GB": dir_bytes(edir) / 1e9,
                                 "layers": T5_TREE_LAYERS}
    write_dir(writes, "sd_vae", {vdir / "diffusion_pytorch_model.safetensors":
                                 seeded_arrays(vae_spec(VAEConfig.sd()), 2, torch.float32)})

    gen._encoder = timed_load(loads, "t5_xxl", edir, lambda: T5EncoderPipeline(
        t5cfg, load_t5_weights(edir, t5cfg), WordHashTokenizer(t5cfg.vocab_size, 1, 0),
        gen.text_len))
    pipe = timed_load(loads, "pixart_transformer", tdir, gen.create_diffusion_pipeline)
    vae = timed_load(loads, "sd_vae", vdir, gen._ensure_vae)
    if not (vae.config.latent_channels == 4 and vae.config.dtype == torch.float32):
        raise AssertionError(f"checkpoint VAE {vae.config}")

    items = json.loads((ROOT / "prompts/ImageRewardPrompts.json").read_text())
    prompts = [it["prompt"] for it in items[:CKPT_PROMPTS]]
    torch.cuda.reset_peak_memory_stats()
    embeddings = gen.encode_prompts(prompts)
    lengths = [int(e["prompt_attention_mask"].sum()) for e in embeddings]
    result = {"t5_tree_layers": T5_TREE_LAYERS, "mask_lengths": lengths}
    work = ROOT / "build" / "ecad_tpu_torch" / "smoke_ckpt_pixart"
    shutil.rmtree(work, ignore_errors=True)

    schedules = {"ours_fast": OURS_FAST, "default": DEFAULT_256}
    for name, path in schedules.items():
        gen.set_schedule(path)  # swaps the masks of the one resident pipeline
        pipe = gen.create_diffusion_pipeline()
        reset_launch_counts()
        gen.generate_images(embeddings, output_dir=work / name)
        torch.cuda.synchronize()
        counts, want = launch_counts(), expected_counts(pipe.masks)
        log(f"  checkpoint {name}: launches {counts}, schedule says {want}")
        if counts != want:
            raise AssertionError(f"checkpoint {name}: launches {counts} != {want}")
        check_pngs(f"checkpoint {name}", work / name, CKPT_PROMPTS, 256)
        result[name] = {"launches": counts}
    # T5-XXL, the transformer and the VAE resident, a batch of 8 generated
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # the same model built in memory from the same arrays, on the same inputs
    mem_model = init_model(config, state=pixart_state_dict(
        convert_pixart_state_dict(arrays, config)))
    del arrays
    gen_noise = torch.Generator(device="cuda").manual_seed(0)
    inputs = dict(
        noise=torch.randn((CKPT_PROMPTS, config.sample_size, config.sample_size,
                           config.in_channels), generator=gen_noise,
                          device="cuda").to(config.dtype),
        text=gen._stack(embeddings, "prompt_embeds", config.dtype),
        neg=gen._stack(embeddings, "negative_prompt_embeds", config.dtype),
        text_mask=gen._stack(embeddings, "prompt_attention_mask"),
        neg_mask=gen._stack(embeddings, "negative_prompt_attention_mask"))
    for name, path in schedules.items():
        gen.set_schedule(path)
        pipe = gen.create_diffusion_pipeline()
        mem = PixArtPipeline(pipe.config, mem_model, PixArtCacheSchedule.from_json(path))
        a, b = pipe.denoise(**inputs), mem.denoise(**inputs)
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint {name}: the trajectory differs from the "
                                 f"in-memory build by {float((a - b).abs().max())}")
        result[name]["latents_std"] = float(a.float().std())
    log(f"  trajectories bit-equal to the in-memory build; mask lengths {lengths}")
    del mem_model, mem

    # ms/img in turns against a random-weight generator (the random bf16 VAE)
    # on the same embeddings, both timed by `generate_images_timed`
    rand = PixArtAlphaImageGenerator(random_weights=True, schedule_path=OURS_FAST,
                                     batch_size=CKPT_PROMPTS)
    rand.use_random_vae = True
    rand.generate_images_timed(embeddings, seed=1)  # builds its model and VAE, untimed
    sources = {"checkpoint": gen, "random_weights": rand}
    times = {(src, name): [] for src in sources for name in schedules}
    for name in ("default", "ours_fast", "ours_fast", "default"):
        for src in (("checkpoint", "random_weights") if len(times[("checkpoint", name)]) == 0
                    else ("random_weights", "checkpoint")):
            g = sources[src]
            g.set_schedule(schedules[name])
            times[(src, name)].append(g.generate_images_timed(embeddings, seed=1) / CKPT_PROMPTS)
    for name in schedules:
        r = result[name]
        r["ms_per_img_runs"] = times[("checkpoint", name)]
        r["ms_per_img"] = statistics.median(r["ms_per_img_runs"])
        r["random_weights_ms_per_img_runs"] = times[("random_weights", name)]
        r["random_weights_ms_per_img"] = statistics.median(r["random_weights_ms_per_img_runs"])
        r["main256_ms_per_img"] = random_path[name]["ms_per_img"]
        log(f"  checkpoint {name}: {r['ms_per_img']:.3f} ms/img (random-weight generator "
            f"{r['random_weights_ms_per_img']:.3f}, main256 {r['main256_ms_per_img']:.3f})")
    gen.set_schedule(OURS_FAST)
    latents = gen._generate_latents(embeddings, 1)
    for key, g in (("vae_decode_ms", gen), ("random_vae_decode_ms", rand)):
        decode = g._ensure_vae().decode_device
        result[key] = statistics.median(wall_ms(lambda: decode(latents), "cuda")
                                        for _ in range(3))
    del rand
    result["profile"] = profile_trajectory(
        lambda: gen.decode_latents_device(gen._generate_latents(embeddings, 1)),
        result["ours_fast"]["ms_per_img"] * CKPT_PROMPTS)
    seen = result["profile"]["kernels"]
    for family, kernel in SERVED_KERNELS["pixart256"].items():
        if not any(kernel in k for k in seen.get(family, ())):
            raise AssertionError(f"checkpoint: the profile shows no {kernel} under {family}")
    log(f"  peak {result['peak_mem_gib']:.2f} GiB with T5-XXL resident; VAE decode "
        f"{result['vae_decode_ms']:.2f} ms (fp32) against {result['random_vae_decode_ms']:.2f}"
        f" (random bf16)")

    # T5-XXL: encode times, then two layers against the same module in fp32
    enc = gen.create_encoder_pipeline()
    tok = enc.tokenizer
    batch = [tok(p, max_length=L) for p, L in ((prompts[0], 120), ("", 120))]
    ids = torch.from_numpy(np.concatenate([t["input_ids"] for t in batch])).cuda()
    mask = torch.from_numpy(np.concatenate([t["attention_mask"] for t in batch])).cuda()
    long = tok(prompts[0], max_length=512)
    ids512 = torch.from_numpy(long["input_ids"]).cuda()
    mask512 = torch.from_numpy(long["attention_mask"]).cuda()
    with torch.inference_mode():
        result["t5_encode_ms"] = {
            "120_tokens_batch_2": timed_ms("t5_xxl_120x2", lambda: enc.model(ids, mask), 5, 5),
            "512_tokens_batch_1": timed_ms("t5_xxl_512x1", lambda: enc.model(ids512, mask512),
                                           5, 5),
            "layers": t5cfg.num_layers,
        }
    log(f"  T5-XXL encode ms: {result['t5_encode_ms']}")
    del gen, enc, pipe, vae
    torch.cuda.empty_cache()
    cut = T5Config.xxl(num_layers=T5_CPU_LAYERS)
    with torch.inference_mode():
        got = load_t5_weights(edir, cut)(ids, mask)
        want = load_t5_weights(edir, dataclasses.replace(cut, dtype=torch.float32), "cpu")(
            ids.cpu(), mask.cpu())
    result["t5_cpu_max_abs_err"] = compare("t5_xxl_2_layers_bf16_vs_cpu_fp32",
                                           got, want.cuda(), T5_BF16_TOL)
    with torch.inference_mode():
        dropped = load_t5_weights(edir, dataclasses.replace(
            cut, num_layers=T5_CPU_LAYERS - 1, dtype=torch.float32), "cpu")(ids.cpu(), mask.cpu())
    rejects("t5_xxl_last_layer_dropped", dropped.cuda(), want.cuda(), T5_BF16_TOL)
    return result


def checkpoint_flux(writes: dict, loads: dict) -> dict:
    """FLUX.1-dev 256² from a tree in the public layout: CLIP-L in
    text_encoder/, T5-XXL in text_encoder_2/ (the PixArt tree's shards,
    hard-linked), the transformer at full width cut to `FLUX_CUT` blocks
    (bf16) and the 16-channel VAE (bf16), through a cut-depth subclass of
    `FluxImageGenerator`, one prompt under `flux_256/ours_fast`'s masks of
    those blocks."""
    from ecad_tpu_torch.image_generators import FluxImageGenerator
    from ecad_tpu_torch.image_generators.flux import _FluxRealEncoder
    from ecad_tpu_torch.models.bridge import flux_state_dict
    from ecad_tpu_torch.models.clip import CLIPTextConfig, CLIPTextPipeline, load_clip_weights
    from ecad_tpu_torch.models.flux import FluxConfig, init_model
    from ecad_tpu_torch.models.t5 import T5Config, T5EncoderPipeline, load_t5_weights
    from ecad_tpu_torch.models.vae import VAEConfig
    from ecad_tpu_torch.models.weights import convert_flux_state_dict
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines.flux_pipeline import FluxPipeline
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    n_dual, n_single = FLUX_CUT

    class CutFluxGenerator(FluxImageGenerator):
        num_blocks, num_single_blocks = n_dual, n_single

        def model_config(self):
            return dataclasses.replace(super().model_config(), num_blocks=n_dual,
                                       num_single_blocks=n_single)

    repo = CKPT / FLUX_REPO
    config = CutFluxGenerator(random_weights=True).model_config()
    ccfg, t5cfg = CLIPTextConfig.large(), T5Config.xxl()
    arrays = seeded_arrays(flux_spec(config), 3, torch.bfloat16)
    write_dir(writes, "flux_transformer_cut", {
        repo / "transformer" / "diffusion_pytorch_model.safetensors": arrays})
    write_dir(writes, "clip_l", {repo / "text_encoder" / "model.safetensors":
                                 seeded_arrays(clip_spec(ccfg), 4, torch.float32)})
    write_dir(writes, "flux_vae", {repo / "vae" / "diffusion_pytorch_model.safetensors":
                                   seeded_arrays(vae_spec(VAEConfig.flux()), 5, torch.bfloat16)})
    (repo / "text_encoder_2").mkdir(parents=True)
    for f in sorted((CKPT / PIXART_PIPE_REPO / "text_encoder").iterdir()):
        os.link(f, repo / "text_encoder_2" / f.name)

    # flux_256/ours_fast's masks of the cut blocks: dual 0.., single 0..
    full = FluxCacheSchedule.from_json(FLUX_OURS_FAST_256)
    slots = full.mask.reshape(full.num_inference_steps, -1, 3)
    keep = [*range(n_dual), *range(full.num_blocks, full.num_blocks + n_single)]
    cut = FluxCacheSchedule.from_numpy(
        slots[:, keep].reshape(full.num_inference_steps, -1), full.num_inference_steps,
        n_dual, name="ours_fast_cut", num_single_blocks=n_single,
        top_level_config=full.top_level_config)
    sched = CKPT / "flux_ours_fast_cut.json"
    sched.write_text(json.dumps(cut.to_dict()))

    gen = CutFluxGenerator(weights_root=CKPT, schedule_path=sched, batch_size=1)
    t5dir, cdir = repo / "text_encoder_2", repo / "text_encoder"
    t5 = timed_load(loads, "t5_xxl_text_encoder_2", t5dir, lambda: T5EncoderPipeline(
        t5cfg, load_t5_weights(t5dir, t5cfg), WordHashTokenizer(t5cfg.vocab_size, 1, 0),
        gen.text_len))
    clip = timed_load(loads, "clip_l", cdir, lambda: CLIPTextPipeline(
        ccfg, load_clip_weights(cdir, ccfg),
        WordHashTokenizer(ccfg.vocab_size, ccfg.eos_token_id, ccfg.eos_token_id,
                          bos=ccfg.eos_token_id - 1)))
    gen._encoder = _FluxRealEncoder(t5, clip)
    pipe = timed_load(loads, "flux_transformer_cut", repo / "transformer",
                      gen.create_diffusion_pipeline)
    vae = timed_load(loads, "flux_vae", repo / "vae", gen._ensure_vae)
    if vae.config.latent_channels != 16:
        raise AssertionError(f"FLUX checkpoint VAE {vae.config}")

    prompt = "a lighthouse on a cliff above a stormy sea at dusk"
    [emb] = gen.encode_prompts([prompt])
    work = ROOT / "build" / "ecad_tpu_torch" / "smoke_ckpt_flux"
    shutil.rmtree(work, ignore_errors=True)
    reset_launch_counts()
    gen.generate_images([emb], output_dir=work)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = flux_expected_counts(pipe.masks, n_dual, "attention")
    log(f"  checkpoint FLUX: launches {counts}, schedule says {want}")
    if counts != want:
        raise AssertionError(f"checkpoint FLUX: launches {counts} != {want}")
    check_pngs("checkpoint FLUX", work, 1, 256)

    mem_model = init_model(config, state=flux_state_dict(convert_flux_state_dict(arrays, config)))
    del arrays
    gen_noise = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn((1, pipe.config.image_seq_len, config.in_channels),
                        generator=gen_noise, device="cuda").to(config.dtype)
    txt = gen._stack([emb], "prompt_embeds", config.dtype)
    pooled = gen._stack([emb], "pooled_prompt_embeds", config.dtype)
    a = pipe.denoise(noise, txt, pooled)
    b = FluxPipeline(pipe.config, mem_model, cut).denoise(noise, txt, pooled)
    if not torch.equal(a, b):
        raise AssertionError(f"checkpoint FLUX: the trajectory differs from the in-memory "
                             f"build by {float((a - b).abs().max())}")
    log("  FLUX trajectory bit-equal to the in-memory build")

    toks = clip.tokenizer(prompt, max_length=ccfg.max_position_embeddings)
    ids = torch.from_numpy(toks["input_ids"]).cuda()
    with torch.inference_mode():
        clip_ms = timed_ms("clip_l_77x1", lambda: clip.model(ids), 5, 5)
        pooled_gpu = clip.model(ids)[1]
        pooled_cpu = load_clip_weights(cdir, ccfg, "cpu")(ids.cpu())[1]
    result = {"launches": counts, "blocks": list(FLUX_CUT), "clip_l_ms_77_tokens": clip_ms,
              "clip_cpu_max_abs_err": compare("clip_l_pooled_vs_cpu", pooled_gpu,
                                              pooled_cpu.cuda(), (1e-3, 1e-3)),
              "latents_std": float(a.float().std())}
    log(f"  CLIP-L at 77 tokens: {clip_ms:.3f} ms")
    return result


def checkpoints_phase(random_path: dict) -> dict:
    """The `checkpoints` phase: write the tree under `CKPT`, serve PixArt-α
    256² and the cut FLUX from it, and report the writes, loads (warm: the
    files were just written), encode times and ms/img. PixArt-α 256's
    transformer and the SD VAE stay for the `scorers` phase."""
    log("checkpoints phase: a HuggingFace-layout tree written here, served from disk")
    shutil.rmtree(CKPT, ignore_errors=True)
    writes, loads = {}, {}
    result = {"pixart256": checkpoint_pixart(writes, loads, random_path)}
    torch.cuda.empty_cache()
    result["flux256_cut"] = checkpoint_flux(writes, loads)
    result.update(writes=writes, loads=loads)
    # the scorers phase serves PixArt-α 256² from the transformer and the
    # VAE, and deletes the tree when it ends
    shutil.rmtree(CKPT / FLUX_REPO, ignore_errors=True)
    shutil.rmtree(CKPT / PIXART_PIPE_REPO / "text_encoder", ignore_errors=True)
    torch.cuda.empty_cache()
    return result


def checkpoints_line(smi: str, r: dict, seconds: float) -> dict:
    """The phase's numbers for a line of their own."""
    px, fx = r["pixart256"], r["flux256_cut"]
    return {"checkpoints": {
        "card": smi,
        "load_s_GBps": {k: [v["s"], v["GBps"]] for k, v in r["loads"].items()},
        "t5_xxl_layers": px["t5_encode_ms"]["layers"],
        "t5_xxl_encode_ms": {k: v for k, v in px["t5_encode_ms"].items() if k != "layers"},
        "clip_l_ms_77_tokens": fx["clip_l_ms_77_tokens"],
        "peak_gib_t5_resident": px["peak_mem_gib"],
        "ms_per_img_checkpoint": {k: px[k]["ms_per_img"] for k in ("ours_fast", "default")},
        "ms_per_img_random_weights": {k: px[k]["random_weights_ms_per_img"]
                                      for k in ("ours_fast", "default")},
        "ms_per_img_main256": {k: px[k]["main256_ms_per_img"] for k in ("ours_fast", "default")},
        "vae_decode_ms_fp32_checkpoint_vs_bf16_random": [px["vae_decode_ms"],
                                                         px["random_vae_decode_ms"]],
        "launches": {"pixart256/ours_fast": px["ours_fast"]["launches"],
                     "pixart256/default": px["default"]["launches"],
                     "flux256_cut/ours_fast": fx["launches"]},
        "t5_2_layers_bf16_vs_cpu_fp32_max_abs_err": px["t5_cpu_max_abs_err"],
        "seconds": seconds,
    }}


# ---------------------------------------------------------------------------
# the benchmark tier
# ---------------------------------------------------------------------------

TIER_SCHEDULES = {"ours_fast": OURS_FAST, "ours_faster": OURS_FASTER, "default": DEFAULT_256}
TIER_PROMPTS = 8
OURS_FAST_MACS = 2134989471744  # the paper's ours_fast at PixArt-α 256²
LATENCY_WARMUPS, LATENCY_SAMPLES = 2, 3
FID_IMAGES_PER_PROMPT = 25  # 200 images of the default for its FID stats
BENCH_TURNS = 3
TIER_KEEP = ROOT / "build" / "ecad_tpu_torch" / "tier"  # PNGs the scorers phase scores


def tier_expected_counts(paths, batch: int, text_mask: bool = True) -> dict[str, int]:
    """Launches of one full-width PixArt-α 256² trajectory a schedule file
    (`search_expected_counts`); the tier's hash-encoder embeddings carry
    text masks, so the cross-attention counts under K2."""
    from ecad_tpu_torch.models.pixart import PixArtConfig, schedule_step_masks
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    config = PixArtConfig()
    masks = [schedule_step_masks(PixArtCacheSchedule.from_json(p), config) for p in paths]
    return search_expected_counts(masks, config, batch, text_mask=text_mask)


def counted(fn) -> dict[str, int]:
    """`fn()` with the launch counters set to 0 just before and read just
    after a device sync."""
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return launch_counts()


def check_counts(label: str, counts: dict, want: dict) -> None:
    log(f"  {label}: launches {counts}, schedules say {want}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != schedules {want}")


def benchmark_phase(smi: str) -> dict:
    """The port's benchmark tier at full-width PixArt-α 256² (random bf16
    weights, hash-encoder prompts), in this process, in a scratch
    directory, on copies of the schedule JSONs (compute_macs and
    compute_latency write into the files they are given); then the port's
    batch-32 bench in turns, with one profiled run of each arm."""
    import tempfile

    from ecad_tpu_torch import bench
    from ecad_tpu_torch.benchmark import (
        compute_fid,
        compute_latency,
        compute_macs,
        generate_embeddings,
        generate_images,
        score_images,
    )
    from ecad_tpu_torch.image_generators import PixArtAlphaImageGenerator
    from ecad_tpu_torch.utils.io import load_embedding_dir
    from PIL import Image

    log("benchmark phase: the benchmark tier at PixArt-α 256², then the batch-32 bench")
    result = {}
    scratch = ROOT / "build" / "ecad_tpu_torch"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        items = json.loads((ROOT / "prompts/ImageRewardPrompts.json").read_text())
        (tmp / "prompts.json").write_text(json.dumps(items[:TIER_PROMPTS]))
        emb = tmp / "embeddings"
        generate_embeddings.main(["PixArtAlphaImageGenerator", "--prompt-file",
                                  str(tmp / "prompts.json"), "--output-dir", str(emb),
                                  "--random-weights"])
        entries = load_embedding_dir(emb)
        if len(entries) != TIER_PROMPTS or entries[0]["prompt_embeds"].shape != (120, 4096):
            raise AssertionError(f"embeddings: {len(entries)} files")
        schedules = tmp / "schedules"
        schedules.mkdir()
        for name, path in TIER_SCHEDULES.items():
            shutil.copy(path, schedules / f"{name}.json")
        paths = [schedules / f"{name}.json" for name in TIER_SCHEDULES]

        # the image tree: one resident generator, each schedule swapped in
        images = tmp / "images"
        argv = ["PixArtAlphaImageGenerator", "--input-embeddings", str(emb), "--output-dir",
                str(images), "--schedule-dir", str(schedules), "--batch-size", str(BATCH),
                "--random-weights"]
        t0 = time.perf_counter()
        counts = counted(lambda: generate_images.main(argv))
        result["generate_images_s"] = time.perf_counter() - t0
        check_counts("generate_images", counts, tier_expected_counts(paths, BATCH))
        result["generate_images_launches"] = counts
        pngs = {name: sorted((images / name).glob("*.png")) for name in TIER_SCHEDULES}
        for name, files in pngs.items():
            if len(files) != TIER_PROMPTS:
                raise AssertionError(f"{name}: {len(files)} PNGs, expected {TIER_PROMPTS}")
            arr = np.asarray(Image.open(files[0]))
            if arr.shape != (32, 32, 3) or arr.dtype != np.uint8:  # the latent visualization
                raise AssertionError(f"{files[0].name}: {arr.shape} {arr.dtype}")
        stamps = {p: p.stat().st_mtime_ns for files in pngs.values() for p in files}
        counts = counted(lambda: generate_images.main(argv))
        if any(counts.values()) or {p: p.stat().st_mtime_ns for p in stamps} != stamps:
            raise AssertionError(f"the rerun did work: launches {counts}")
        log("  rerun: every schedule skipped, no launches")

        # one trajectory of the tier's generator (denoise + random VAE),
        # profiled: the Hopper kernels by name
        gen = PixArtAlphaImageGenerator(random_weights=True, batch_size=BATCH,
                                        schedule_path=paths[0])
        gen.use_random_vae = True
        wall = statistics.median(gen.generate_images_timed(entries) for _ in range(3))
        prof = profile_trajectory(lambda: gen.generate_images_timed(entries), wall)
        seen = prof["kernels"]
        for family, kernel in SERVED_KERNELS["pixart256"].items():
            if not any(kernel in k for k in seen.get(family, ())):
                raise AssertionError(f"tier trajectory: no {kernel} under {family}: {seen}")
        result["tier_trajectory"] = {"ms": wall, "profile": prof}
        log(f"  tier trajectory (ours_fast, batch {BATCH}, random VAE): {wall:.3f} ms, "
            f"idle share {prof['idle_share']:.4f}")
        del gen

        # MACs into the schedule copies
        compute_macs.main(["--input-dir", str(schedules), "--overwrite"])
        macs = {name: json.loads((schedules / f"{name}.json").read_text())["metrics"]
                for name in TIER_SCHEDULES}
        if macs["ours_fast"]["total_macs"] != OURS_FAST_MACS:
            raise AssertionError(f"ours_fast MACs {macs['ours_fast']['total_macs']}")
        result["total_macs_T"] = {k: m["total_macs_T"] for k, m in macs.items()}

        # scores and FID
        score_images.main(["--image-dir", str(images), "--prompt-file",
                           str(tmp / "prompts.json"), "--scorer", "mock",
                           "--exactly-n-images", str(TIER_PROMPTS)])
        for name in TIER_SCHEDULES:
            scores = json.loads((images / name / "scores.json").read_text())
            if len(scores["avg_by_prompt"]) != TIER_PROMPTS:
                raise AssertionError(f"{name} scores: {scores['avg_by_prompt']}")
        # the default's FID tree: more images than pixel_stats has features
        # (192), so its covariance has full rank and the self-FID carries
        # only round-off
        fid_images = tmp / "fid_images"
        counts = counted(lambda: generate_images.main([
            "PixArtAlphaImageGenerator", "--input-embeddings", str(emb), "--output-dir",
            str(fid_images), "--schedule", str(schedules / "default.json"),
            "--images-per-prompt", str(FID_IMAGES_PER_PROMPT), "--batch-size", str(BATCH),
            "--random-weights"]))
        check_counts("generate_images (FID tree)", counts, tier_expected_counts(
            [schedules / "default.json"] * FID_IMAGES_PER_PROMPT, BATCH))
        n_fid = len(list((fid_images / "default").glob("*.png")))
        if n_fid != TIER_PROMPTS * FID_IMAGES_PER_PROMPT:
            raise AssertionError(f"FID tree: {n_fid} PNGs")
        stats = tmp / "default_stats.npz"
        compute_fid.main(["--image-dir", str(fid_images / "default"), "--stats", str(stats),
                          "--make-stats"])
        fid = {}
        for name, tree in (("default", fid_images), ("ours_fast", images)):
            compute_fid.main(["--image-dir", str(tree / name), "--stats", str(stats)])
            fid[name] = json.loads((tree / name / "fid_scores.json").read_text())["fid"]
        if not (abs(fid["default"]) <= 1e-6 and np.isfinite(fid["ours_fast"])
                and fid["ours_fast"] > 0):
            raise AssertionError(f"FID {fid}")
        result["fid_pixel_stats_vs_default"] = fid
        result["fid_stats_images"] = n_fid

        # the latency protocol at batch 8 with the random VAE
        latency_dir = tmp / "latency"
        latency_dir.mkdir()
        timed = ("ours_fast", "default")
        for name in timed:
            shutil.copy(schedules / f"{name}.json", latency_dir / f"{name}.json")
        counts = counted(lambda: compute_latency.main([
            "PixArtAlphaImageGenerator", "--input-embeddings", str(emb), "--input-dir",
            str(latency_dir), "--warmup-steps", str(LATENCY_WARMUPS), "--num-samples",
            str(LATENCY_SAMPLES), "--batch-size", str(BATCH), "--random-weights",
            "--random-vae"]))
        runs = LATENCY_WARMUPS + LATENCY_SAMPLES
        want = tier_expected_counts([latency_dir / f"{n}.json" for n in timed] * runs, BATCH)
        check_counts("compute_latency", counts, want)
        latency = {name: json.loads((latency_dir / f"{name}.json").read_text())["metrics"]
                   ["latency"] for name in timed}
        for name, lat in latency.items():
            if lat["gpu"] != torch.cuda.get_device_name(0) or len(lat["latencies"]) != 3:
                raise AssertionError(f"{name} metrics.latency {lat}")
        result["compute_latency"] = latency
        result["compute_latency_ratio"] = latency["default"]["avg"] / latency["ours_fast"]["avg"]
        log(f"  compute_latency (batch {BATCH}, random VAE): "
            f"{ {k: v['avg'] for k, v in latency.items()} } ms/img, ratio "
            f"{result['compute_latency_ratio']:.4f}")
        # the PNGs (not their mock scores) and prompts, for the scorers phase
        shutil.rmtree(TIER_KEEP, ignore_errors=True)
        shutil.copytree(images, TIER_KEEP / "images", ignore=shutil.ignore_patterns("*.json"))
        shutil.copy(tmp / "prompts.json", TIER_KEEP / "prompts.json")
    torch.cuda.empty_cache()

    # the port's headline bench, batch 32, in turns, on one resident
    # generator; first K1 and K3 at its shapes (CFG batch 64, no text mask)
    b2 = 2 * bench.BATCH
    result["bench_kernel_errors"] = search_kernel_checks(
        "bench", [(b2, 256, 256, 16, 72), (b2, 256, 120, 16, 72)], (b2, 256, 1152))
    gen, emb = bench.build("cuda")
    arms = bench.arms()

    def run(name):
        return bench.run_arm(gen, emb, arms[name])

    want = tier_expected_counts([DEFAULT_256, OURS_FAST], bench.BATCH, text_mask=False)
    counts = [counted(lambda: run(name)) for name in bench.ARMS]
    check_counts("bench arms (no text mask: cross-attention on K1)", sum_counts(counts), want)
    result["bench_launches"] = dict(zip(bench.ARMS, counts))
    out = bench.measure(gen, emb, arms, turns=BENCH_TURNS)
    result["bench"] = out
    d = out["detail"]
    result["bench_profile"] = {}
    for name in bench.ARMS:
        prof = profile_trajectory(lambda: run(name), d[f"{name}_ms_per_image"] * bench.BATCH)
        result["bench_profile"][name] = prof
        log(f"  bench {name}: {d[f'{name}_ms_per_image']:.3f} ms/img "
            f"(turns {d[f'{name}_ms_per_image_turns']}), idle share "
            f"{prof['idle_share']:.4f}, device {prof['device_ms']}")
    log(f"  bench ratio {out['value']:.4f} (per turn {d['ratio_per_turn']}), peak "
        f"{d['peak_mem_gib']:.2f} GiB on {d['card']}")
    if d["card"] != smi:
        raise AssertionError(f"bench card {d['card']!r} != {smi!r}")
    del gen, emb
    torch.cuda.empty_cache()
    return result


def benchmark_line(smi: str, r: dict, seconds: float) -> dict:
    """The benchmark phase's numbers for their own stdout line."""
    d = r["bench"]["detail"]
    lat = r["compute_latency"]
    return {"benchmark": {
        "card": smi,
        "bench_batch32": {
            "ms_per_img": {a: d[f"{a}_ms_per_image"] for a in ("uncached", "cached")},
            "ms_per_img_range": {a: d[f"{a}_ms_per_image_range"]
                                 for a in ("uncached", "cached")},
            "ratio": r["bench"]["value"],
            "ratio_per_turn": d["ratio_per_turn"],
            "vs_baseline": r["bench"]["vs_baseline"],
            "idle_share": {a: p["idle_share"] for a, p in r["bench_profile"].items()},
            "peak_mem_gib": d["peak_mem_gib"],
        },
        "compute_latency_batch8": {
            "ms_per_img": {k: v["avg"] for k, v in lat.items()},
            "ms_per_img_samples": {k: v["latencies"] for k, v in lat.items()},
            "ratio": r["compute_latency_ratio"],
        },
        "bench_kernel_max_abs_err": r["bench_kernel_errors"],
        "tier_trajectory_idle_share": r["tier_trajectory"]["profile"]["idle_share"],
        "fid_pixel_stats_vs_default": r["fid_pixel_stats_vs_default"],
        "fid_stats_images": r["fid_stats_images"],
        "phase_s": seconds,
    }}


# ---------------------------------------------------------------------------
# the scorer towers
# ---------------------------------------------------------------------------

SCORERS = CKPT / "scorers"


def tower_tol(want: torch.Tensor) -> tuple[float, float]:
    """(atol, rtol) of a scorer tower on the card against the same module
    on the CPU. Both run in IEEE fp32 (`fid.ieee_fp32`: no TF32, for the
    convolutions either), so they differ only in the order of their sums,
    each rounded at 2^-24: 1e-4 of the output's spread plus 1e-4 relative
    leaves room for that over ViT-L's 24 layers, and lies below what TF32's
    2^-11 rounding of every operand gives (the run measures the ViT with
    TF32 on against the same bound: `vit_tf32_least_atol_per_std`)."""
    return 1e-4 * float(want.float().std()), 1e-4

TOWER_BATCHES = (8, 32)
TOWER_CHECK_IMAGES = 2
BERT_VOCAB = 30524  # BLIP's BERT: [PAD] 0, [CLS] 101, [SEP] 102, then 2 added tokens
CLIP_B32_VISION = dict(image_size=224, patch_size=32, hidden_size=768, intermediate_size=3072,
                       num_layers=12, num_heads=12)
CLIP_B32_TEXT = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048, num_layers=12,
                     num_heads=8, max_position_embeddings=77)
IR_MLP_LAYERS = (0, 2, 4, 6, 7)  # Sequential indices of the head's Linears, dropouts between


def _ln_spec(spec: dict, key: str, d: int) -> None:
    spec[f"{key}.weight"], spec[f"{key}.bias"] = (d,), (d,)


def image_reward_spec(v, b, mlp_dims) -> dict:
    """ImageReward.pt names (the reference converter's layout: timm ViT,
    BLIP's BERT with cross-attention, the head) → shapes."""
    s, d, p, bd = {}, v.hidden_size, v.patch_size, b.hidden_size
    ve, te = "blip.visual_encoder", "blip.text_encoder.bert"
    s[f"{ve}.patch_embed.proj.weight"], s[f"{ve}.patch_embed.proj.bias"] = (d, 3, p, p), (d,)
    s[f"{ve}.cls_token"] = (1, 1, d)
    s[f"{ve}.pos_embed"] = (1, (v.image_size // p) ** 2 + 1, d)
    _ln_spec(s, f"{ve}.norm", d)
    for i in range(v.num_layers):
        blk = f"{ve}.blocks.{i}"
        _ln_spec(s, f"{blk}.norm1", d)
        _ln_spec(s, f"{blk}.norm2", d)
        _lin_spec(s, f"{blk}.attn.qkv", d, 3 * d)
        _lin_spec(s, f"{blk}.attn.proj", d, d)
        _lin_spec(s, f"{blk}.mlp.fc1", d, v.mlp_ratio * d)
        _lin_spec(s, f"{blk}.mlp.fc2", v.mlp_ratio * d, d)
    s[f"{te}.embeddings.word_embeddings.weight"] = (b.vocab_size, bd)
    s[f"{te}.embeddings.position_embeddings.weight"] = (b.max_position_embeddings, bd)
    _ln_spec(s, f"{te}.embeddings.LayerNorm", bd)
    for i in range(b.num_layers):
        lay = f"{te}.encoder.layer.{i}"
        for a, kv in (("attention", bd), ("crossattention", b.encoder_width)):
            _lin_spec(s, f"{lay}.{a}.self.query", bd, bd)
            _lin_spec(s, f"{lay}.{a}.self.key", kv, bd)
            _lin_spec(s, f"{lay}.{a}.self.value", kv, bd)
            _lin_spec(s, f"{lay}.{a}.output.dense", bd, bd)
            _ln_spec(s, f"{lay}.{a}.output.LayerNorm", bd)
        _lin_spec(s, f"{lay}.intermediate.dense", bd, b.intermediate_size)
        _lin_spec(s, f"{lay}.output.dense", b.intermediate_size, bd)
        _ln_spec(s, f"{lay}.output.LayerNorm", bd)
    for idx, n_in, n_out in zip(IR_MLP_LAYERS, (bd, *mlp_dims[:-1]), mlp_dims):
        _lin_spec(s, f"mlp.layers.{idx}", n_in, n_out)
    return s


def clip_vision_spec(c) -> dict:
    """transformers CLIPVisionModel names → shapes, for `c`."""
    s, d, pre = {}, c.hidden_size, "vision_model"
    s[f"{pre}.embeddings.patch_embedding.weight"] = (d, 3, c.patch_size, c.patch_size)
    s[f"{pre}.embeddings.class_embedding"] = (d,)
    s[f"{pre}.embeddings.position_embedding.weight"] = ((c.image_size // c.patch_size) ** 2 + 1,
                                                        d)
    _ln_spec(s, f"{pre}.pre_layrnorm", d)
    _ln_spec(s, f"{pre}.post_layernorm", d)
    for i in range(c.num_layers):
        lay = f"{pre}.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin_spec(s, f"{lay}.self_attn.{n}", d, d)
        _lin_spec(s, f"{lay}.mlp.fc1", d, c.intermediate_size)
        _lin_spec(s, f"{lay}.mlp.fc2", c.intermediate_size, d)
        _ln_spec(s, f"{lay}.layer_norm1", d)
        _ln_spec(s, f"{lay}.layer_norm2", d)
    return s


def inception_spec() -> dict:
    """pt_inception names (torchvision's: ``X.conv.weight``, ``X.bn.*``) →
    shapes, from the port's module on the meta device."""
    from ecad_tpu_torch.scoring.inception import InceptionV3FID

    bn = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
          "bn_var": "bn.running_var"}
    with torch.device("meta"):
        model = InceptionV3FID()
    s = {}
    for name, p in model.named_parameters():
        site, leaf = name.rsplit(".", 1)
        s[f"{site}.{bn[leaf]}" if leaf in bn else name] = tuple(p.shape)
    return s


def write_scorer_trees(writes: dict) -> dict:
    """Seeded full-width scorer checkpoints under `SCORERS`: ImageReward.pt
    (fp32, ``torch.save``) with a vocab.txt; a ViT-B/32 CLIP directory
    (config.json and safetensors); a pt_inception checkpoint with batchnorm
    statistics (its means N(0, 0.1²), variances 1 + N(0, 0.1²), its
    convolutions He-scaled so that activations keep their size through the
    ReLUs). Returns the paths."""
    from ecad_tpu_torch.scoring.image_reward import MLP_DIMS, BertConfig, ViTConfig

    shutil.rmtree(SCORERS, ignore_errors=True)
    ir = SCORERS / "ImageReward"
    ir.mkdir(parents=True)
    t0 = time.perf_counter()
    arrays = seeded_arrays(image_reward_spec(ViTConfig.large(), BertConfig.base(), MLP_DIMS),
                           40, torch.float32)
    torch.save({k: v.cpu() for k, v in arrays.items()}, ir / "ImageReward.pt")
    del arrays
    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"w{i}" for i in range(BERT_VOCAB - 2 - len(vocab))]
    (ir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    writes["image_reward"] = {"s": time.perf_counter() - t0, "GB": dir_bytes(ir) / 1e9}

    from ecad_tpu_torch.models.clip import CLIPTextConfig
    from ecad_tpu_torch.scoring.clip_score import CLIPVisionConfig

    clip = SCORERS / "clip-vit-base-patch32"
    vcfg, tcfg = CLIPVisionConfig(**CLIP_B32_VISION), CLIPTextConfig(**CLIP_B32_TEXT)
    spec = {**clip_vision_spec(vcfg), **clip_spec(tcfg)}
    _lin_spec(spec, "visual_projection", vcfg.hidden_size, 512, bias=False)
    _lin_spec(spec, "text_projection", tcfg.hidden_size, 512, bias=False)
    write_dir(writes, "clip_b32", {clip / "model.safetensors": seeded_arrays(spec, 41,
                                                                          torch.float32)})
    hf = {"num_layers": "num_hidden_layers", "num_heads": "num_attention_heads"}
    (clip / "config.json").write_text(json.dumps({
        "projection_dim": 512,
        "vision_config": {hf.get(k, k): v for k, v in CLIP_B32_VISION.items()},
        "text_config": {hf.get(k, k): v for k, v in CLIP_B32_TEXT.items()}}))

    t0 = time.perf_counter()
    arrays = seeded_arrays(inception_spec(), 42, torch.float32)
    for name, t in arrays.items():
        if name.endswith("running_mean"):
            t.sub_(1.0)
        elif name.endswith("conv.weight"):
            t.mul_(2.0 ** 0.5)
    inception = SCORERS / "pt_inception-2015-12-05.pth"
    torch.save({k: v.cpu() for k, v in arrays.items()}, inception)
    writes["pt_inception"] = {"s": time.perf_counter() - t0,
                              "GB": inception.stat().st_size / 1e9}
    log(f"  scorer trees written: {writes}")
    return {"image_reward": ir, "clip": clip, "inception": inception}


def tower_check(name: str, card_fn, cpu_fn, card_in, cpu_in, perturbed) -> dict:
    """`card_fn(card_in)` held to `cpu_fn(cpu_in)` (the same module on the
    CPU, from the same arrays) within tower_tol; the check shown to reject
    the CPU's output on `perturbed` inputs."""
    with torch.inference_mode():
        got, want = card_fn(*card_in), cpu_fn(*cpu_in)
        faulty = cpu_fn(*perturbed)
    err = compare(f"scorers/{name}_card_vs_cpu", got, want.cuda(), tower_tol)
    rejects(f"scorers/{name}_perturbed_input", faulty.cuda(), want.cuda(), tower_tol)
    return {"max_abs_err": err,
            "least_atol_per_std": REPORT["least_atol_per_std"][f"scorers/{name}_card_vs_cpu"]}


def tower_checks(trees: dict, ir_tok, clip_tok) -> tuple[dict, dict]:
    """Each tower on the card against the same module on the CPU, then each
    tower's ms an image at TOWER_BATCHES. Returns (checks, ms a image) and
    leaves the card's ImageReward and CLIP scorers resident in their
    registry slots."""
    from ecad_tpu_torch.scoring import clip_score, image_reward, inception
    from ecad_tpu_torch.scoring.fid import ieee_fp32_context

    gen = torch.Generator().manual_seed(7)
    imgs = torch.randint(0, 256, (TOWER_CHECK_IMAGES, 256, 256, 3), generator=gen,
                         dtype=torch.uint8)
    dark = imgs.clone()
    dark[:, :32] = 0  # the top two rows of ViT-L/16 patches black
    items = json.loads((ROOT / "prompts/ImageRewardPrompts.json").read_text())
    prompts = [it["prompt"] for it in items[:TOWER_CHECK_IMAGES]]
    other = [prompts[0] + " at night", *prompts[1:]]
    checks = {}

    ir = {dev: image_reward.ImageRewardScorer(
        image_reward.load_image_reward(trees["image_reward"] / "ImageReward.pt", dev), ir_tok)
        for dev in ("cuda", "cpu")}
    c, h = ir["cuda"], ir["cpu"]
    px = {dev: s.preprocess(imgs) for dev, s in ir.items()}
    toks = {dev: s.tokenize(prompts) for dev, s in ir.items()}
    vit_c, vit_h = c.model.visual_encoder, h.model.visual_encoder
    checks["image_reward_vit"] = tower_check(
        "image_reward_vit", vit_c, vit_h, (px["cuda"],), (px["cpu"],), (h.preprocess(dark),))
    # the ViT's own forward (without its ieee_fp32 wrapper) with TF32 on
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with torch.inference_mode(), ieee_fp32_context():
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        tf32 = type(vit_c).forward.__wrapped__(vit_c, px["cuda"])
    with torch.inference_mode(), ieee_fp32_context():
        n_bad, _, tf32_share, _ = beyond(tf32, vit_h(px["cpu"]).cuda(), tower_tol)
        ctx = vit_c(px["cuda"])  # the BERT alone, on the same image tokens
    checks["vit_tf32_least_atol_per_std"] = tf32_share
    checks["vit_tf32_elements_beyond_tol"] = n_bad
    log(f"  ViT-L/16 with TF32 on: least atol {tf32_share:.3g}·std, {n_bad} elements beyond "
        "the fp32 tolerance")
    ids_other, _ = h.tokenize(other)
    (ids_c, mask_c), (ids_h, mask_h) = toks["cuda"], toks["cpu"]
    checks["image_reward_bert"] = tower_check(
        "image_reward_bert", c.model.text_encoder, h.model.text_encoder,
        (ids_c, ctx, mask_c), (ids_h, ctx.cpu(), mask_h), (ids_other, ctx.cpu(), mask_h))
    checks["image_reward_score"] = tower_check(
        "image_reward_score", lambda i: c.rewards(i, prompts), lambda i, p=prompts: h.rewards(
            i, p), (imgs.cuda(),), (imgs,), (imgs, other))
    del ir, h, px, ctx, vit_h

    clip = {dev: clip_score.CLIPScorer(*clip_score.load_clip_towers(trees["clip"], dev),
                                       clip_tok) for dev in ("cuda", "cpu")}
    cc, ch = clip["cuda"], clip["cpu"]
    checks["clip_vision"] = tower_check(
        "clip_vision", cc.image_features, ch.image_features, (imgs.cuda(),), (imgs,), (dark,))
    checks["clip_score"] = tower_check(
        "clip_score", lambda i: cc.scores(i, prompts), lambda i, p=prompts: ch.scores(i, p),
        (imgs.cuda(),), (imgs,), (imgs, other))
    del clip, ch

    inc = {dev: inception.InceptionFeatureExtractor.from_weights(trees["inception"], dev)
           for dev in ("cuda", "cpu")}
    checks["inception"] = tower_check(
        "inception", inc["cuda"].features, inc["cpu"].features, (imgs.cuda(),), (imgs,),
        (dark,))
    ic = inc["cuda"]
    del inc

    ms = {}
    for b in TOWER_BATCHES:
        batch = torch.randint(0, 256, (b, 256, 256, 3), generator=gen,
                              dtype=torch.uint8).cuda()
        texts = [items[i % len(items)]["prompt"] for i in range(b)]
        ids, mask = c.tokenize(texts)
        clip_ids = cc.tokenize(texts)
        with torch.inference_mode():
            runs = {"image_reward": lambda: c.model(c.preprocess(batch), ids, mask),
                    "clip": lambda: cc.scores_of_ids(batch, clip_ids),
                    "inception": lambda: ic.features(batch)}
            for name, fn in runs.items():
                ms.setdefault(name, {})[b] = timed_ms(f"scorers/{name}_b{b}", fn, 3, 2) / b
    log(f"  ms an image (256² uint8 on the card, preprocess + towers): {ms}")
    image_reward._RESIDENT, clip_score._RESIDENT = c, cc
    return checks, ms


def scorer_search(ir_dir: Path) -> dict:
    """`genetic.train.main --scorer image_reward --image-reward-dir` at
    PixArt-α 256² served from the checkpoints phase's tree: one cycle, then
    a resume for one more; the launches against the evaluated candidates'
    masks; one candidate evaluated again; the scorer's share of an
    evaluated candidate."""
    import contextlib
    import tempfile

    from ecad_tpu_torch.genetic import train
    from ecad_tpu_torch.genetic.population_io import PixArtPopulationIOManager
    from ecad_tpu_torch.models.pixart import PixArtConfig, schedule_mask_array
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.schedules import PixArtCacheSchedule
    from ecad_tpu_torch.scoring import image_reward

    config = PixArtConfig()
    result = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "ecad_tpu_torch") as tmp:
        pops, bench, name = Path(tmp) / "pops", Path(tmp) / "bench", "ir256"
        seeds = PixArtPopulationIOManager(name, pops, bench, generation_num=0)
        X = np.random.default_rng(1).random((SEARCH_POP, seeds.n_var)) < 0.5
        X[0] = True  # the default schedule
        X[1] = PixArtCacheSchedule.from_json(OURS_FAST).to_numpy(flatten=True)
        seeds.save_population(X, generation=0)
        argv = ["--name", name, "--populations-dir", str(pops), "--benchmarks-dir", str(bench),
                "--population-size", str(SEARCH_POP), "--num-prompts", str(SEARCH_PROMPTS),
                "--num-inference-steps", str(STEPS), "--scorer", "image_reward",
                "--image-reward-dir", str(ir_dir), "--weights-root", str(CKPT),
                "--device", "cuda", "--num-cycles", "1"]
        records, undo = timed_cycles(train)
        env = {k: os.environ.get(k) for k in (image_reward.ENV_CHECKPOINT,
                                              image_reward.ENV_TOKENIZER)}
        reset_launch_counts()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                train.main(argv)
                train.main(argv)  # the resume
        finally:
            undo()
            for k, v in env.items():  # --image-reward-dir set them
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.cuda.synchronize()
        counts = launch_counts()
        cands = search_tree(pops, bench, name, (1, 2), PixArtCacheSchedule)
        if not (pops / name / "gen_003" / "checkpoint.npz").exists():
            raise AssertionError("the resume wrote no gen_003/checkpoint.npz")
        masks = [schedule_mask_array(sc, config) for sc, _ in cands.values()]
        want = search_expected_counts(masks, config, SEARCH_PROMPTS)
        log(f"  launches over both runs {counts}; {len(masks)} candidates say {want}")
        if counts != want:
            raise AssertionError(f"ImageReward search launches {counts} != masks {want}")
        scores = {f"gen_{g:03d}/cand_{i:03d}": sc for (g, i), (_, sc) in cands.items()}
        if len(set(scores.values())) < 2:
            raise AssertionError(f"every candidate scored the same: {scores}")
        evaluator = records["evaluator"]
        again = evaluator.evaluate_candidate(cands[(1, 0)][0])[0]["total_score"]
        if abs(again - cands[(1, 0)][1]) > 1e-6 * max(1.0, abs(again)):
            raise AssertionError(f"gen_001/cand_000 scored {cands[(1, 0)][1]!r}, then {again!r}")
        log(f"  gen_001/cand_000 again: {again!r} (scores.json {cands[(1, 0)][1]!r})")

        # an ours_fast candidate end to end against its scoring alone
        sched = PixArtCacheSchedule.from_json(OURS_FAST)
        masks_fast = schedule_mask_array(sched, config)
        *arrays, prompts, ids = evaluator._noise_batch()
        imgs = evaluator._decode(evaluator._denoiser()(masks_fast, *arrays))
        if not (isinstance(imgs, torch.Tensor) and imgs.is_cuda and imgs.dtype == torch.uint8):
            raise AssertionError(f"decoded images {type(imgs)} are not uint8 on the card")
        cand_ms, score_ms = [], []
        for _ in range(3):
            for runs, fn in ((cand_ms, lambda: evaluator.evaluate_candidate(sched)),
                             (score_ms, lambda: image_reward._RESIDENT(imgs, prompts, ids))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
        images = SEARCH_POP * SEARCH_PROMPTS
        result.update(
            launches=counts, candidates=len(masks), scores=scores,
            same_score_again=again == cands[(1, 0)][1],
            cycle_s=records["cycle_s"], s_per_generation=statistics.median(records["cycle_s"]),
            ms_per_image=statistics.median(records["cycle_s"]) * 1e3 / images,
            candidate_ms=statistics.median(cand_ms), candidate_ms_runs=cand_ms,
            score_ms=statistics.median(score_ms), score_ms_runs=score_ms,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        result["scorer_share"] = result["score_ms"] / result["candidate_ms"]
    log(f"  {result['s_per_generation']:.3f} s a generation, {result['ms_per_image']:.3f} ms an "
        f"evaluated image; an ours_fast candidate {result['candidate_ms']:.3f} ms, of which "
        f"ImageReward {result['score_ms']:.3f} ms ({result['scorer_share']:.4f})")
    del records, evaluator
    return result


def scorer_clis(trees: dict) -> dict:
    """The benchmark tools with the scorer towers over the benchmark
    phase's PNGs (a copy without their mock scores): score_images
    (ImageReward), compute_clip (its default scorer, CLIP), compute_fid
    with the inception and clip_vision extractors."""
    import tempfile

    from ecad_tpu_torch.benchmark import compute_clip, compute_fid, score_images
    from ecad_tpu_torch.scoring import inception

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "ecad_tpu_torch") as tmp:
        images, prompts = Path(tmp) / "images", str(TIER_KEEP / "prompts.json")
        shutil.copytree(TIER_KEEP / "images", images)
        score_images.main(["--image-dir", str(images), "--prompt-file", prompts, "--scorer",
                           "image_reward", "--exactly-n-images", str(TIER_PROMPTS)])
        compute_clip.main(["--image-dir", str(images), "--prompt-file", prompts])
        for name in TIER_SCHEDULES:
            for file, key in (("scores.json", "image_reward"), ("clip_scores.json", "clip")):
                r = json.loads((images / name / file).read_text())
                vals = [v for vs in r["score_by_prompt_id"].values() for v in vs]
                if len(vals) != TIER_PROMPTS or not all(np.isfinite(vals)):
                    raise AssertionError(f"{name}/{file}: {r['score_by_prompt_id']}")
                if key == "clip" and not all(0 <= v <= 100 for v in vals):
                    raise AssertionError(f"{name}/{file}: CLIP scores outside [0, 100]")
                out.setdefault(key, {})[name] = r["total_score"]
        os.environ[inception.ENV_CHECKPOINT] = str(trees["inception"])
        try:
            for extractor, dim in (("inception", 2048), ("clip_vision", 768)):
                stats = Path(tmp) / f"{extractor}.npz"
                compute_fid.main(["--image-dir", str(images / "default"), "--stats", str(stats),
                                  "--make-stats", "--extractor", extractor])
                compute_fid.main(["--image-dir", str(images / "ours_fast"), "--stats",
                                  str(stats), "--extractor", extractor])
                r = json.loads((images / "ours_fast" / "fid_scores.json").read_text())
                with np.load(stats) as st:
                    mu = st["mu"].shape
                if (mu != (dim,) or r["n_images"] != TIER_PROMPTS or r["extractor"] != extractor
                        or not np.isfinite(r["fid"])):
                    raise AssertionError(f"compute_fid {extractor}: {r}, mu {mu}")
                out[f"fid_{extractor}"] = r["fid"]
        finally:
            os.environ.pop(inception.ENV_CHECKPOINT)
            inception._RESIDENT = None
    log(f"  the tools over the tier's PNGs: {out}")
    return out


def scorers_phase(smi: str) -> dict:
    """The `scorers` phase: seeded full-width scorer checkpoints; each
    tower on the card against the CPU; the benchmark tools with the towers;
    the search scored by ImageReward at PixArt-α 256² from the checkpoint
    tree. Deletes the tree when it ends."""
    from ecad_tpu_torch.scoring import clip_score, image_reward

    log("scorers phase: ImageReward, CLIP ViT-B/32 and InceptionV3 at full width")
    writes = {}
    result = {"card": smi}
    try:
        trees = write_scorer_trees(writes)
        result["writes"] = writes
        ir_tok = WordHashTokenizer(BERT_VOCAB, eos=102, pad=0, bos=101)
        clip_tok = WordHashTokenizer(CLIP_B32_TEXT["vocab_size"], eos=49407, pad=0, bos=49406)
        result["checks"], result["ms_per_image"] = tower_checks(trees, ir_tok, clip_tok)
        result["clis"] = scorer_clis(trees)
        result["search"] = scorer_search(trees["image_reward"])
    finally:
        image_reward._RESIDENT = clip_score._RESIDENT = None
        shutil.rmtree(CKPT, ignore_errors=True)
        shutil.rmtree(TIER_KEEP, ignore_errors=True)
        torch.cuda.empty_cache()
    return result


def scorers_line(r: dict, seconds: float) -> dict:
    """The phase's numbers for a line of their own."""
    s = r["search"]
    return {"scorers": {
        "card": r["card"],
        "ms_per_image_256_uint8": r["ms_per_image"],
        "card_vs_cpu_max_abs_err": {k: v["max_abs_err"] for k, v in r["checks"].items()
                                    if isinstance(v, dict)},
        "vit_tf32_least_atol_per_std": r["checks"]["vit_tf32_least_atol_per_std"],
        "search_image_reward": {
            "s_per_generation": s["s_per_generation"], "ms_per_image": s["ms_per_image"],
            "candidate_ms": s["candidate_ms"], "score_ms": s["score_ms"],
            "scorer_share": s["scorer_share"], "launches": s["launches"],
            "peak_mem_gib": s["peak_mem_gib"]},
        "tools": r["clis"],
        "phase_s": seconds,
    }}


SEARCH_POP = 8  # PixArt search: candidates a generation
SEARCH_PROMPTS = 4
SEARCH_FLUX_POP = 4


def search_kernel_checks(label: str, attention_shapes, norm_shape) -> dict:
    """K1 and K3 on the card at the shapes a search path gives them (its
    batch of prompts; no text mask, so every attention there takes the
    exact single-tile route), each held to its plain version within
    BF16_TOL. These launches come before the counted run."""
    from ecad_tpu_torch.ops import (
        fused_attention,
        fused_attention_reference,
        modulated_layer_norm,
        modulated_layer_norm_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    errs = {}
    for b, tq, tk, h, d in attention_shapes:
        if attention_counter((b, tq, h, d), tk) != "attention":
            raise AssertionError(f"{label}: {b}×{tq}→{tk} left the exact route")
        q, k, v = rnd(b, tq, h, d), rnd(b, tk, h, d), rnd(b, tk, h, d)
        name = f"attention/bf16/{label}_{b}x{tq}x{tk}_d{d}"
        errs[name] = compare(name, fused_attention(q, k, v),
                             fused_attention_reference(q, k, v), BF16_TOL)
    b, t, dim = norm_shape
    x, mods = rnd(b, t, dim), rnd(b, 6, dim) * 0.1
    name = f"modlnorm/bf16/{label}_{b}x{t}x{dim}"
    errs[name] = compare(name, modulated_layer_norm(x, mods[:, 1:2], mods[:, 0:1]),
                         modulated_layer_norm_reference(x, mods[:, 1:2], mods[:, 0:1]),
                         BF16_TOL)
    return errs


def search_tree(pops: Path, bench: Path, name: str, generations, cls) -> dict:
    """Checks a search's files: every candidate of each evaluated
    generation has a scores.json with a finite total_score and the port's
    analytic MACs (computed here, on the CPU) as its JSON's total_macs_T.
    Returns {(generation, index): (schedule, total_score)}."""
    from ecad_tpu_torch.macs import compute_schedule_metrics

    out = {}
    for g in generations:
        paths = sorted((pops / name / f"gen_{g:03d}" / "candidates").glob("cand_*.json"))
        if not paths:
            raise AssertionError(f"{name}: generation {g} has no candidates")
        for path in paths:
            sched = cls.from_json(path)
            macs = json.loads(path.read_text())["metrics"]["total_macs_T"]
            want = compute_schedule_metrics(sched)["total_macs_T"]
            if macs != want:
                raise AssertionError(f"{path}: total_macs_T {macs} != {want}")
            score_file = bench / name / f"gen_{g:03d}" / "candidates" / path.stem / "scores.json"
            score = json.loads(score_file.read_text())["total_score"]
            if not np.isfinite(score):
                raise AssertionError(f"{score_file}: total_score {score}")
            out[(g, int(path.stem.split("_")[1]))] = (sched, score)
    return out


def timed_cycles(train_module):
    """Wraps `train_one_cycle` of ``ecad_tpu_torch.genetic.train`` (which
    `main` looks up at each call) to record each cycle's seconds, device
    work included, and the evaluator it ran; returns (records, undo)."""
    records = {"cycle_s": [], "evaluator": None}
    inner = train_module.train_one_cycle

    def timed(args, manager, algo, evaluator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(args, manager, algo, evaluator)
        torch.cuda.synchronize()
        records["cycle_s"].append(time.perf_counter() - t0)
        records["evaluator"] = evaluator

    train_module.train_one_cycle = timed
    return records, lambda: setattr(train_module, "train_one_cycle", inner)


def profile_candidate(evaluator, sched, n_images: int) -> dict:
    """One candidate's evaluation (its trajectory and fidelity score, the
    reference trajectory already kept): wall ms of three synchronized runs,
    then one profiled run (`profile_trajectory`) for the device's idle
    share."""
    evaluator.evaluate_candidate(sched)  # the reference trajectory, once
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.evaluate_candidate(sched)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(runs)
    prof = profile_trajectory(lambda: evaluator.evaluate_candidate(sched), wall)
    return {"ms": wall, "ms_runs": runs, "ms_per_img": wall / n_images, "profile": prof}


def search_path() -> dict:
    """ECAD's search loop at full width: `ecad_tpu_torch.genetic.train.main`
    in this process on the card, PixArt-α 256² (28 blocks, d=1152) with
    seeded random bf16 weights and random prompt embeddings, 20 steps, the
    weight-free fidelity scorer, 8 candidates × 4 prompts a generation:
    gen 0 seeded with the default schedule, ``ours_fast`` and six random
    genomes, one cycle, then a resume for one more. Checks K1 and K3 at
    the search's shapes against their plain versions, the files, the MACs,
    the default candidate's exact 200 dB, ``ours_fast`` below it, and that
    the launch counts over both runs equal the sum of every evaluated
    candidate's masks plus each run's reference trajectory."""
    import contextlib
    import tempfile

    from ecad_tpu_torch.genetic import train
    from ecad_tpu_torch.genetic.population_io import PixArtPopulationIOManager
    from ecad_tpu_torch.models.pixart import PixArtConfig, schedule_mask_array
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log(f"search: genetic.train.main, PixArt-α 256² full width, {SEARCH_POP} candidates "
        f"× {SEARCH_PROMPTS} prompts, a cycle and a resume")
    config = PixArtConfig()
    b2 = 2 * SEARCH_PROMPTS  # CFG doubles the prompts
    result = {"kernel_errors": search_kernel_checks(
        "search_pixart256",
        [(b2, config.tokens, tk, config.num_heads, config.head_dim)
         for tk in (config.tokens, config.text_len)],
        (b2, config.tokens, config.dim))}

    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "ecad_tpu_torch") as tmp:
        pops, bench, name = Path(tmp) / "pops", Path(tmp) / "bench", "search256"
        seeds = PixArtPopulationIOManager(name, pops, bench, generation_num=0)
        X = np.random.default_rng(0).random((SEARCH_POP, seeds.n_var)) < 0.5
        X[0] = True  # the default schedule
        X[1] = PixArtCacheSchedule.from_json(OURS_FAST).to_numpy(flatten=True)
        seeds.save_population(X, generation=0)
        argv = ["--name", name, "--populations-dir", str(pops), "--benchmarks-dir", str(bench),
                "--population-size", str(SEARCH_POP), "--num-prompts", str(SEARCH_PROMPTS),
                "--num-inference-steps", str(STEPS), "--scorer", "fidelity", "--device", "cuda"]
        records, undo = timed_cycles(train)
        reset_launch_counts()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                train.main([*argv, "--num-cycles", "1"])
                if not (pops / name / "gen_002" / "checkpoint.npz").exists():
                    raise AssertionError("no gen_002/checkpoint.npz after one cycle")
                train.main([*argv, "--num-cycles", "1"])
        finally:
            undo()
        torch.cuda.synchronize()
        counts = launch_counts()
        cands = search_tree(pops, bench, name, (1, 2), PixArtCacheSchedule)
        if not (pops / name / "gen_003" / "checkpoint.npz").exists():
            raise AssertionError("the resume wrote no gen_003/checkpoint.npz")
        masks = [schedule_mask_array(s, config) for s, _ in cands.values()]
        reference = np.ones((STEPS, config.num_blocks, 3), dtype=bool)
        want = search_expected_counts(masks + [reference] * 2, config, SEARCH_PROMPTS)
        log(f"  launches over both runs {counts}; {len(masks)} candidates + 2 reference "
            f"trajectories say {want}")
        if counts != want:
            raise AssertionError(f"search launches {counts} != candidates' masks {want}")
        default, fast = cands[(1, 0)][1], cands[(1, 1)][1]
        log(f"  default candidate {default!r} dB, ours_fast {fast!r} dB")
        if default != 200.0:
            raise AssertionError(f"the default candidate scored {default!r} dB, not 200")
        if not fast < 200.0:
            raise AssertionError(f"ours_fast scored {fast!r} dB")
        per_cand = [search_expected_counts([m], config, SEARCH_PROMPTS) for m in masks]
        images = SEARCH_POP * SEARCH_PROMPTS
        result.update(
            launches=counts,
            candidates=len(masks),
            default_db=default,
            ours_fast_db=fast,
            scores_db={f"gen_{g:03d}/cand_{i:03d}": sc for (g, i), (_, sc) in cands.items()},
            launches_per_candidate={k: statistics.mean(c[k] for c in per_cand)
                                    for k in ("attention", "modlnorm")},
            cycle_s=records["cycle_s"],
            s_per_generation=statistics.median(records["cycle_s"]),
            ms_per_image=statistics.median(records["cycle_s"]) * 1e3 / images,
        )
        result["candidate"] = profile_candidate(
            records["evaluator"], PixArtCacheSchedule.from_json(OURS_FAST), SEARCH_PROMPTS)
    log(f"  {result['s_per_generation']:.3f} s a generation (cycles {records['cycle_s']}), "
        f"{result['ms_per_image']:.3f} ms an evaluated image; one ours_fast candidate "
        f"{result['candidate']['ms']:.3f} ms, device idle share "
        f"{result['candidate']['profile']['idle_share']:.4f}")
    del records
    torch.cuda.empty_cache()
    return result


def main_path_1024() -> dict:
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.models.vae import random_decoder_pipeline
    from ecad_tpu_torch.pipelines import (
        PixArtPipeline,
        PixArtPipelineConfig,
        pipeline_from_config,
    )
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log("main path: PixArt-α 1024, full width, batch 2, 20 steps")
    REPORT["tiny_trajectory_1024"] = small_reference_check(1024)
    config = PixArtConfig(sample_size=128, use_additional_conditions=True)
    t0 = time.perf_counter()
    model = init_model(config, 0, "cuda")
    vae = random_decoder_pipeline(4, "cuda")
    torch.cuda.synchronize()
    REPORT["init_1024_s"] = time.perf_counter() - t0
    pcfg = PixArtPipelineConfig(model=config, num_inference_steps=STEPS)
    tgate = PixArtCacheSchedule.from_json(TGATE_1024)
    tgate_cls, tgate_kwargs = pipeline_from_config(
        tgate.top_level_config["pipeline"]["name"],
        tgate.top_level_config["pipeline"]["kwargs"],
    )
    pipes = {
        "default": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(DEFAULT_1024)),
        "ours_fast": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(OURS_FAST)),
        "tgate": tgate_cls(pcfg, model, tgate, **tgate_kwargs),
    }
    result = drive(pipes, path_inputs(config, BATCH_1024), vae.decode_device,
                   BATCH_1024, 1024, lambda pipe: expected_counts(pipe.masks, 1024),
                   order=("default", "ours_fast", "tgate", "tgate", "ours_fast", "default"),
                   kernels=SERVED_KERNELS["pixart1024"])
    for name in ("ours_fast", "tgate"):
        result[f"speedup_{name}"] = (
            result["default"]["ms_per_img"] / result[name]["ms_per_img"]
        )
    log(f"  ratio default / ours_fast {result['speedup_ours_fast']:.4f}, "
        f"default / tgate {result['speedup_tgate']:.4f}")
    del model, vae, pipes
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# serving quantization
# ---------------------------------------------------------------------------

# the int8 product at served shapes, (rows, in, out): PixArt-1024's
# projections at CFG batch 4 (q, k, v and out; ff in; ff out), FLUX-1024's
# joint stream (q, k, v; proj_mlp; proj_out) and its adaLN linear at batch 1
# (one row, padded to 17)
INT8_SHAPES = {
    "pixart1024_qkvo": (16384, 1152, 1152),
    "pixart1024_ff_in": (16384, 1152, 4608),
    "pixart1024_ff_out": (16384, 4608, 1152),
    "flux1024_joint_qkv": (4608, 3072, 3072),
    "flux1024_proj_mlp": (4608, 3072, 12288),
    "flux1024_proj_out": (4608, 15360, 3072),
    "flux1024_adanorm": (1, 3072, 18432),
}


def int8_product_checks() -> dict:
    """At each served shape: the int8 product (`int8_matmul`, one
    ``torch._int_mm``) equal to the float64 product of the same int8
    operands (exact: every sum is far below 2^53), and its device ms beside
    its bound (int8 operations at 1,979 TOP/s, or bytes), one bf16
    ``F.linear`` of the same shape, and the whole `int8_linear` (quantize,
    product, dequant) with its weight already quantized."""
    from torch.nn import functional as F

    from ecad_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, (m, k, n) in INT8_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        bias = torch.zeros(n, device="cuda", dtype=torch.bfloat16)
        wq = quant.quantize_weight(w)
        xq, _ = quant.quantize_int8(x, -1)
        acc = quant.int8_matmul(xq, wq[0])
        if not torch.equal(acc.double(), xq.double() @ wq[0].double().t()):
            raise AssertionError(f"int8 product at {name} {(m, k, n)} is not exact")
        tb = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S
        tf = 2 * m * k * n / INT8_OPS
        rows[name] = {
            "shape": (m, k, n),
            "int8_ms": timed_ms(f"int8_{name}", lambda: quant.int8_matmul(xq, wq[0])),
            "bound_ms": max(tb, tf) * 1e3, "bound_by": "bytes" if tb >= tf else "operations",
            "bf16_linear_ms": timed_ms(f"bf16_linear_{name}", lambda: F.linear(x, w, bias)),
            "int8_linear_ms": timed_ms(f"int8_linear_{name}",
                                       lambda: quant.int8_linear(x, w, bias, weight_q=wq)),
            "int8_linear_rel_err": rel_err(quant.int8_linear(x, w, bias, weight_q=wq),
                                           F.linear(x, w, bias)),
        }
        log(f"  int8 product {name} {(m, k, n)}: exact; {rows[name]}")
    return rows


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖, in fp32 (the reference's tests' `_rel_err`)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-9))


def weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def quant_variant(model, gen, quant: str) -> tuple:
    """`model`'s architecture in a quant mode on its own weights (`rebuild`:
    int8 and int8_static share them; int8_w quantizes float weights and
    shares int8 ones); a static mode calibrated by the generator's
    `_calibrate_static_scales` on the variant first. Returns the model and
    the calibration's seconds (None for a dynamic mode)."""
    from ecad_tpu_torch.models.common import rebuild

    config = dataclasses.replace(model.config, quant=quant, act_scales=None)
    variant = rebuild(model, config)
    if quant not in STATIC_MODES:
        return variant, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = gen._calibrate_static_scales(variant)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"  {quant}: calibrated {len(table)} sites in {seconds:.2f} s")
    return rebuild(model, dataclasses.replace(config, act_scales=table)), seconds


def quant_runs(label: str, pipes: dict, inputs: dict, batch: int, want_counts,
               turns: int, profiled: tuple = (), ref=None) -> dict:
    """`turns` synchronized passes over the modes' pipelines, each pass in
    the reverse order of the one before; ms/img the median of each mode's.
    In the first pass the launch counters are set to 0 just before each run
    and read just after (checked against `want_counts(pipe, mode)`), the
    peak memory is reset just before, and the final latents are kept for
    their relative error against bf16's (``pipes["bf16"]``'s, or `ref`).
    One profiled run of each quant mode named in `profiled` (bf16's is the
    main paths'), split by quant part (`quant_split`), which must show the
    int8 product, the quantize and the dequant. Denoise only: the VAE
    decode is the same in every mode."""
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts

    result, latents = {}, {}
    times = {mode: [] for mode in pipes}
    modes = list(pipes)
    for turn in range(turns):
        for mode in modes if turn % 2 == 0 else modes[::-1]:
            torch.cuda.synchronize()
            if turn == 0:
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
            t0 = time.perf_counter()
            out = pipes[mode].denoise(**inputs)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3 / batch)
            if turn == 0:
                counts = launch_counts()
                check_counts(f"{label} {mode}", counts, want_counts(pipes[mode], mode))
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"{label} {mode}: non-finite latents")
                latents[mode] = out
                result[mode] = {"launches": counts,
                                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    ref = latents["bf16"] if ref is None else ref
    for mode in pipes:
        result[mode]["latents_rel_err"] = rel_err(latents[mode], ref)
        result[mode]["ms_per_img"] = statistics.median(times[mode])
        result[mode]["ms_per_img_runs"] = times[mode]
    for mode, pipe in pipes.items():
        if mode in profiled:
            prof = profile_trajectory(lambda: pipe.denoise(**inputs),
                                      result[mode]["ms_per_img"] * batch, split=True)
            result[mode]["profile"] = prof
            parts = prof["split"]["device_ms"]
            if not all(parts.get(p, 0) > 0 for p in QUANT_SPANS):
                raise AssertionError(f"{label} {mode}: the profile misses a quant part: {parts}")
    for mode in pipes:
        r = result[mode]
        log(f"  {label} {mode}: {r['ms_per_img']:.3f} ms/img (runs {r['ms_per_img_runs']}), "
            f"latents rel err {r['latents_rel_err']:.4g}, peak {r['peak_mem_gib']:.2f} GiB"
            + (f", split {r['profile']['split']}" if "profile" in r else ""))
    return result


def quant_path() -> dict:
    """PixArt-α 1024² at full width (random bf16 weights), batch 2 with CFG,
    20 steps under ``default_1024x1024`` and ``ours_fast``: bf16 and the
    four quant modes on the same weights (int8_w quantized from the bf16
    model, each static mode calibrated by the generator), each mode's
    launches (K4, K3 and the int8 products) checked against the masks, its
    one-forward and final-latents error against bf16, ms/img from one
    synchronized pass with bf16 (the checked runs), peak memory, and one
    profiled ``ours_fast`` run of each quant mode split into the int8
    product, the quantize and dequant passes, the bf16 GEMMs and the
    rest. The int8 product itself is first checked exact at every served
    shape and timed against one bf16 ``F.linear``."""
    from ecad_tpu_torch.image_generators.pixart import PixArtAlphaImageGenerator
    from ecad_tpu_torch.models.common import rebuild
    from ecad_tpu_torch.models.pixart import PixArtConfig, full_step_mask, init_cache, init_model
    from ecad_tpu_torch.ops.quant import calibrate_dense_amax, merge_amax
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log("quant: the int8 product at the served shapes")
    result = {"int8_products": int8_product_checks()}
    log("quant: PixArt-α 1024, full width, batch 2, 20 steps, bf16 and "
        f"{', '.join(QUANT_MODES)}")
    config = PixArtConfig(sample_size=128, use_additional_conditions=True)
    models = {"bf16": init_model(config, 0, "cuda")}
    gen = PixArtAlphaImageGenerator(schedule_path=DEFAULT_1024, random_weights=True,
                                    device="cuda")
    result["calibration_s"] = {}
    for mode in QUANT_MODES:
        base = models["int8_w"] if mode == "int8_w_static" else models["bf16"]
        models[mode], seconds = quant_variant(base, gen, mode)
        if seconds is not None:
            result["calibration_s"][mode] = seconds
    result["weight_bytes"] = {m: weight_bytes(models[m]) for m in ("bf16", "int8_w")}

    # served as the generator serves them: its encoder's embeddings and text
    # masks (the statistics the static modes were calibrated on), seeded noise
    entries = gen.encode_prompts(["a red bicycle leaning on a wall", "a bowl of ramen"])
    noise_gen = torch.Generator(device="cuda").manual_seed(0)
    inp = dict(
        noise=torch.randn((BATCH_1024, config.sample_size, config.sample_size,
                           config.in_channels), generator=noise_gen,
                          device="cuda").to(config.dtype),
        text=gen._stack(entries, "prompt_embeds", config.dtype),
        neg=gen._stack(entries, "negative_prompt_embeds", config.dtype),
        text_mask=gen._stack(entries, "prompt_attention_mask"),
        neg_mask=gen._stack(entries, "negative_prompt_attention_mask"))
    # one forward at t = 500 of every block: each mode against bf16 (and
    # the int8 weights of the int8 modes quantized before any timed run)
    b2 = 2 * BATCH_1024
    args = (torch.cat([inp["noise"]] * 2), torch.cat([inp["neg"], inp["text"]]),
            torch.full((b2,), 500.0, device="cuda"), init_cache(config, b2),
            full_step_mask(config))
    kwargs = dict(text_mask=torch.cat([inp["neg_mask"], inp["text_mask"]]),
                  resolution=torch.full((b2, 2), 1024.0, device="cuda"),
                  aspect_ratio=torch.ones((b2,), device="cuda"))
    with torch.inference_mode():
        want = models["bf16"](*args, **kwargs)[0]
        result["forward_rel_err"] = {
            m: rel_err(models[m](*args, **kwargs)[0], want) for m in QUANT_MODES}
    log(f"  one forward, rel err against bf16: {result['forward_rel_err']}")
    # the generator calibrates as the reference does, without the text mask
    # that the served cross-attention takes; the same recipe with the
    # encoder's masks, for comparison (the modes keep the reference's)
    cal = gen.encode_prompts(["a detailed photograph"])
    cal_args = (inp["noise"], torch.cat([gen._stack(cal, "negative_prompt_embeds", config.dtype),
                                         gen._stack(cal, "prompt_embeds", config.dtype)]))
    cal_kwargs = dict(text_mask=torch.cat([gen._stack(cal, "negative_prompt_attention_mask"),
                                           gen._stack(cal, "prompt_attention_mask")]),
                      resolution=kwargs["resolution"][:2], aspect_ratio=kwargs["aspect_ratio"][:2])
    table = merge_amax(*(
        calibrate_dense_amax(models["bf16"], *cal_args, torch.full((2,), t, device="cuda"),
                             init_cache(config, 2), full_step_mask(config), **cal_kwargs)
        for t in (999.0, 500.0, 20.0)))
    masked = rebuild(models["bf16"], dataclasses.replace(
        config, quant="int8_static", act_scales=tuple(sorted(table.items()))))
    with torch.inference_mode():
        result["forward_rel_err_masked_calibration"] = rel_err(masked(*args, **kwargs)[0], want)
    del masked
    log("  int8_static calibrated with the text masks, one forward: rel err "
        f"{result['forward_rel_err_masked_calibration']:.4g}")

    modes = ("bf16", *QUANT_MODES)
    for name, path, turns, profiled in (("ours_fast", OURS_FAST, 1, QUANT_MODES),
                                        ("default", DEFAULT_1024, 1, ())):
        sched = PixArtCacheSchedule.from_json(path)
        pipes = {m: PixArtPipeline(PixArtPipelineConfig(model=models[m].config,
                                                        num_inference_steps=STEPS),
                                   models[m], sched) for m in modes}
        result[name] = quant_runs(
            f"PixArt-1024 {name}", pipes, inp, BATCH_1024,
            lambda pipe, mode: expected_counts(pipe.masks, 1024, None if mode == "bf16" else mode),
            turns, profiled)
    del models, pipes
    torch.cuda.empty_cache()
    return result


def quant_summary(pixart: dict, flux: dict) -> dict:
    """The quant runs' numbers for the summary line: per size, schedule and
    mode ms/img, the latents' error against bf16, peak GiB and int8
    products; each profiled run's device ms by part."""
    def runs(r, schedules):
        return {s: {m: {"ms_per_img": v["ms_per_img"], "latents_rel_err": v["latents_rel_err"],
                        "peak_mem_gib": v["peak_mem_gib"],
                        "int8_matmul": v["launches"]["int8_matmul"],
                        **({"split_ms": v["profile"]["split"]["device_ms"]}
                           if "profile" in v else {})}
                    for m, v in r[s].items()} for s in schedules}

    return {
        "pixart1024": {**runs(pixart, ("ours_fast", "default")),
                       **{k: pixart[k] for k in ("calibration_s", "forward_rel_err",
                                                 "forward_rel_err_masked_calibration",
                                                 "weight_bytes")}},
        "flux1024": {**runs(flux, ("fast", "default")),
                     **{k: flux[k] for k in ("calibration_s", "weight_bytes", "seconds")}},
        "int8_products": {k: {f: v[f] for f in ("int8_ms", "bound_ms", "bf16_linear_ms",
                                                "int8_linear_ms")}
                          for k, v in pixart["int8_products"].items()},
    }


def flux_quant(holder: list, config, inputs, bf16_latents: dict) -> dict:
    """FLUX.1-dev 1024² at batch 1 in int8_w and int8_w_static, made from the
    flux phase's resident bf16 model (``holder``'s one item, dropped once
    int8_w is made from it, so that the two never serve side by side), under
    the default and ``fast_256_to_1024``: launches (K5, K3, the int8
    products, the adaLN linears' among them) checked, the final latents
    against the flux phase's bf16 ones at the same noise, one timed run
    each, the checked one (the device is busy > 92 % there), peak memory,
    weight bytes, and one profiled ``fast`` run of int8_w split by quant
    part (int8_w_static's profile differs from it only in the quantize
    pass, as PixArt's show; profiling it too pushed the run past 900 s)."""
    from ecad_tpu_torch.image_generators.flux import FluxImageGenerator
    from ecad_tpu_torch.pipelines import FluxPipeline, FluxPipelineConfig
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    log("quant: FLUX.1-dev 1024², batch 1, int8_w and int8_w_static")
    t0 = time.perf_counter()
    model = holder.pop()
    gen = FluxImageGenerator(schedule_path=FLUX_DEFAULT_1024, random_weights=True,
                             device="cuda")
    result = {"weight_bytes": {"bf16": weight_bytes(model)}}
    w8, _ = quant_variant(model, gen, "int8_w")
    del model
    torch.cuda.empty_cache()
    ws, result["calibration_s"] = quant_variant(w8, gen, "int8_w_static")
    result["weight_bytes"]["int8_w"] = weight_bytes(w8)
    models = {"int8_w": w8, "int8_w_static": ws}
    load = FluxCacheSchedule.from_json
    for name, sched in (("default", load(FLUX_DEFAULT_1024)), ("fast", load(FLUX_FAST_1024))):
        pipes = {m: FluxPipeline(FluxPipelineConfig(model.config, STEPS, guidance_scale=5.0,
                                                    height=1024, width=1024), model, sched)
                 for m, model in models.items()}
        result[name] = quant_runs(
            f"FLUX-1024 {name}", pipes, inputs(BATCH_FLUX_1024, pipes["int8_w"].config),
            BATCH_FLUX_1024,
            lambda pipe, mode: flux_expected_counts(pipe.masks, config.num_blocks,
                                                    "attention_rowblock", mode),
            1, ("int8_w",) if name == "fast" else (), ref=bf16_latents[name])
    del models, pipes, w8, ws
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    log(f"  FLUX-1024 weights {result['weight_bytes']} bytes; {result['seconds']:.1f} s")
    return result


def main_path_2048() -> dict:
    """Full-width PixArt-Σ at 2048² (the 2K checkpoint's shapes: a 256×256
    latent, 16384 image tokens, no size conditions), batch 1 with CFG, 20
    steps under Σ's default and ``ours_fast`` (the paper's 256² schedule
    served at 2048²), each decoded by the random VAE to 2048² uint8."""
    from ecad_tpu_torch.models.pixart import PixArtConfig, init_model
    from ecad_tpu_torch.models.vae import random_decoder_pipeline
    from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    log("main path: PixArt-Σ 2048, full width, batch 1, 20 steps")
    REPORT["tiny_trajectory_2048"] = small_reference_check(2048)
    config = PixArtConfig(sample_size=256)
    t0 = time.perf_counter()
    model = init_model(config, 0, "cuda")
    vae = random_decoder_pipeline(4, "cuda")
    torch.cuda.synchronize()
    REPORT["init_2048_s"] = time.perf_counter() - t0
    pcfg = PixArtPipelineConfig(model=config, num_inference_steps=STEPS)
    pipes = {
        "default": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(SIGMA_DEFAULT)),
        "ours_fast": PixArtPipeline(pcfg, model, PixArtCacheSchedule.from_json(SIGMA_OURS_FAST)),
    }
    # one timed run each: the device is busy > 99 % of the wall time there
    result = drive(pipes, path_inputs(config, BATCH_2048), vae.decode_device,
                   BATCH_2048, 2048, lambda pipe: expected_counts(pipe.masks, 2048),
                   order=("default", "ours_fast"), kernels=SERVED_KERNELS["pixart2048"])
    result["speedup"] = result["default"]["ms_per_img"] / result["ours_fast"]["ms_per_img"]
    log(f"  ratio default / ours_fast {result['speedup']:.4f}")
    del model, vae, pipes
    torch.cuda.empty_cache()
    return result


def small_flux_check() -> dict:
    """A tiny fp32 FLUX trajectory (head dim 128, a 32×32 packed grid plus
    512 text tokens = 1536 joint tokens, so that its attention takes the
    row-block route) through the kernels on the card against the same
    weights and noise through the plain versions on the CPU; 8 steps under
    a seeded mask that reuses a third of the slots."""
    from ecad_tpu_torch.models.flux import FluxConfig, init_model
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines import FluxPipeline, FluxPipelineConfig
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    cfg = FluxConfig.tiny(dtype=torch.float32, num_heads=2, head_dim=128,
                          axes_dims=(16, 56, 56), text_len=512)
    steps = 8
    cpu_model = init_model(cfg, 3, "cpu")
    gpu_model = init_model(cfg, 3, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(0)
    n_slots = (cfg.num_blocks + cfg.num_single_blocks) * 3
    sched = FluxCacheSchedule.from_numpy(
        rng.random(steps * n_slots) < 0.67, steps, cfg.num_blocks,
        num_single_blocks=cfg.num_single_blocks,
    )
    pcfg = FluxPipelineConfig(cfg, steps, height=512, width=512)
    noise = torch.from_numpy(
        rng.standard_normal((2, pcfg.image_seq_len, cfg.in_channels), dtype=np.float32))
    txt = torch.from_numpy(
        rng.standard_normal((2, cfg.text_len, cfg.joint_dim), dtype=np.float32))
    pooled = torch.from_numpy(rng.standard_normal((2, cfg.pooled_dim), dtype=np.float32))
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        pipe = FluxPipeline(pcfg, model, sched)
        reset_launch_counts()
        outs.append(pipe.denoise(*(a.to(dev) for a in (noise, txt, pooled))).cpu())
    counts = launch_counts()
    err = float((outs[0] - outs[1]).abs().max())
    scale = float(outs[0].abs().max())
    log(f"  tiny fp32 FLUX trajectory (1536 joint tokens, D=128), card kernels vs CPU "
        f"plain: max err {err:.3g} of max |latent| {scale:.3g}; card launches {counts}")
    if not (counts["attention_rowblock"] > 0 and counts["modlnorm"] > 0):
        raise AssertionError(f"tiny FLUX trajectory missed a kernel: {counts}")
    # fp32 throughout (TF32 off); only summation orders differ, over 8 steps
    # of 5 blocks on O(1) latents
    limit = 1e-4 * max(1.0, scale)
    if not err <= limit:
        raise AssertionError(f"tiny FLUX trajectory mismatch {err} > {limit}")
    return {"max_err": err, "max_abs_latent": scale, "launches": counts}


def flux_search(model, config, enc) -> dict:
    """One cycle of ECAD's search loop on the flux phase's resident
    full-width FLUX.1-dev at 256²: a `FluxCandidateEvaluator` with the
    fidelity scorer, 4 candidates (the default, ``flux_256/ours_fast``, two
    random genomes) × 1 hash-encoder prompt, through `train_one_cycle`.
    Checks as `search_path`'s, the launches against `flux_expected_counts`
    summed over the candidates and the reference trajectory."""
    import argparse
    import contextlib
    import tempfile

    from ecad_tpu_torch.genetic import train
    from ecad_tpu_torch.genetic.evaluate import EvalConfig, FluxCandidateEvaluator
    from ecad_tpu_torch.genetic.nsga2 import NSGA2
    from ecad_tpu_torch.genetic.population_io import FluxPopulationIOManager
    from ecad_tpu_torch.models.flux import flux_step_masks, full_flux_mask
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from ecad_tpu_torch.pipelines import FluxPipeline, FluxPipelineConfig
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    log(f"  search: one cycle, {SEARCH_FLUX_POP} candidates × 1 prompt at 256²")
    pcfg = FluxPipelineConfig(config, STEPS, guidance_scale=5.0, height=256, width=256)
    joint = pcfg.image_seq_len + config.text_len
    result = {"kernel_errors": search_kernel_checks(
        "search_flux256", [(1, joint, joint, config.num_heads, config.head_dim)],
        (1, joint, config.dim))}
    text, pooled = enc.encode("a red bicycle leaning on a wall")
    evaluator = FluxCandidateEvaluator(
        FluxPipeline(pcfg, model),
        torch.from_numpy(text[None]).to("cuda", config.dtype),
        torch.from_numpy(pooled[None]).to("cuda", config.dtype),
        ["prompt_0"], EvalConfig(scorer="fidelity", return_images=False),
    )
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "ecad_tpu_torch") as tmp:
        pops, bench, name = Path(tmp) / "pops", Path(tmp) / "bench", "search_flux256"
        manager = FluxPopulationIOManager(name, pops, bench, population_size=SEARCH_FLUX_POP)
        X = np.random.default_rng(1).random((SEARCH_FLUX_POP, manager.n_var)) < 0.5
        X[0] = True
        X[1] = FluxCacheSchedule.from_json(FLUX_OURS_FAST_256).to_numpy(flatten=True)
        algo = NSGA2(n_var=manager.n_var, pop_size=SEARCH_FLUX_POP, seed=0)
        manager.save_population(algo.initialize(X))
        manager.save_config()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            train.train_one_cycle(argparse.Namespace(print_not_submit=False), manager, algo,
                                  evaluator)
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        counts = launch_counts()
        if not (pops / name / "gen_002" / "checkpoint.npz").exists():
            raise AssertionError("no gen_002/checkpoint.npz after the FLUX cycle")
        cands = search_tree(pops, bench, name, (1,), FluxCacheSchedule)
        per_cand = [flux_expected_counts(flux_step_masks(s, config), config.num_blocks,
                                         "attention") for s, _ in cands.values()]
        ref = flux_expected_counts([full_flux_mask(config)] * STEPS, config.num_blocks,
                                   "attention")
        want = sum_counts(per_cand + [ref])
        log(f"  search launches {counts}; {len(per_cand)} candidates + the reference say {want}")
        if counts != want:
            raise AssertionError(f"FLUX search launches {counts} != candidates' masks {want}")
        default, fast = cands[(1, 0)][1], cands[(1, 1)][1]
        log(f"  default candidate {default!r} dB, ours_fast {fast!r} dB")
        if default != 200.0:
            raise AssertionError(f"the default FLUX candidate scored {default!r} dB, not 200")
        if not fast < 200.0:
            raise AssertionError(f"FLUX ours_fast scored {fast!r} dB")
        result.update(
            launches=counts, candidates=len(per_cand), default_db=default, ours_fast_db=fast,
            scores_db={f"cand_{i:03d}": sc for (_, i), (_, sc) in cands.items()},
            launches_per_candidate={k: statistics.mean(c[k] for c in per_cand)
                                    for k in ("attention", "modlnorm")},
            modlnorm_streams_per_candidate={
                k: statistics.mean(flux_modlnorm_streams(flux_step_masks(s, config),
                                                         config.num_blocks)[k]
                                   for s, _ in cands.values())
                for k in ("pair", "img", "txt", "joint")},
            s_per_generation=cycle_s,
            ms_per_image=cycle_s * 1e3 / SEARCH_FLUX_POP,
        )
        result["candidate"] = profile_candidate(
            evaluator, FluxCacheSchedule.from_json(FLUX_OURS_FAST_256), 1)
    log(f"  {cycle_s:.3f} s a generation, {result['ms_per_image']:.3f} ms an evaluated "
        f"image; one ours_fast candidate {result['candidate']['ms']:.3f} ms, device idle "
        f"share {result['candidate']['profile']['idle_share']:.4f}")
    return result


def flux_path() -> dict:
    """Full-width FLUX.1-dev (19 dual + 38 single blocks, d=3072, 24×128
    heads, 512 text tokens, guidance embedding) with seeded random bf16
    weights, 20 flow-match Euler steps at guidance 5 from hash-encoder
    prompts: 1024² at batch 1 under the default and ``fast_256_to_1024``,
    1536² at batch 1 under the all-recompute default and
    ``fast_256_to_1024``'s masks (the paper's 256² schedule transferred
    once more, as PixArt-Σ's 256² schedule is served at 2048²), 256² at
    batch 4 under ``ours_fast`` and the default, each decoded by the random
    16-channel VAE to uint8."""
    from ecad_tpu_torch.image_generators.flux import _FluxHashEncoder
    from ecad_tpu_torch.models.flux import FluxConfig, init_model, unpack_latents
    from ecad_tpu_torch.models.vae import random_decoder_pipeline
    from ecad_tpu_torch.pipelines import FluxPipeline, FluxPipelineConfig
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    log("FLUX.1-dev, full width, 20 steps: 1024² and 1536² batch 1, 256² batch 4")
    result = {"tiny_trajectory": small_flux_check()}
    config = FluxConfig()
    t0 = time.perf_counter()
    model = init_model(config, 0, "cuda")
    vae = random_decoder_pipeline(16, "cuda")
    torch.cuda.synchronize()
    result["init_s"] = time.perf_counter() - t0
    result["params"] = sum(p.numel() for p in model.parameters())
    log(f"  built {result['params'] / 1e9:.2f} B parameters in {result['init_s']:.1f} s")
    enc = _FluxHashEncoder(config.text_len, config.joint_dim, config.pooled_dim)
    prompts = ["a red bicycle leaning on a wall", "a bowl of ramen", "mountains at dawn",
               "a lighthouse in a storm"]

    def inputs(batch, pcfg):
        pairs = [enc.encode(p) for p in prompts[:batch]]
        gen = torch.Generator(device="cuda").manual_seed(0)
        noise = torch.randn((batch, pcfg.image_seq_len, config.in_channels),
                            generator=gen, device="cuda").to(config.dtype)
        return dict(
            noise=noise,
            txt=torch.from_numpy(np.stack([e for e, _ in pairs])).to("cuda", config.dtype),
            pooled=torch.from_numpy(np.stack([p for _, p in pairs])).to("cuda", config.dtype),
        )

    load = FluxCacheSchedule.from_json
    default_1536 = FluxCacheSchedule.default(
        STEPS, top_level_config={"height": 1536, "width": 1536, "guidance_scale": 5})
    # side, batch, schedules, the joint attention's counter, timed order,
    # the schedules profiled; one timed run each (device-bound at 1024² and
    # 1536²: idle < 0.05; the host-bound 256² spreads more between runs);
    # the 1024² latents kept for the quant
    # modes' error against bf16. The uncached trajectories are counted and
    # timed but not profiled (processing their profiles takes tens of
    # seconds each, which the quant parts and the scorers phase need;
    # PERF.md §5 keeps an earlier breakdown of them)
    latents_1024: dict = {}
    for side, batch, schedules, attention, order, profiled in (
        (1024, BATCH_FLUX_1024, {"default": load(FLUX_DEFAULT_1024), "fast": load(FLUX_FAST_1024)},
         "attention_rowblock", ("default", "fast"), ("fast",)),
        (1536, BATCH_FLUX_1536, {"default": default_1536, "fast": load(FLUX_FAST_1024)},
         "attention_flash", ("default", "fast"), ("fast",)),
        (256, BATCH_FLUX_256, {"ours_fast": load(FLUX_OURS_FAST_256),
                               "default": load(FLUX_DEFAULT_256)},
         "attention", ("default", "ours_fast"), ("ours_fast",)),
    ):
        pcfg = FluxPipelineConfig(config, STEPS, guidance_scale=5.0, height=side, width=side)
        pipes = {n: FluxPipeline(pcfg, model, sched) for n, sched in schedules.items()}
        for n, pipe in pipes.items():
            gs = pipe.schedule.top_level_config["guidance_scale"]
            size = pipe.schedule.top_level_config["height"]
            # the one schedule served at a side it was not made for:
            # fast_256_to_1024 at 1536²
            transferred = side == 1536 and n == "fast"
            if gs != pcfg.guidance_scale or (size != side and not transferred):
                raise AssertionError(f"{n}: schedule is for {size}² at guidance {gs}")
        gh, gw = pcfg.grid_hw
        result[str(side)] = drive(
            pipes, inputs(batch, pcfg),
            lambda lat: vae.decode_device(unpack_latents(lat, gh, gw)),
            batch, side,
            lambda pipe: flux_expected_counts(pipe.masks, config.num_blocks, attention),
            order=order, kernels=SERVED_KERNELS[f"flux{side}"],
            latents_out=latents_1024 if side == 1024 else None, profiled=profiled,
        )
        for n, pipe in pipes.items():
            result[str(side)][n]["modlnorm_streams"] = flux_modlnorm_streams(
                pipe.masks, config.num_blocks)
    r1024, r1536, r256 = result["1024"], result["1536"], result["256"]
    result["speedup_1024_fast"] = r1024["default"]["ms_per_img"] / r1024["fast"]["ms_per_img"]
    result["speedup_1536_fast"] = r1536["default"]["ms_per_img"] / r1536["fast"]["ms_per_img"]
    result["speedup_256_ours_fast"] = (
        r256["default"]["ms_per_img"] / r256["ours_fast"]["ms_per_img"])
    log(f"  ratio default / fast at 1024² {result['speedup_1024_fast']:.4f}, at 1536² "
        f"{result['speedup_1536_fast']:.4f} (peak {r1536['peak_mem_gib']:.2f} GiB), "
        f"default / ours_fast at 256² {result['speedup_256_ours_fast']:.4f}")

    result["search"] = flux_search(model, config, enc)

    # fp8 cache storage: the same seeded weights with cache_dtype
    # float8_e4m3fn, 256² batch 4 under ours_fast, against the bf16 caches
    inp = inputs(BATCH_FLUX_256, pcfg)
    want = pipes["ours_fast"].denoise(**inp).float()
    # the int8 weight-storage modes at 1024², made from these weights: the
    # holder's is the last reference to the bf16 model (`pipe` of the check
    # loop holds it too), which flux_quant drops once int8_w is made
    holder = [model]
    del model, pipes, pipe
    result["quant"] = flux_quant(holder, config, inputs, latents_1024)
    torch.cuda.empty_cache()
    cfg8 = dataclasses.replace(config, cache_dtype=torch.float8_e4m3fn)
    model = init_model(cfg8, 0, "cuda")
    pcfg8 = FluxPipelineConfig(cfg8, STEPS, guidance_scale=5.0, height=256, width=256)
    pipe8 = FluxPipeline(pcfg8, model, FluxCacheSchedule.from_json(FLUX_OURS_FAST_256))
    result["256_fp8_cache"] = drive(
        {"ours_fast": pipe8}, inp,
        lambda lat: vae.decode_device(unpack_latents(lat, *pcfg8.grid_hw)),
        BATCH_FLUX_256, 256,
        lambda pipe: flux_expected_counts(pipe.masks, config.num_blocks, "attention"),
        order=("ours_fast", "ours_fast"), kernels=SERVED_KERNELS["flux256"],
    )
    got = pipe8.denoise(**inp).float()
    diff = float((got - want).abs().max())
    result["256_fp8_cache"]["max_diff_to_bf16_cache"] = diff
    result["256_fp8_cache"]["max_abs_latent"] = float(want.abs().max())
    log(f"  fp8 caches at 256² ours_fast: "
        f"{result['256_fp8_cache']['ours_fast']['ms_per_img']:.3f} ms/img, latents within "
        f"{diff:.3g} of the bf16 caches' (max |latent| {float(want.abs().max()):.3g})")
    del model, vae, pipe8
    torch.cuda.empty_cache()
    return result


def run_cli(label: str, argv: list[str], n_prompts: int, side: int, want: dict) -> dict:
    """The inference CLI on a prompt file, with the launch counters set to
    0 just before; checks the PNG names and shapes and the launches."""
    from ecad_tpu_torch.inference.cli import main as cli_main
    from ecad_tpu_torch.ops import launch_counts, reset_launch_counts
    from PIL import Image

    log(f"entry point: ecad_tpu_torch.inference.cli ({label})")
    work = ROOT / "build" / "ecad_tpu_torch" / f"smoke_cli_{label}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    prompts = ["a red bicycle leaning on a wall", "a bowl of ramen", "mountains at dawn"]
    (work / "prompts.txt").write_text("\n".join(prompts[:n_prompts]) + "\n")
    reset_launch_counts()
    cli_main([*argv, "--prompt-file", str(work / "prompts.txt"),
              "--output-dir", str(work / "out")])
    torch.cuda.synchronize()
    counts = launch_counts()
    pngs = sorted((work / "out" / "images").glob("*.png"))
    names = [p.name for p in pngs]
    want_names = [f"{i:03d}__prompt_seed:000__image_seed:000.png" for i in range(n_prompts)]
    if names != want_names:
        raise AssertionError(f"CLI wrote {names}, expected {want_names}")
    for p in pngs:
        arr = np.asarray(Image.open(p))
        if arr.shape != (side, side, 3) or arr.dtype != np.uint8:
            raise AssertionError(f"{p.name}: {arr.shape} {arr.dtype}")
    if counts != want:
        raise AssertionError(f"CLI launches {counts} != schedule {want}")
    log(f"  CLI wrote {names}; launches {counts}")
    return {"pngs": names, "launches": counts}


def entry_points() -> dict:
    from ecad_tpu_torch.models.pixart import PixArtConfig, schedule_step_masks
    from ecad_tpu_torch.schedules import PixArtCacheSchedule

    def masks(path, gate_step=None):
        m = schedule_step_masks(PixArtCacheSchedule.from_json(path), PixArtConfig())
        if gate_step is None:
            return m
        # the TGATE pipeline's rewrite: no cross-attention after the gate
        return [tuple((a1, a2 and step < gate_step, ff) for a1, a2, ff in row)
                for step, row in enumerate(m)]

    from ecad_tpu_torch.models.flux import FluxConfig, flux_step_masks
    from ecad_tpu_torch.schedules import FluxCacheSchedule

    gate = PixArtCacheSchedule.from_json(TGATE_1024).top_level_config["pipeline"]
    flux = FluxConfig()
    flux_masks = flux_step_masks(FluxCacheSchedule.from_json(FLUX_OURS_FAST_256), flux)
    return {
        # the paper's Σ 256² schedule served at 2048²
        "sigma_ours_fast_2048": run_cli(
            "sigma_ours_fast_2048",
            ["PixArtSigmaImageGenerator", "--random-weights", "--height", "2048",
             "--width", "2048", "--batch-size", "1", "--schedule", str(SIGMA_OURS_FAST)],
            1, 256, expected_counts(masks(SIGMA_OURS_FAST), 2048)),
        "ours_fast_256": run_cli(
            "ours_fast_256",
            ["PixArtAlphaImageGenerator", "--random-weights", "--schedule", str(OURS_FAST)],
            3, 32, expected_counts(masks(OURS_FAST))),
        "tgate_1024": run_cli(
            "tgate_1024",
            ["PixArtAlphaImageGenerator", "--random-weights", "--batch-size", "2",
             "--schedule", str(TGATE_1024)],
            2, 128, expected_counts(masks(TGATE_1024, gate["kwargs"]["gate_step"]), 1024)),
        # full-width FLUX.1-dev at 256²: the images are the latent
        # visualisation of (32, 32, 16) latents, as in the reference
        "flux_ours_fast_256": run_cli(
            "flux_ours_fast_256",
            ["FluxImageGenerator", "--random-weights", "--schedule", str(FLUX_OURS_FAST_256)],
            2, 32, flux_expected_counts(flux_masks, flux.num_blocks, "attention")),
    }


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--report", type=Path,
        default=ROOT / "build" / "ecad_tpu_torch" / "chip_smoke_report.json",
    )
    args = parser.parse_args()
    smi = check_card()
    REPORT["card"] = smi
    seconds = REPORT.setdefault("phase_s", {})

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    phase("build", build_kernels)
    kernels = phase("kernels", kernel_phase, b2=2 * BATCH, b2_1024=2 * BATCH_1024)
    variants = phase("variants", variants_phase)
    REPORT["main_path"] = phase("main256", main_path)
    REPORT["checkpoints"] = phase("checkpoints", checkpoints_phase, REPORT["main_path"])
    REPORT["benchmark"] = phase("benchmark", benchmark_phase, smi)
    REPORT["scorers"] = phase("scorers", scorers_phase, smi)
    REPORT["search"] = phase("search", search_path)
    REPORT["main_path_1024"] = phase("main1024", main_path_1024)
    REPORT["quant"] = phase("quant", quant_path)
    REPORT["main_path_2048"] = phase("main2048", main_path_2048)
    REPORT["flux"] = phase("flux", flux_path)
    REPORT["entry_point"] = phase("cli", entry_points)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    # launches from the run of each kernel's path: PixArt-256 `ours_fast`
    # for K1-K3, PixArt-1024 `ours_fast` for K4, FLUX-1024 `fast` for K5,
    # FLUX-256 `ours_fast` for K1 at D=128, PixArt-2048 `ours_fast` for K6,
    # FLUX-1536 `fast` for K6 at D=128, K6 with a bias (which no served
    # path sends) its own router call at each shape, K3's rows at the
    # served widths their path's cached run (FLUX-1024 `fast` split by
    # stream, a split whose sum `drive` held to the run's count); the
    # harness's rows carry the launches of its run at their shape
    k3_launches = {
        "modlnorm_pixart1024": REPORT["main_path_1024"]["ours_fast"]["launches"]["modlnorm"],
        "modlnorm_pixart2048": REPORT["main_path_2048"]["ours_fast"]["launches"]["modlnorm"],
        **{f"modlnorm_flux1024_{k}": n
           for k, n in REPORT["flux"]["1024"]["fast"]["modlnorm_streams"].items()},
    }
    for name, row in kernels.items():
        if name in k3_launches:
            row["launches"] = k3_launches[name]
        elif name in REPORT["flash_bias_launches"]:
            row["launches"] = REPORT["flash_bias_launches"][name]
        elif name == "attention_flash_d128":
            row["launches"] = REPORT["flux"]["1536"]["fast"]["launches"]["attention_flash"]
        elif name.startswith("attention_flash"):
            row["launches"] = REPORT["main_path_2048"]["ours_fast"]["launches"][name]
        elif name.startswith("attention_long"):
            row["launches"] = REPORT["main_path_1024"]["ours_fast"]["launches"][name]
        elif name.startswith("attention_rowblock"):
            row["launches"] = REPORT["flux"]["1024"]["fast"]["launches"][name]
        elif name == "attention_flux256":
            row["launches"] = REPORT["flux"]["256"]["ours_fast"]["launches"]["attention"]
        else:
            row["launches"] = REPORT["main_path"]["ours_fast"]["launches"][name]
    kernels.update(variants)
    REPORT["kernels"] = kernels
    args.report.write_text(json.dumps(REPORT, indent=1))
    mp, mp4, fx = REPORT["main_path"], REPORT["main_path_1024"], REPORT["flux"]
    mp2k = REPORT["main_path_2048"]
    print(json.dumps({
        "card": smi,
        "ms_per_img_256": {k: mp[k]["ms_per_img"] for k in ("ours_fast", "default")},
        "speedup_256": mp["speedup"],
        "ms_per_img_1024": {k: mp4[k]["ms_per_img"] for k in ("ours_fast", "default", "tgate")},
        "speedup_1024": {k: mp4[f"speedup_{k}"] for k in ("ours_fast", "tgate")},
        "launches_1024": {k: mp4[k]["launches"] for k in ("ours_fast", "default", "tgate")},
        "ms_per_img_2048": {k: mp2k[k]["ms_per_img"] for k in ("ours_fast", "default")},
        "speedup_2048": mp2k["speedup"],
        "launches_2048": {k: mp2k[k]["launches"] for k in ("ours_fast", "default")},
        "flux_ms_per_img_1024": {k: fx["1024"][k]["ms_per_img"] for k in ("fast", "default")},
        "flux_speedup_1024": fx["speedup_1024_fast"],
        "flux_ms_per_img_1536": {k: fx["1536"][k]["ms_per_img"] for k in ("fast", "default")},
        "flux_speedup_1536": fx["speedup_1536_fast"],
        "flux_peak_mem_gib_1536": fx["1536"]["peak_mem_gib"],
        "flux_ms_per_img_256": {k: fx["256"][k]["ms_per_img"] for k in ("ours_fast", "default")},
        "flux_speedup_256": fx["speedup_256_ours_fast"],
        "search": {key: {k: r[k] for k in ("s_per_generation", "ms_per_image", "default_db",
                                             "ours_fast_db", "launches")}
                   | {"candidate_ms": r["candidate"]["ms"],
                      "candidate_idle_share": r["candidate"]["profile"]["idle_share"]}
                   for key, r in (("pixart256", REPORT["search"]), ("flux256", fx["search"]))},
        "quant": quant_summary(REPORT["quant"], fx["quant"]),
        "flux_launches": {f"{side}/{k}": fx[side][k]["launches"]
                          for side, ks in (("1024", ("fast", "default")),
                                           ("1536", ("fast", "default")),
                                           ("256", ("ours_fast", "default")))
                          for k in ks},
        "phase_s": seconds,
    }), flush=True)
    print(json.dumps(benchmark_line(smi, REPORT["benchmark"], seconds["benchmark"])),
          flush=True)
    print(json.dumps(checkpoints_line(smi, REPORT["checkpoints"], seconds["checkpoints"])),
          flush=True)
    print(json.dumps(scorers_line(REPORT["scorers"], seconds["scorers"])), flush=True)
    # every row has the contract's keys; X1's also its two-call yardstick
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: r[k] for k in ("two_call_ms",) if k in r}}
                                  for r in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
