"""train_nsga2 — the ECAD evolutionary-caching optimization loop, on the GPU.

The port's counterpart of ``ecad_tpu/genetic/train.py``: the same flags (plus
``--device``), the same ask/tell cycle and resumable generations, with the
offline-eval stage running in-process on the resident model instead of
three subprocess invocations per generation. The on-disk generation
artifacts (candidates/cand_*.json, scores dirs, manager_config.json,
checkpoint.npz) are the reference's, so a search started by either package
resumes in the other.

Runs on ``cuda`` unless ``--device cpu`` is given; without a GPU and
without that flag it raises. With ``--weights-root`` the evaluator serves
the checkpoint tree there through the family's generator (PixArt-α or
FLUX.1-dev; ``--transformer-weights`` names another transformer repo), and
decodes through the checkpoint's VAE; ``--prompt-file`` then encodes its
prompts with the checkpoint's text encoder(s). Otherwise weights are
random (seeded by ``--seed``), at full width or ``--tiny-model``. Prompts
not from ``--prompt-file`` are random embeddings or ``--embeddings-dir``.
``--scorer image_reward`` (ECAD's objective) needs its weights
(``--image-reward-dir``: ImageReward.pt and a BERT tokenizer's vocab.txt,
or the ECAD_IMAGE_REWARD_* variables) and ``--weights-root``, whose VAE
decodes what it scores; decoded images stay on the device for the scorer.
Several processes (``torchrun``; ``ecad_tpu_torch.parallel``): each calls
`parallel.initialize` (``--dist-backend`` picks the backend: ``nccl`` by
default on cards of their own, ``gloo`` where ranks share a card or on the
CPU). Without ``--dp``/``--tp``/``--sp`` > 1 each process evaluates its
share of the candidates; with them the mesh is laid over the launched
ranks (`_build_mesh`; dp·sp·tp must be the world size) and every rank runs
every candidate, the batch over dp, heads and MLP width over tp, tokens
over sp. Only the coordinator writes the generation's files, with barriers
where the reference has them, so the files stay the JAX package's.
``--quant`` builds the evaluator's model in a serving quant mode
(``ops/quant.py``; the generator calibrates the static modes on a
checkpoint); with random weights the static modes keep per-token scales,
as the reference's do.

Usage (mini smoke run, fidelity scorer, tiny random model on the CPU):
  python -m ecad_tpu_torch.genetic.train --name demo --population-size 8 \\
      --num-cycles 2 --random-seed-gen-0 --tiny-model --device cpu \\
      --scorer fidelity
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..ops.quant import MODES as QUANT_MODES
from ..parallel.distributed import barrier, initialize, is_coordinator
from ..scoring.clip_score import ENV_MODEL_DIR as CLIP_MODEL_DIR
from ..scoring.image_reward import ENV_CHECKPOINT, ENV_TOKENIZER
from .evaluate import CandidateEvaluator, EvalConfig
from .nsga2 import NSGA2
from .population_io import (
    CHECKPOINT_FILENAME,
    FluxPopulationIOManager,
    PixArtPopulationIOManager,
    PopulationIOManager,
)

MANAGERS = {
    "pixart": PixArtPopulationIOManager,
    "flux": FluxPopulationIOManager,
}
_CACHE_DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--name", required=True, help="population name")
    p.add_argument("--model-family", choices=sorted(MANAGERS), default="pixart")
    p.add_argument("--populations-dir", type=Path, default=None)
    p.add_argument("--benchmarks-dir", type=Path, default=None)
    p.add_argument("--population-size", type=int, default=72)
    p.add_argument("--num-inference-steps", type=int, default=20)
    p.add_argument("--min-diff-from-default", type=int, default=1)
    p.add_argument("--maximize-macs", action="store_true")
    p.add_argument(
        "--num-cycles",
        default="1",
        help="number of ask/tell cycles, or 'inf' to run until interrupted",
    )
    p.add_argument("--batch-size", type=int, default=0,
                   help="device batch for candidate eval (0 = all at once)")
    p.add_argument("--images-per-prompt", type=int, default=1)
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--seed-step", type=int, default=1)
    p.add_argument("--scorer", default="mock",
                   help="scorer name (mock | fidelity | image_reward | clip). "
                        "'fidelity' needs no weights: it scores each "
                        "candidate's final latents against the uncached "
                        "trajectory of the same model (latent-space SNR dB; "
                        "evaluate.py:fidelity_snr_db)")
    p.add_argument("--weights-root", type=Path, default=None,
                   help="root of local HF-layout checkpoints (transformer, "
                        "text encoder(s), VAE)")
    p.add_argument("--transformer-weights", default=None,
                   help="transformer repo name under --weights-root")
    p.add_argument("--image-reward-dir", type=Path, default=None,
                   help="directory with ImageReward.pt and a BERT tokenizer "
                        "(vocab.txt here or one level down); sets the "
                        "ECAD_IMAGE_REWARD_* variables for --scorer "
                        "image_reward")
    p.add_argument("--prompt-file", type=Path, default=None,
                   help="prompts, one a line, encoded with the checkpoint's "
                        "text encoder (needs --weights-root)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size over the launched ranks (0: the "
                        "world size / (tp·sp) when a mesh is built)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (heads and MLP width)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size (image / joint tokens)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend when several processes run "
                        "(default nccl, one card a rank; gloo where ranks "
                        "share a card)")
    p.add_argument("--eval-mode", default="dynamic",
                   choices=["dynamic", "stepwise"],
                   help="candidate-eval mode (EvalConfig.mode): the masks as "
                        "one (steps, blocks, 3) array or as per-step tuples; "
                        "both run the pipeline's step loop")
    p.add_argument("--num-prompts", type=int, default=4,
                   help="number of prompt embeddings (random unless "
                        "--embeddings-dir)")
    p.add_argument("--embeddings-dir", type=Path, default=None,
                   help="directory of saved prompt embeddings (.pt/.npz)")
    p.add_argument("--load-from", type=Path, default=None,
                   help="resume from a generation's manager_config.json")
    p.add_argument("--random-seed-gen-0", action="store_true",
                   help="seed gen 0 randomly without asking (reference asks "
                        "interactively, train_nsga2_base.py:184-252)")
    p.add_argument("--cache-dtype", choices=sorted(_CACHE_DTYPES), default=None,
                   help="storage dtype for cached component activations"
                   " (FLUX only)")
    p.add_argument("--quant",
                   choices=QUANT_MODES, default=None,
                   help="serving quantization for the denoiser's block"
                   " projections (ops/quant.py): 'int8' = W8A8 dynamic on"
                   " the int8 tensor cores; 'int8_w' also stores the weights"
                   " as int8, halving their device memory")
    p.add_argument("--tiny-model", action="store_true",
                   help="2-block test model (random weights) for smoke runs")
    p.add_argument("--flux-dim", type=int, default=None,
                   help="width-reduce the FLUX model to this hidden dim "
                        "(all 57 blocks and the real 3420-gene genome, "
                        "head_dim 128 kept, heads dim // 128)")
    p.add_argument("--flux-heads", type=int, default=None,
                   help="override num_heads with --flux-dim (default "
                        "dim // 128)")
    p.add_argument("--crossover-prob", type=float, default=0.9)
    p.add_argument("--crossover-points", type=int, default=4)
    p.add_argument("--mutation-prob", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-not-submit", action="store_true",
                   help="describe the eval work instead of running it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    return p


def _build_mesh(args):
    """The mesh from --dp/--sp/--tp over the launched ranks (ref :243-252),
    None when none is above 1; `create_mesh` raises when dp·sp·tp is not
    the world size."""
    if args.dp <= 1 and args.tp <= 1 and args.sp <= 1:
        return None
    from ..parallel import create_mesh

    return create_mesh(dp=args.dp or None, tp=args.tp, sp=args.sp)


def _shard_pipeline(pipeline, mesh):
    """The pipeline's model remade for the mesh, each rank keeping its tp
    slice of the same weights (ref :255-268; `models.common.shard_module`)."""
    if mesh is None:
        return pipeline
    from ..models.common import shard_module

    pipeline.model = shard_module(pipeline.model, mesh)
    return pipeline


def resolve_scorer_weights(args) -> None:
    """Fail loudly at startup — not mid-generation — when a weight-backed
    scorer lacks weights (ref :190-229, which checks image_reward only).
    --image-reward-dir sets the variables the scorer registry reads."""
    if args.scorer == "clip" and not os.environ.get(CLIP_MODEL_DIR):
        raise SystemExit(f"--scorer clip needs weights: set {CLIP_MODEL_DIR} to a "
                         "CLIP model directory (HF layout)")
    if args.scorer != "image_reward":
        return
    if args.image_reward_dir is not None:
        d = Path(args.image_reward_dir)
        ckpt = d / "ImageReward.pt"
        if not ckpt.exists():
            raise SystemExit(f"--image-reward-dir: {ckpt} not found")
        if (d / "vocab.txt").exists():
            tok = d
        else:
            toks = sorted(p.parent for p in d.glob("*/vocab.txt"))
            if not toks:
                raise SystemExit(
                    f"--image-reward-dir: no BERT tokenizer (vocab.txt) under {d}"
                )
            tok = toks[0]
        os.environ[ENV_CHECKPOINT] = str(ckpt)
        os.environ[ENV_TOKENIZER] = str(tok)
    if not (os.environ.get(ENV_CHECKPOINT) and os.environ.get(ENV_TOKENIZER)):
        raise SystemExit(
            "--scorer image_reward needs weights: pass --image-reward-dir "
            f"(ImageReward.pt + BERT tokenizer) or set {ENV_CHECKPOINT} / "
            f"{ENV_TOKENIZER}"
        )
    if args.weights_root is None:
        raise SystemExit(
            "--scorer image_reward without --weights-root would score "
            "latent visualizations, not VAE-decoded images — pass "
            "--weights-root (or use --scorer mock for smoke runs)"
        )


def initialize_manager(args) -> PopulationIOManager:
    cls = MANAGERS[args.model_family]
    if args.load_from is not None:
        return cls.from_json(args.load_from)
    kwargs = dict(
        name=args.name,
        num_inference_steps=args.num_inference_steps,
        min_diff_from_default=args.min_diff_from_default,
        population_size=args.population_size,
        maximize_macs=args.maximize_macs,
    )
    if args.tiny_model:
        # candidate genomes must match the tiny architectures
        if args.model_family == "flux":
            from ..schedules import FluxCacheSchedule

            kwargs["default_schedule"] = FluxCacheSchedule.default(
                num_inference_steps=args.num_inference_steps,
                num_blocks=2,
                num_single_blocks=3,
                top_level_config={},
            )
        else:
            from ..schedules import PixArtCacheSchedule

            kwargs["default_schedule"] = PixArtCacheSchedule.default(
                num_inference_steps=args.num_inference_steps, num_blocks=2
            )
    if args.populations_dir is not None:
        kwargs["all_populations_dir"] = args.populations_dir
    if args.benchmarks_dir is not None:
        kwargs["all_benchmarks_dir"] = args.benchmarks_dir
    return cls(**kwargs)


def _embeddings(args, keys: tuple[str, str], shapes, dtype, device) -> tuple:
    """(first, second, prompt names): the two embedding arrays `keys` of
    every entry of --embeddings-dir, else `args.num_prompts` random ones of
    `shapes` from a `torch.Generator` on `device` seeded with --seed."""
    if args.embeddings_dir is not None:
        from ..utils.io import load_embedding_dir

        entries = load_embedding_dir(args.embeddings_dir)
        if not entries or any(k not in entries[0] for k in keys):
            raise SystemExit(
                f"no embeddings with {' and '.join(keys)} found in "
                f"{args.embeddings_dir}"
            )
        first, second = (
            torch.from_numpy(np.stack([e[k] for e in entries])).to(device, dtype)
            for k in keys
        )
        return first, second, [e["name"] for e in entries]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    p = args.num_prompts
    first, second = (
        torch.randn((p, *s), generator=gen, device=device).to(dtype) for s in shapes
    )
    return first, second, [f"prompt_{i}" for i in range(p)]


def _checkpoint_generator(args, cls):
    """The family's generator on the checkpoint tree under --weights-root
    (ref :292-330, :394-420), its transformer repo from
    --transformer-weights when given."""
    gen = cls(
        quant=args.quant,
        start_seed=args.start_seed,
        seed_step=args.seed_step,
        weights_root=args.weights_root,
        num_inference_steps=args.num_inference_steps,
        device=args.device,
        **({"cache_dtype": args.cache_dtype} if cls.supports_cache_dtype else {}),
    )
    if args.transformer_weights:
        gen.transformer_weights = args.transformer_weights
    return gen


def _prompt_file_embeddings(args, gen, keys: tuple[str, str], dtype) -> tuple:
    """(first, second, prompts): the prompts of --prompt-file (one a line,
    blank lines skipped) encoded by the generator's text encoder(s)."""
    prompts = [line.strip() for line in Path(args.prompt_file).read_text().splitlines()
               if line.strip()]
    entries = gen.encode_prompts(prompts)
    first, second = (gen._stack(entries, k, dtype) for k in keys)
    return first, second, prompts


def build_evaluator(args, manager) -> CandidateEvaluator:
    """The evaluator on one resident model on --device: the checkpoint's
    under --weights-root, else a random-weight one seeded by --seed."""
    from ..models.pixart import PixArtConfig, init_model
    from ..pipelines import PixArtPipeline, PixArtPipelineConfig

    if args.model_family == "flux":
        return _build_flux_evaluator(args)
    if args.cache_dtype is not None:
        # mirror the inference CLI: PixArt generators reject it — fail
        # loudly instead of silently running with bf16 caches
        raise ValueError(
            "--cache-dtype is a FLUX option (models/flux.py); PixArt caches "
            "stay in the model dtype"
        )
    device = resolve_device(args.device)
    mesh = _build_mesh(args)
    keys = ("prompt_embeds", "negative_prompt_embeds")
    if args.weights_root is not None:
        from ..image_generators import PixArtAlphaImageGenerator

        gen = _checkpoint_generator(args, PixArtAlphaImageGenerator)
        pipeline = _shard_pipeline(gen.create_diffusion_pipeline(), mesh)
        config = pipeline.config.model
        decode_fn = gen.decode_latents_device
        if args.prompt_file is not None:
            text, neg, prompts = _prompt_file_embeddings(args, gen, keys, config.dtype)
            return CandidateEvaluator(pipeline, text, neg, prompts, _eval_config(args),
                                      decode_fn=decode_fn, mesh=mesh)
    else:
        config = (PixArtConfig.tiny(dtype=torch.float32, quant=args.quant)
                  if args.tiny_model else PixArtConfig(quant=args.quant))
        pcfg = PixArtPipelineConfig(model=config,
                                    num_inference_steps=args.num_inference_steps)
        pipeline = PixArtPipeline(pcfg, init_model(config, args.seed, device, mesh=mesh))
        decode_fn = None
    shape = (config.text_len, config.caption_dim)
    text, neg, prompts = _embeddings(args, keys, (shape, shape), config.dtype, device)
    return CandidateEvaluator(pipeline, text, neg, prompts, _eval_config(args),
                              decode_fn=decode_fn, mesh=mesh)


def _eval_config(args) -> EvalConfig:
    return EvalConfig(
        images_per_prompt=args.images_per_prompt,
        start_seed=args.start_seed,
        seed_step=args.seed_step,
        scorer=args.scorer,
        batch_size=args.batch_size,
        mode=args.eval_mode,
        # the search loop consumes scores only: never gather decoded images
        return_images=False,
    )


def _build_flux_evaluator(args):
    from ..models.flux import FluxConfig, init_model
    from ..pipelines.flux_pipeline import FluxPipeline, FluxPipelineConfig
    from .evaluate import FluxCandidateEvaluator

    device = resolve_device(args.device)
    mesh = _build_mesh(args)
    keys = ("prompt_embeds", "pooled_prompt_embeds")
    decode_fn = None
    if args.weights_root is not None:
        from ..image_generators import FluxImageGenerator

        gen = _checkpoint_generator(args, FluxImageGenerator)
        pipeline = _shard_pipeline(gen.create_diffusion_pipeline(), mesh)
        config = pipeline.config.model
        decode_fn = gen.decode_latents_device
        if args.prompt_file is not None:
            text, pooled, prompts = _prompt_file_embeddings(args, gen, keys, config.dtype)
            return FluxCandidateEvaluator(pipeline, text, pooled, prompts,
                                          _eval_config(args), decode_fn=decode_fn,
                                          mesh=mesh)
    else:
        cache_dtype = _CACHE_DTYPES[args.cache_dtype] if args.cache_dtype else None
        if args.tiny_model:
            config = FluxConfig.tiny(dtype=torch.float32, quant=args.quant,
                                     cache_dtype=cache_dtype)
        else:
            width = {}
            if args.flux_dim is not None:
                width = dict(
                    dim=args.flux_dim,
                    num_heads=args.flux_heads or args.flux_dim // 128,
                )
            config = FluxConfig(quant=args.quant, cache_dtype=cache_dtype, **width)
        height = 64 if args.tiny_model else 256
        pcfg = FluxPipelineConfig(
            model=config,
            num_inference_steps=args.num_inference_steps,
            height=height,
            width=height,
        )
        pipeline = FluxPipeline(pcfg, init_model(config, args.seed, device, mesh=mesh))
    text, pooled, prompts = _embeddings(
        args, keys, ((config.text_len, config.joint_dim), (config.pooled_dim,)),
        config.dtype, device,
    )
    return FluxCandidateEvaluator(pipeline, text, pooled, prompts, _eval_config(args),
                                  decode_fn=decode_fn, mesh=mesh)


def init_gen_0(args, manager: PopulationIOManager, algo: NSGA2) -> None:
    """Load seed candidates from gen_000/candidates if present, else seed
    randomly (train_nsga2_base.py:184-252; interactive y/N replaced by
    --random-seed-gen-0)."""
    seed_dir = manager.candidates_dir(0)
    seeds = manager.load_population_vectors(0)
    if len(seeds):
        print(f"Loaded {len(seeds)} seed candidates from {seed_dir}")
        X0 = algo.initialize(np.array(seeds, dtype=bool))
    else:
        if not args.random_seed_gen_0:
            resp = input(
                f"No gen_000 candidates in {seed_dir}. Random-seed? [y/N] "
            )
            if resp.strip().lower() != "y":
                sys.exit(1)
        X0 = algo.initialize()
    manager.generation_num = max(manager.generation_num, 1)
    if is_coordinator():
        manager.save_population(X0)
        manager.save_config()
    barrier("gen-0-seeded")


def train_one_cycle(args, manager, algo: NSGA2, evaluator) -> None:
    gen = manager.generation_num
    if not manager.check_offline_eval():
        if args.print_not_submit:
            print(
                f"[print-not-submit] would evaluate generation "
                f"{manager.generation_num} "
                f"({manager.population_size} candidates × "
                f"{len(evaluator.prompts)} prompts × "
                f"{evaluator.config.images_per_prompt} images)"
            )
            sys.exit(0)
        print(f"Evaluating generation {manager.generation_num}…")
        evaluator.evaluate_generation(manager)
        # several processes: each evaluated its share; wait for every share
        # (and the coordinator's MACs) before checking
        barrier(f"offline-eval-{gen}")
        if not manager.check_offline_eval():
            raise RuntimeError("offline evaluation incomplete after eval run")
    # tell/ask is deterministic (the same files, the same RNG state), so
    # every process computes the same next population; only the
    # coordinator writes it
    X, F, G = manager.ask()
    algo.tell(X, F, G)
    next_X = algo.ask()
    manager.generation_num += 1
    if is_coordinator():
        manager.save_population(next_X)
        manager.save_config()
        algo.save(manager.checkpoint_path())
    barrier(f"gen-saved-{gen}")
    print(
        f"Generation {manager.generation_num} saved "
        f"({len(next_X)} candidates). Pareto front size: "
        f"{len(algo.pareto_front()[0])}"
    )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_scorer_weights(args)
    if args.weights_root is None and (args.prompt_file or args.transformer_weights):
        # the reference ignores both without a checkpoint tree; say so
        raise SystemExit("--prompt-file and --transformer-weights need --weights-root")
    resolve_device(args.device)  # no GPU and no --device cpu: raise now
    initialize(args.dist_backend, args.device)  # no-op for one process
    manager = initialize_manager(args)

    ckpt = manager.checkpoint_path()
    # probe without generation_dir(): its mkdir side effect would create a
    # bogus gen_-01 dir when starting from a seeded gen_000
    prev_ckpt = (
        manager.population_dir
        / f"gen_{manager.generation_num - 1:03d}"
        / CHECKPOINT_FILENAME
    )
    if ckpt.exists():
        algo = NSGA2.load(ckpt)
        print(f"Resumed algorithm from {ckpt} (gen {algo.n_gen})")
    elif prev_ckpt.exists():
        algo = NSGA2.load(prev_ckpt)
        print(f"Resumed algorithm from {prev_ckpt} (gen {algo.n_gen})")
    else:
        algo = NSGA2(
            n_var=manager.n_var,
            pop_size=manager.population_size,
            crossover_prob=args.crossover_prob,
            crossover_points=args.crossover_points,
            mutation_prob=args.mutation_prob,
            seed=args.seed,
        )
    evaluator = build_evaluator(args, manager)

    if algo.X is None and algo.pending is None:
        init_gen_0(args, manager, algo)

    cycles = float("inf") if args.num_cycles == "inf" else int(args.num_cycles)
    done = 0
    while done < cycles:
        train_one_cycle(args, manager, algo, evaluator)
        done += 1


if __name__ == "__main__":
    main()
