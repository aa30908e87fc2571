"""inference — prompt/prompt-file/embeddings → images, on the GPU.

Counterpart of ``ecad_tpu/inference/cli.py`` with the same arguments plus
``--device`` (default ``cuda``; pass ``--device cpu`` for the plain PyTorch
path): positional image-generator name; exactly one of --prompt /
--prompt-file / --input-embeddings; optional --schedule; outputs
<out>/embeddings/*.pt and <out>/images/<name>__image_seed:NNN.png.
``--cache-dtype float8_e4m3fn`` stores the FLUX generators' caches in fp8
(other generators reject it); ``--quant`` serves the transformer's block
projections through the int8 product (``ops/quant.py``).

    python -m ecad_tpu_torch.inference.cli PixArtAlphaImageGenerator \\
        --prompt "a red bicycle" --random-weights --output-dir out
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..image_generators import ImageGeneratorRegistry, get_image_generator_type
from ..ops.quant import MODES as QUANT_MODES
from ..utils.io import load_embedding_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument(
        "image_generator",
        help=f"one of {ImageGeneratorRegistry.names()}",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--prompt", help="a single prompt")
    src.add_argument("--prompt-file", type=Path,
                     help="text file with one prompt per line")
    src.add_argument("--input-embeddings", type=Path,
                     help="directory of saved prompt embeddings")
    p.add_argument("--schedule", type=Path, default=None,
                   help="cache-schedule JSON")
    p.add_argument("--output-dir", type=Path, default=Path("inference_output"))
    p.add_argument("--start-seed", type=int, default=0)
    p.add_argument("--seed-step", type=int, default=1)
    p.add_argument("--images-per-prompt", type=int, default=1)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--weights-root", type=Path, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda must be present")
    p.add_argument(
        "--quant",
        choices=QUANT_MODES,
        default=None,
        help="serving quantization for the transformer's block projections"
        " (W8A8 dynamic, the int8 tensor-core product; 'int8_static' uses"
        " per-site CALIBRATED activation scales — calibrates on first"
        " pipeline build, PixArt + FLUX; 'int8_w' additionally STORES the"
        " weights as int8, halving their device memory; 'int8_w_static'"
        " combines int8 weight storage with the calibrated activation"
        " scales)",
    )
    p.add_argument("--cache-dtype", choices=["float8_e4m3fn"], default=None,
                   help="storage dtype for cached component activations (FLUX only)")
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    gen_type = get_image_generator_type(args.image_generator)

    if args.guidance_scale is not None and not gen_type.allow_guidance_override():
        # reference inference.py:210-215 rejects PixArt guidance overrides
        sys.exit(
            f"{args.image_generator} does not support --guidance-scale "
            f"overrides (fixed at {gen_type.guidance_scale})"
        )

    try:
        gen = gen_type(
            start_seed=args.start_seed,
            seed_step=args.seed_step,
            schedule_path=args.schedule,
            weights_root=args.weights_root,
            random_weights=args.random_weights or args.weights_root is None,
            num_inference_steps=args.num_inference_steps,
            batch_size=args.batch_size,
            device=args.device,
            cache_dtype=args.cache_dtype,
            quant=args.quant,
        )
    except ValueError as e:  # e.g. --cache-dtype for a generator without it
        parser.error(str(e))
    if args.height:
        gen.height = args.height
    if args.width:
        gen.width = args.width
    if args.guidance_scale is not None:
        gen.guidance_scale = args.guidance_scale
    print(f"Image generator: {gen.describe()}")

    out = args.output_dir
    if args.input_embeddings is not None:
        embeddings = load_embedding_dir(args.input_embeddings)
        if not embeddings:
            sys.exit(f"no embeddings found in {args.input_embeddings}")
    else:
        prompts = (
            [args.prompt]
            if args.prompt is not None
            else [
                line.strip()
                for line in args.prompt_file.read_text().splitlines()
                if line.strip()
            ]
        )
        print(f"Encoding {len(prompts)} prompt(s)…")
        paths = gen.encode_and_save_prompts(prompts, out / "embeddings")
        print(f"Saved {len(paths)} embeddings to {out / 'embeddings'}")
        embeddings = load_embedding_dir(out / "embeddings")

    print(f"Generating {args.images_per_prompt} image(s) per prompt…")
    n = 0
    bs = args.batch_size
    for lo in range(0, len(embeddings), bs):
        imgs = gen.generate_images(
            embeddings[lo : lo + bs],
            images_per_prompt=args.images_per_prompt,
            output_dir=out / "images",
        )
        n += len(imgs)
    print(f"Wrote {n} image(s) to {out / 'images'}")


if __name__ == "__main__":
    main()
