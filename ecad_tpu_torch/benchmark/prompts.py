"""Benchmark prompt loading and embedding-file naming schemes (the port's
own copy of ``ecad_tpu/benchmark/prompts.py``: the same names for every
prompt file, since the scorers parse them back out of image names).

Reference: ecad/benchmark/generate_embeddings.py:15-69 (.txt/.json naming),
generate_embeddings_parti.py:42-45 (TSV), generate_coco_embeddings.py:26-70
(30k captions → megabatch subdirs), generate_mjhq_embeddings.py:33-86
(category subdirs). The embedding filename IS the metadata carrier — the
scorers regex prompt ids and seeds back out of image names derived from it
(score_images.py:19-28)."""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Iterator


def read_benchmark_prompts(path: Path | str) -> dict[str, str]:
    """name → prompt. `.txt`: numbered lines; `.json`: ImageReward-style
    [{"id":…, "prompt":…}]; `.tsv`: PartiPrompts ('Prompt' column)."""
    path = Path(path)
    seed = 0
    if path.suffix == ".txt":
        lines = [l.strip() for l in path.read_text().splitlines() if l.strip()]
        return {
            f"{i:03d}__prompt_seed:{seed:03}": prompt
            for i, prompt in enumerate(lines)
        }
    if path.suffix == ".json":
        items = json.loads(path.read_text())
        return {
            f"{i:03}__prompt_id:{item['id']}__prompt_seed:{seed:03}": item[
                "prompt"
            ]
            for i, item in enumerate(items)
        }
    if path.suffix == ".tsv":
        with path.open() as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        return {
            f"{i:04}__prompt_seed:{seed:03}": row["Prompt"]
            for i, row in enumerate(rows)
        }
    raise ValueError(f"unsupported prompt file format: {path.suffix}")


def coco_megabatches(
    prompts: list[str], batch_size: int = 3000
) -> Iterator[tuple[str, dict[str, str]]]:
    """COCO 30k → `megabatch_i` subdirs of `batch_size` each."""
    for b, lo in enumerate(range(0, len(prompts), batch_size)):
        chunk = prompts[lo : lo + batch_size]
        yield (
            f"megabatch_{b}",
            {
                f"{lo + i:05d}__prompt_seed:000": p
                for i, p in enumerate(chunk)
            },
        )


def mjhq_categories(
    meta: dict[str, dict],
) -> Iterator[tuple[str, dict[str, str]]]:
    """MJHQ meta JSON {image_id: {"prompt":…, "category":…}} → per-category
    groups."""
    by_cat: dict[str, dict[str, str]] = {}
    for image_id, item in meta.items():
        by_cat.setdefault(item["category"], {})[
            f"{image_id}__prompt_seed:000"
        ] = item["prompt"]
    yield from sorted(by_cat.items())


def normalize_prompt_id(pid: str) -> str:
    """One key for zero-padded numeric ids ('010') and their stripped forms
    ('10'); non-numeric ids pass through. Embedding filenames zero-pad the
    index while prompt-file maps may not — both sides must normalize."""
    if pid.isdigit():
        return pid.lstrip("0") or "0"
    return pid
