"""Embedding file IO.

The reference stores prompt embeddings as torch `.pt` files, one per prompt,
named `{i:03}__prompt_id:{id}__prompt_seed:{seed:03}.pt`
(ecad/benchmark/generate_embeddings.py:51-69), scanned recursively so
category/megabatch subdirectories survive round-trips
(ecad/dataset_utils/prompt_embedding_dataset.py:9-61). The port's own copy of
`ecad_tpu/utils/io.py`: the same `.pt` and `.npz` formats and file names, so
embeddings written by either package load in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable

import numpy as np


def save_embedding(path: Path | str, data: dict[str, Any]) -> Path:
    """Save a dict of arrays as .pt (torch interchange) or .npz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for k, v in data.items():
        if v is None:
            continue
        arr = np.asarray(v)
        if arr.dtype.kind == "V":
            # ml_dtypes (bfloat16 etc.) report kind 'V'; widen to float32 so
            # bf16 embeddings from the real encoders round-trip
            arr = arr.astype(np.float32)
        if arr.dtype.kind not in "fiub":  # skip names/paths etc.
            continue
        arrays[k] = arr
    if path.suffix == ".pt":
        import torch

        torch.save({k: torch.from_numpy(v.copy()) for k, v in arrays.items()}, path)
    elif path.suffix == ".npz":
        np.savez(path, **arrays)
    else:
        raise ValueError(f"unsupported embedding format: {path.suffix}")
    return path


def load_embedding(path: Path | str) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".pt":
        import torch

        data = torch.load(path, map_location="cpu", weights_only=True)
        out = {}
        for k, v in data.items():
            if isinstance(v, torch.Tensor):
                # half/bf16 tensors (reference FLUX embeddings are bf16)
                # widen before .numpy(), which rejects bfloat16 directly
                if v.dtype in (torch.float16, torch.bfloat16):
                    v = v.float()
                v = v.numpy()
            out[k] = np.asarray(v)
        return out
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    raise ValueError(f"unsupported embedding format: {path.suffix}")


def load_embedding_dir(
    directory: Path | str, patterns: Iterable[str] = ("**/*.pt", "**/*.npz")
) -> list[dict[str, Any]]:
    """Recursive scan mirroring PromptEmbeddingDataset: each item carries
    `name` (stem), `relative_path` (preserving subdirs) and squeezed
    arrays."""
    directory = Path(directory)
    files: list[Path] = []
    for pat in patterns:
        files.extend(directory.glob(pat))
    entries = []
    for p in sorted(set(files)):
        data = load_embedding(p)
        entry: dict[str, Any] = {
            "name": p.stem,
            "relative_path": str(p.relative_to(directory)),
        }
        for k, v in data.items():
            entry[k] = np.squeeze(v, axis=0) if v.ndim and v.shape[0] == 1 else v
        entries.append(entry)
    return entries
