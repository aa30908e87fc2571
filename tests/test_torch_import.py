"""Every module of ecad_tpu_torch, and chip_smoke.py, imports with jax, flax
and ecad_tpu blocked: the port stands alone. transformers and safetensors
are blocked too: the card has neither (the port reads safetensors itself
and imports transformers only inside its tokenizer loaders)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "ecad_tpu", "transformers", "safetensors")

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import ecad_tpu_torch

names = ["ecad_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ecad_tpu_torch.__path__, "ecad_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
for name in ("ecad_tpu_torch.graph.interpreter", "ecad_tpu_torch.graph.generators",
             "ecad_tpu_torch.pipelines.tgate", "ecad_tpu_torch.pipelines.registry",
             "ecad_tpu_torch.schedules.flux", "ecad_tpu_torch.models.flux",
             "ecad_tpu_torch.pipelines.flux_pipeline", "ecad_tpu_torch.image_generators.flux",
             "ecad_tpu_torch.scoring", "ecad_tpu_torch.macs", "ecad_tpu_torch.genetic.problems",
             "ecad_tpu_torch.genetic.nsga2", "ecad_tpu_torch.genetic.population_io",
             "ecad_tpu_torch.genetic.evaluate", "ecad_tpu_torch.genetic.train",
             "ecad_tpu_torch.schedules.generators.helpers",
             "ecad_tpu_torch.schedules.generators.pixart_cache",
             "ecad_tpu_torch.schedules.generators.flux_cache",
             "ecad_tpu_torch.schedules.generate_cli",
             "ecad_tpu_torch.benchmark", "ecad_tpu_torch.benchmark.prompts",
             "ecad_tpu_torch.benchmark._processes",
             "ecad_tpu_torch.benchmark.generate_embeddings",
             "ecad_tpu_torch.benchmark.generate_images",
             "ecad_tpu_torch.benchmark.compute_latency",
             "ecad_tpu_torch.benchmark.compute_macs",
             "ecad_tpu_torch.benchmark.score_images",
             "ecad_tpu_torch.benchmark.compute_fid",
             "ecad_tpu_torch.benchmark.compute_clip",
             "ecad_tpu_torch.scoring.fid", "ecad_tpu_torch.bench",
             "ecad_tpu_torch.ops.quant", "ecad_tpu_torch.models.weights",
             "ecad_tpu_torch.models.t5", "ecad_tpu_torch.models.clip",
             "ecad_tpu_torch.scoring.image_reward", "ecad_tpu_torch.scoring.clip_score",
             "ecad_tpu_torch.scoring.inception"):
    assert name in names, name
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
assert "triton" not in sys.modules  # imported only when a kernel launches
print(len(names))
"""


def test_port_imports_without_jax_flax_or_ecad_tpu():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 74  # every module was walked
