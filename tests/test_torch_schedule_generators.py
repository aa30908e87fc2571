"""The port's heuristic schedule generators and `generate_cli` against the
JAX package's on the CPU: every `GEN_FUNCTIONS` entry of `pixart_cache`
and `flux_cache`, at the shapes of the committed trees (PixArt 28 blocks,
FLUX 19 + 38, 20 steps), and the CLI with ``-f all`` on each family, write
byte-identical JSON trees. The two packages are compared directly
(`tests/test_schedule_regen.py` needs the original ECAD tree)."""

import contextlib
import io
from pathlib import Path

import pytest

from ecad_tpu.schedules import generate_cli as jcli
from ecad_tpu.schedules.generators import flux_cache as jflux
from ecad_tpu.schedules.generators import pixart_cache as jpix
from ecad_tpu.schedules.generators.helpers import save_schedules as jsave
from ecad_tpu_torch.schedules import generate_cli as tcli
from ecad_tpu_torch.schedules.generators import flux_cache as tflux
from ecad_tpu_torch.schedules.generators import pixart_cache as tpix
from ecad_tpu_torch.schedules.generators.helpers import save_schedules as tsave


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


CASES = [pytest.param(jpix, tpix, name, (28, 20), id=f"pixart_cache-{name}")
         for name in sorted(jpix.GEN_FUNCTIONS)]
CASES += [pytest.param(jflux, tflux, name, (19, 38, 20), id=f"flux_cache-{name}")
          for name in sorted(jflux.GEN_FUNCTIONS)]


@pytest.mark.parametrize("jmod,tmod,name,args", CASES)
def test_generator_writes_the_same_tree(tmp_path, jmod, tmod, name, args):
    assert sorted(tmod.GEN_FUNCTIONS) == sorted(jmod.GEN_FUNCTIONS)
    jsave(jmod.GEN_FUNCTIONS[name](*args), tmp_path / "jax", verbose=False)
    written = tsave(tmod.GEN_FUNCTIONS[name](*args), tmp_path / "torch", verbose=False)
    assert written
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")


# -f all per family, through the CLI's size flags at smaller shapes than the
# committed trees (the tests above hold those; the DiT topology family at
# 28 × 20 writes 3942 files, 0.5 GB, per package)
FAMILIES = {
    "pixart_cache": ["--num-blocks", "10"],
    "flux_cache": ["--num-blocks", "5", "--num-single-blocks", "8",
                   "--num-inference-steps", "10"],
    "pixart_dit": ["--num-blocks", "8", "--num-inference-steps", "6"],
    "flux_dit": [],
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_cli_all_writes_the_same_tree(tmp_path, family):
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main([family, "-f", "all", "--output-dir", str(tmp_path / tag),
                      *FAMILIES[family]])
        assert "Done:" in out.getvalue()
    tree = _tree(tmp_path / "torch")
    assert tree and tree == _tree(tmp_path / "jax")
