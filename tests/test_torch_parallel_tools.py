"""The port's multi-process entry points over spawned gloo ranks on the
CPU: `evaluate_generation`'s two regimes, `genetic.train` with and without
``--dp``, and `generate_images` / `score_images` sharded by `host_shard`,
each against the same work in one process. Tiny PixArt (2 blocks), fp32.

* work-sharded (no mesh): each rank evaluates its strided share of the
  candidates and writes their scores; the union is the one-process set,
  every candidate once, its scores equal to the one-process run's (the
  same computation, so bit for bit);
* cooperative (a dp=2 mesh): every rank runs every candidate, only the
  coordinator writes scores and MACs; the scores within the amplitude
  tolerance of tests/test_torch_parallel_models.py (1e-6: each rank
  denoises half the batch, GEMMs of another M);
* `generate_images` / `score_images`: each rank takes every second
  schedule / leaf directory, no file is written twice, and the PNGs and
  scores equal the one-process run's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ecad_tpu_torch.benchmark import generate_embeddings as temb
from ecad_tpu_torch.benchmark import generate_images as timg
from ecad_tpu_torch.benchmark import score_images as tscore
from ecad_tpu_torch.genetic import evaluate as tev
from ecad_tpu_torch.genetic import population_io as tpio
from ecad_tpu_torch.genetic.population_io import METRIC_KEY
from ecad_tpu_torch.genetic import train
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.parallel import distributed as tdist
from ecad_tpu_torch.parallel import mesh as tmesh
from ecad_tpu_torch.parallel.launch import spawn
from ecad_tpu_torch.pipelines import PixArtPipeline, PixArtPipelineConfig
from ecad_tpu_torch.schedules import PixArtCacheSchedule
from ecad_tpu_torch.schedules.generators import pixart_cache, save_schedules

CPU = ["--device", "cpu"]
STEPS = 4
POP = 5
AMPLITUDE_TOL = 1e-6
PROMPTS = [{"id": f"p{i}", "prompt": f"prompt number {i}"} for i in range(3)]


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Prompts, three tiny schedules and their embeddings."""
    root = tmp_path_factory.mktemp("tools")
    (root / "prompts.json").write_text(json.dumps(PROMPTS))
    save_schedules((s for s in pixart_cache.gen_recompute_all_every_n(2, STEPS)
                    if s.name in ("recompute_all_every_002", "recompute_all_every_003")),
                   root / "schedules", verbose=False)
    save_schedules(pixart_cache.gen_default(2, STEPS), root / "schedules", verbose=False)
    temb.main(["TinyPixArtImageGenerator", "--prompt-file", str(root / "prompts.json"),
               "--random-weights", "--output-dir", str(root / "emb"), *CPU])
    return root


def _image_args(ws: Path, out: Path) -> list[str]:
    return ["TinyPixArtImageGenerator", "--input-embeddings", str(ws / "emb"),
            "--output-dir", str(out), "--schedule-dir", str(ws / "schedules"), *CPU]


def _manager(root: Path, name: str):
    return tpio.PixArtPopulationIOManager(
        name, all_populations_dir=root / "p", all_benchmarks_dir=root / "b",
        population_size=POP, num_inference_steps=STEPS,
        default_schedule=PixArtCacheSchedule.default(num_inference_steps=STEPS, num_blocks=2))


def _evaluator(mesh=None):
    c = tpx.PixArtConfig.tiny(dtype=torch.float32)
    pipe = PixArtPipeline(PixArtPipelineConfig(c, STEPS), tpx.init_model(c, 0, "cpu"))
    gen = torch.Generator().manual_seed(5)
    text, neg = (torch.randn((2, 8, 32), generator=gen) for _ in range(2))
    return tev.CandidateEvaluator(pipe, text, neg, ["a", "b"],
                                  tev.EvalConfig(scorer="fidelity", return_images=False),
                                  mesh=mesh)


def _population(root: Path, name: str):
    mgr = _manager(root, name)
    mgr.save_population(np.random.default_rng(0).random((POP, mgr.n_var)) < 0.5)
    return mgr


TRAIN = ["--population-size", str(POP), "--num-inference-steps", str(STEPS), "--num-prompts",
         "2", "--num-cycles", "1", "--random-seed-gen-0", "--tiny-model", "--scorer",
         "fidelity", *CPU]


def _tools_rank(rank, world, ws, out):
    ws, out = Path(ws), Path(out)
    done = {"rendered": [], "scored": []}
    # generate_images and score_images, each rank on its host_shard
    render, score = timg.generate_for_schedule, tscore.score_schedule_dir

    def rendered(gen_type, schedule_path, *a, **kw):
        done["rendered"].append(schedule_path.stem)
        return render(gen_type, schedule_path, *a, **kw)

    def scored(d, *a, **kw):
        done["scored"].append(d.name)
        return score(d, *a, **kw)

    timg.generate_for_schedule, tscore.score_schedule_dir = rendered, scored
    timg.main(_image_args(ws, out / "imgs"))
    tdist.barrier("rendered")
    tscore.main(["--image-dir", str(out / "imgs"), "--scorer", "mock", *CPU])
    timg.generate_for_schedule, tscore.score_schedule_dir = render, score
    # evaluate_generation: work-sharded on a shared directory, then
    # cooperative with one directory a rank (so what each rank writes shows)
    if rank == 0:
        _population(out, "sharded")
    tdist.barrier("scored")
    done["sharded"] = sorted(_evaluator().evaluate_generation(
        _manager(out, "sharded"), verbose=False))
    mesh = tmesh.create_mesh(dp=2)
    own = out / f"rank{rank}"
    done["coop"] = sorted(_evaluator(mesh).evaluate_generation(
        _population(own, "coop"), verbose=False))
    tdist.barrier("evaluated")
    # the search CLI: a cycle sharded by candidates, and a cooperative one
    train.main(["--name", "sharded", *TRAIN, "--populations-dir", str(out / "tp"),
                "--benchmarks-dir", str(out / "tb")])
    train.main(["--name", "coop", "--dp", "2", *TRAIN, "--populations-dir", str(out / "tp"),
                "--benchmarks-dir", str(out / "tb")])
    (out / f"done{rank}.json").write_text(json.dumps(done))


@pytest.fixture(scope="module")
def runs(ws, tmp_path_factory):
    """The two ranks' work, and the same in one process."""
    two = tmp_path_factory.mktemp("two")
    spawn(_tools_rank, 2, (str(ws), str(two)), timeout_s=240, threads=1, init_dir=two)
    one = tmp_path_factory.mktemp("one")
    timg.main(_image_args(ws, one / "imgs"))
    tscore.main(["--image-dir", str(one / "imgs"), "--scorer", "mock", *CPU])
    _evaluator().evaluate_generation(_population(one, "sharded"), verbose=False)
    for name in ("sharded", "coop"):
        train.main(["--name", name, *TRAIN, "--populations-dir", str(one / "tp"),
                    "--benchmarks-dir", str(one / "tb")])
    done = [json.loads((two / f"done{r}.json").read_text()) for r in range(2)]
    return two, one, done


def test_generate_and_score_images_shard_by_host(runs, ws):
    """Each rank renders every second schedule and scores every second
    directory, no file twice; the PNG tree and the scores equal the
    one-process run's."""
    two, one, done = runs
    stems = sorted(p.stem for p in (ws / "schedules").rglob("*.json"))
    for r in range(2):
        assert done[r]["rendered"] == stems[r::2]
    assert sorted(done[0]["rendered"] + done[1]["rendered"]) == stems
    scored = done[0]["scored"] + done[1]["scored"]
    assert sorted(scored) == sorted(set(scored)) == stems
    assert _files(two / "imgs") == _files(one / "imgs")
    for f in _files(one / "imgs"):
        assert (two / "imgs" / f).read_bytes() == (one / "imgs" / f).read_bytes(), f


def _amplitudes(scores: dict) -> np.ndarray:
    """A candidate's per-image fidelity as amplitudes 10^(−dB/20)."""
    return np.array([10 ** (-np.asarray(v, np.float64) / 20)
                     for _, v in sorted(scores["score_by_prompt_id"].items())])


def _scores(root: Path, name: str, gen: int = 1) -> dict:
    d = root / "b" / name / f"gen_{gen:03d}" / "candidates"
    return {p.parent.name: json.loads(p.read_text()) for p in sorted(d.glob("*/scores.json"))}


def test_work_sharded_evaluation_covers_the_population_once(runs):
    """Without a mesh the ranks take candidates 0, 2, 4 and 1, 3: every
    candidate scored once, exactly as one process scores it, MACs in every
    candidate JSON."""
    two, one, done = runs
    assert done[0]["sharded"] == [0, 2, 4] and done[1]["sharded"] == [1, 3]
    assert _scores(two, "sharded") == _scores(one, "sharded")
    assert len(_scores(two, "sharded")) == POP
    cands = sorted((two / "p" / "sharded" / "gen_001" / "candidates").glob("cand_*.json"))
    assert len(cands) == POP and all(METRIC_KEY in json.loads(p.read_text())["metrics"]
                                     for p in cands)


def test_cooperative_evaluation_writes_on_the_coordinator_only(runs):
    """On a dp=2 mesh both ranks evaluate every candidate; only rank 0's
    directory gets the scores and the MACs, and they match the one-process
    scores within the amplitude tolerance."""
    two, one, done = runs
    assert done[0]["coop"] == done[1]["coop"] == list(range(POP))
    got = _scores(two / "rank0", "coop")
    assert len(got) == POP and not _scores(two / "rank1", "coop")
    want = _scores(one, "sharded")
    for cand, s in got.items():
        np.testing.assert_allclose(_amplitudes(s), _amplitudes(want[cand]), rtol=0,
                                   atol=AMPLITUDE_TOL)
    rank1 = (two / "rank1" / "p" / "coop" / "gen_001" / "candidates").glob("cand_*.json")
    assert all(METRIC_KEY not in json.loads(p.read_text()).get("metrics", {}) for p in rank1)


@pytest.mark.parametrize("name", ["sharded", "coop"])
def test_train_over_two_ranks_writes_the_one_process_files(runs, name):
    """`genetic.train` on two ranks, sharded by candidates or cooperative
    under ``--dp 2``: the generation's files are the one-process run's —
    candidate JSONs, manager config and next generation byte for byte
    (tell/ask is deterministic on the same scores), checkpoints array for
    array, scores equal (sharded) or within the amplitude tolerance
    (cooperative)."""
    two, one, _ = runs
    for sub in ("gen_001/candidates", "gen_002/candidates"):
        a, b = two / "tp" / name / sub, one / "tp" / name / sub
        assert _files(a) == _files(b) and _files(a)
        for f in _files(a):
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    configs = [json.loads((root / "tp" / name / "gen_002/manager_config.json").read_text())
               for root in (two, one)]
    for cfg in configs:  # the directories differ, nothing else
        cfg.pop("population_dir")
        cfg.pop("benchmark_dir")
    assert configs[0] == configs[1]
    got = np.load(two / "tp" / name / "gen_002/checkpoint.npz")
    want = np.load(one / "tp" / name / "gen_002/checkpoint.npz")
    assert sorted(got.files) == sorted(want.files)
    got_scores, want_scores = (
        {p.parent.name: json.loads(p.read_text())
         for p in sorted((root / "tb" / name / "gen_001/candidates").glob("*/scores.json"))}
        for root in (two, one))
    assert got_scores.keys() == want_scores.keys() and len(got_scores) == POP
    for cand in got_scores:
        np.testing.assert_allclose(_amplitudes(got_scores[cand]), _amplitudes(want_scores[cand]),
                                   rtol=0, atol=0 if name == "sharded" else AMPLITUDE_TOL)


def test_train_mesh_flags_need_the_launched_ranks(tmp_path):
    """``--tp 2`` in one process: `create_mesh`'s error, before a candidate
    is evaluated (the reference's mismatch raises the same way)."""
    with pytest.raises(ValueError, match=r"dp\*sp\*tp=0 != 1 ranks"):
        train.main(["--name", "m", *TRAIN, "--tp", "2", "--populations-dir",
                    str(tmp_path / "p"), "--benchmarks-dir", str(tmp_path / "b")])
    assert not list(tmp_path.rglob("scores.json")) and not list(tmp_path.rglob("cand_*.json"))


@pytest.mark.parametrize("var", ["WORLD_SIZE", "JAX_NUM_PROCESSES"])
def test_one_process_environment_is_a_noop(ws, tmp_path, monkeypatch, var):
    """``WORLD_SIZE=1`` (or the reference's ``JAX_NUM_PROCESSES=1``): the
    tools run in this process and take every item. The torchrun variables
    that `_map_reference_env` writes go back to their state at teardown."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    monkeypatch.setenv(var, "1")
    timg.main(_image_args(ws, tmp_path / "imgs"))
    assert len(_files(tmp_path / "imgs")) == 3 * len(PROMPTS)
    assert not torch.distributed.is_initialized()
