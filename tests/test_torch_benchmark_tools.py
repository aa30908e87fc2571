"""The port's benchmark tier (`ecad_tpu_torch.benchmark`, `--device cpu`)
against the JAX package's tools on the same inputs: prompt names,
embedding files, the image tree and its skip/regenerate rule, MACs in the
schedule JSONs, scores.json, the metrics.latency schema, the random VAE's
decode; the resident generator's `set_schedule`; the port's batch-32 bench
on the tiny model; `generate_embeddings --weights-root` on a tiny
checkpoint tree; and the refusals (no GPU without --device cpu, the
weight-backed scorers). More than one process:
tests/test_torch_parallel_tools.py."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ecad_tpu.benchmark import compute_clip as jclip
from ecad_tpu.benchmark import compute_latency as jlat
from ecad_tpu.benchmark import compute_macs as jmacs
from ecad_tpu.benchmark import generate_embeddings as jemb
from ecad_tpu.benchmark import generate_images as jimg
from ecad_tpu.benchmark import prompts as jprompts
from ecad_tpu.benchmark import score_images as jscore
from ecad_tpu.schedules.generators import pixart_cache, save_schedules
from ecad_tpu_torch import bench as tbench
from ecad_tpu_torch.benchmark import compute_clip as tclip
from ecad_tpu_torch.benchmark import compute_fid as tfid
from ecad_tpu_torch.benchmark import compute_latency as tlat
from ecad_tpu_torch.benchmark import compute_macs as tmacs
from ecad_tpu_torch.benchmark import generate_embeddings as temb
from ecad_tpu_torch.benchmark import generate_images as timg
from ecad_tpu_torch.benchmark import prompts as tprompts
from ecad_tpu_torch.benchmark import score_images as tscore
from ecad_tpu_torch.utils.io import load_embedding_dir

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
PAPER_ALPHA_256 = REPO / "schedules/schedules_in_paper/pixart_alpha_256"
PROMPTS = [{"id": "p1", "prompt": "a cat on a mat"},
           {"id": "p2", "prompt": "the Eiffel tower at night"}]


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _tiny_schedules(directory: Path) -> Path:
    """The tiny PixArt's (2 blocks, 4 steps) default and
    recompute_all_every_002 schedules."""
    save_schedules(
        (s for s in pixart_cache.gen_recompute_all_every_n(2, 4)
         if s.name == "recompute_all_every_002"),
        directory, verbose=False,
    )
    save_schedules(pixart_cache.gen_default(2, 4), directory, verbose=False)
    return directory


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Prompts, the tiny schedule tree, and each package's embeddings of
    the prompts for the tiny PixArt and the tiny FLUX."""
    root = tmp_path_factory.mktemp("tier")
    (root / "prompts.json").write_text(json.dumps(PROMPTS))
    _tiny_schedules(root / "schedules")
    for gen in ("TinyPixArtImageGenerator", "TinyFluxImageGenerator"):
        args = [gen, "--prompt-file", str(root / "prompts.json"), "--random-weights"]
        jemb.main([*args, "--output-dir", str(root / "jax" / gen)])
        temb.main([*args, "--output-dir", str(root / "torch" / gen), *CPU])
    return root


# ---------------------------------------------------------------------------
# prompts and embeddings
# ---------------------------------------------------------------------------

PROMPT_FILES = sorted(
    p.name for p in (REPO / "prompts").iterdir() if p.suffix in (".txt", ".json", ".tsv")
)


@pytest.mark.parametrize("name", PROMPT_FILES)
def test_prompt_file_names_match(name):
    """Every prompt file under prompts/ gives the same name → prompt map,
    the metadata the scorers parse back out of image names."""
    path = REPO / "prompts" / name
    want = jprompts.read_benchmark_prompts(path)
    assert want and tprompts.read_benchmark_prompts(path) == want


def test_coco_and_mjhq_groupings_match():
    lines = (REPO / "prompts/COCO_caption_prompts_30k.txt").read_text().splitlines()
    lines = [line.strip() for line in lines if line.strip()][:7000]
    assert list(tprompts.coco_megabatches(lines, 3000)) == list(
        jprompts.coco_megabatches(lines, 3000))
    meta = {f"img{i}": {"prompt": f"p{i}", "category": "cde"[i % 3]} for i in range(8)}
    assert list(tprompts.mjhq_categories(meta)) == list(jprompts.mjhq_categories(meta))
    for pid in ("010", "0", "000", "p7", "12"):
        assert tprompts.normalize_prompt_id(pid) == jprompts.normalize_prompt_id(pid)


def _assert_same_embeddings(jdir: Path, tdir: Path):
    assert _files(tdir) == _files(jdir) and _files(jdir)
    for a, b in zip(load_embedding_dir(jdir), load_embedding_dir(tdir)):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


@pytest.mark.parametrize("mode,source,fmt", [
    ("benchmark", "prompts/ImageRewardPrompts.json", ".pt"),
    ("benchmark", "prompts/DrawBench200.txt", ".npz"),
    ("parti", "prompts/PartiPrompts.tsv", ".pt"),
    ("coco", "coco", ".pt"),
    ("mjhq", "mjhq", ".npz"),
])
def test_embeddings_match(tmp_path, mode, source, fmt):
    """generate_embeddings writes the same file tree with array-equal
    embeddings in each mode and format: the hash encoder gives both
    packages the same bytes. The repo's prompt files are cut to their
    first 6 prompts; coco and mjhq take written inputs with several
    megabatches and categories."""
    if source == "coco":
        prompt_file = tmp_path / "coco.txt"
        prompt_file.write_text("\n".join(f"caption number {i}" for i in range(7)))
    elif source == "mjhq":
        prompt_file = tmp_path / "meta.json"
        prompt_file.write_text(json.dumps(
            {f"img{i}": {"prompt": f"a photo {i}", "category": "xyz"[i % 3]}
             for i in range(5)}))
    else:
        prompt_file = tmp_path / Path(source).name
        full = REPO / source
        if full.suffix == ".json":
            prompt_file.write_text(json.dumps(json.loads(full.read_text())[:6]))
        else:
            prompt_file.write_text("\n".join(full.read_text().splitlines()[:7]) + "\n")
    args = ["TinyPixArtImageGenerator", "--prompt-file", str(prompt_file),
            "--mode", mode, "--format", fmt, "--megabatch-size", "3",
            "--batch-size", "4"]
    jemb.main([*args, "--output-dir", str(tmp_path / "jax")])
    temb.main([*args, "--output-dir", str(tmp_path / "torch"), *CPU])
    _assert_same_embeddings(tmp_path / "jax", tmp_path / "torch")
    if mode == "coco":
        assert len(list((tmp_path / "torch" / "megabatch_2").iterdir())) == 1


def test_flux_embeddings_match(ws):
    _assert_same_embeddings(ws / "jax" / "TinyFluxImageGenerator",
                            ws / "torch" / "TinyFluxImageGenerator")


# ---------------------------------------------------------------------------
# the image tree and set_schedule
# ---------------------------------------------------------------------------


def _image_args(ws, pkg: str, out: Path):
    return ["TinyPixArtImageGenerator",
            "--input-embeddings", str(ws / pkg / "TinyPixArtImageGenerator"),
            "--output-dir", str(out), "--schedule-dir", str(ws / "schedules"),
            "--images-per-prompt", "2"]


def test_image_tree_matches_and_skips(ws, tmp_path, capsys):
    """generate_images over the two-schedule tiny tree writes the JAX
    tool's file tree and PNG names (the pixels differ: the packages'
    noise differs); a rerun does no work; a wrong PNG count regenerates
    that schedule's images."""
    jimg.main(_image_args(ws, "jax", tmp_path / "jax"))
    out = tmp_path / "torch"
    timg.main([*_image_args(ws, "torch", out), *CPU])
    files = _files(out)
    assert files == _files(tmp_path / "jax")
    assert len(files) == 8 and {f.split("/")[0] for f in files} == {
        "default", "recompute_all_every_002"}
    before = {f: (out / f).stat().st_mtime_ns for f in files}
    a, b = ((out / d / files[0].split("/")[1]).read_bytes()
            for d in ("default", "recompute_all_every_002"))
    assert a != b  # the cached schedule renders other pixels

    capsys.readouterr()
    timg.main([*_image_args(ws, "torch", out), *CPU])
    said = capsys.readouterr().out
    assert said.count("Skipping") == 2 and "Done: 0 images." in said
    assert {f: (out / f).stat().st_mtime_ns for f in _files(out)} == before

    (out / files[0]).unlink()
    timg.main([*_image_args(ws, "torch", out), *CPU])
    said = capsys.readouterr().out
    assert "Regenerating default: 3/4 images." in said and "Done: 4 images." in said
    assert _files(out) == files
    assert (out / files[0]).read_bytes() == a


def _latents(gen, embeddings):
    with torch.inference_mode():
        return gen._generate_latents(embeddings, seed=3)


def test_set_schedule_matches_a_fresh_generator(ws):
    """A schedule swapped in on the resident generator gives the same bits
    as a fresh generator built on it: in place when only the masks
    changed, and through a rebuilt pipeline on the same model when the
    schedule asks for another pipeline (TGATE)."""
    from ecad_tpu_torch.image_generators import TinyPixArtImageGenerator as Gen
    from ecad_tpu_torch.pipelines import PixArtPipeline, TGATEPixArtPipeline

    emb = load_embedding_dir(ws / "torch" / "TinyPixArtImageGenerator")
    cached = ws / "schedules" / "recompute_all_every_002.json"
    tgate = ws / "tgate.json"
    raw = json.loads((ws / "schedules" / "default.json").read_text())
    raw["config"] = {"pipeline": {"name": "tgate", "kwargs": {"gate_step": 2}}}
    tgate.write_text(json.dumps(raw))

    gen = Gen(device="cpu")
    default = _latents(gen, emb)
    pipe, model = gen._pipeline, gen._model
    gen.set_schedule(cached)
    assert gen._pipeline is pipe  # the masks swapped in place
    got = _latents(gen, emb)
    torch.testing.assert_close(got, _latents(Gen(schedule_path=cached, device="cpu"), emb),
                               rtol=0, atol=0)
    assert not torch.equal(got, default)

    gen.set_schedule(tgate)
    got = _latents(gen, emb)
    assert isinstance(gen._pipeline, TGATEPixArtPipeline) and gen._model is model
    torch.testing.assert_close(got, _latents(Gen(schedule_path=tgate, device="cpu"), emb),
                               rtol=0, atol=0)
    # back to a schedule without a pipeline config: the default pipeline,
    # as a fresh generator has it
    gen.set_schedule(ws / "schedules" / "default.json")
    torch.testing.assert_close(_latents(gen, emb), default, rtol=0, atol=0)
    assert type(gen._pipeline) is PixArtPipeline and gen._model is model


# ---------------------------------------------------------------------------
# MACs
# ---------------------------------------------------------------------------

MACS_FILES = ["tiny/default.json", "tiny/recompute_all_every_002.json",
              *(f"paper/{p.name}" for p in sorted(PAPER_ALPHA_256.glob("*.json")))]


@pytest.mark.parametrize("name", MACS_FILES)
def test_compute_macs_writes_the_jax_tools_bytes(tmp_path, name):
    """compute_macs --overwrite on copies of a schedule: the port's file is
    byte-equal to the JAX tool's."""
    group, stem = name.split("/")
    src = (_tiny_schedules(tmp_path / "tiny") if group == "tiny" else PAPER_ALPHA_256) / stem
    copies = {}
    for pkg, tool in (("jax", jmacs), ("torch", tmacs)):
        copies[pkg] = tmp_path / pkg / stem
        copies[pkg].parent.mkdir()
        shutil.copy(src, copies[pkg])
        tool.main(["--schedule", str(copies[pkg]), "--overwrite"])
    assert copies["torch"].read_bytes() == copies["jax"].read_bytes()
    metrics = json.loads(copies["torch"].read_text())["metrics"]
    assert metrics["total_macs_T"] > 0
    if stem == "ours_fast.json":
        assert metrics["total_macs"] == 2134989471744


def test_compute_macs_input_dir_and_skip(tmp_path, capsys):
    _tiny_schedules(tmp_path / "s")
    tmacs.main(["--input-dir", str(tmp_path / "s")])
    assert "Updated 2 schedule files." in capsys.readouterr().out
    tmacs.main(["--input-dir", str(tmp_path / "s")])
    assert "Updated 0 schedule files." in capsys.readouterr().out


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------

# one tree whose names parse in every naming mode: image_reward's
# prompt_id, parti's numbered prompt_seed, toca's leading number
IMAGE_NAMES = {
    "ir": [f"{i:03d}__prompt_id:{pid}__prompt_seed:000__image_seed:{s:03d}"
           for i, pid in enumerate(("p1", "p2")) for s in (0, 1)],
    "parti": [f"{i:04d}__prompt_seed:000__image_seed:{s:03d}"
              for i in range(3) for s in (0, 2)],
}


def _image_tree(root: Path) -> Path:
    from PIL import Image

    rng = np.random.default_rng(5)
    for sub, names in IMAGE_NAMES.items():
        (root / sub).mkdir(parents=True)
        for n in names:
            Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                root / sub / f"{n}.png")
    return root


@pytest.mark.parametrize("naming", sorted(jscore.NAMING_MODES))
def test_score_images_writes_the_jax_tools_scores(tmp_path, naming):
    """score_images --scorer mock: scores.json byte-identical to the JAX
    tool's in every naming mode, with prompt ids resolved from a prompt
    file."""
    prompt_file = tmp_path / "prompts.json"
    prompt_file.write_text(json.dumps(PROMPTS))
    args = ["--scorer", "mock", "--naming", naming, "--prompt-file", str(prompt_file)]
    jscore.main(["--image-dir", str(_image_tree(tmp_path / "jax")), *args])
    tscore.main(["--image-dir", str(_image_tree(tmp_path / "torch")), *args, *CPU])
    scored = sorted(str(p.relative_to(tmp_path / "jax"))
                    for p in (tmp_path / "jax").rglob("scores.json"))
    assert scored
    for rel in scored:
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_score_images_gates_and_deletes(tmp_path, capsys):
    root = _image_tree(tmp_path / "t")
    tscore.main(["--image-dir", str(root), "--exactly-n-images", "4", *CPU])
    said = capsys.readouterr().out
    assert "Skipping" in said and (root / "ir" / "scores.json").exists()
    assert not (root / "parti" / "scores.json").exists()
    tscore.main(["--image-dir", str(root), "--naming", "parti", "--delete-after", *CPU])
    assert (root / "parti" / "scores.json").exists()
    assert not list((root / "parti").glob("*.png"))
    assert len(list((root / "ir").glob("*.png"))) == 4  # scored before: skipped


def test_compute_clip_mock_matches(tmp_path):
    prompt_file = tmp_path / "prompts.json"
    prompt_file.write_text(json.dumps(PROMPTS))
    args = ["--prompt-file", str(prompt_file), "--scorer", "mock"]
    jclip.main(["--image-dir", str(_image_tree(tmp_path / "jax")), *args])
    tclip.main(["--image-dir", str(_image_tree(tmp_path / "torch")), *args, *CPU])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    rel = Path("ir") / "clip_scores.json"  # the parti names do not parse here
    assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


# ---------------------------------------------------------------------------
# latency
# ---------------------------------------------------------------------------


def _latency(ws, directory: Path, pkg: str, tool, gen: str, extra) -> dict:
    """metrics.latency of `tool` on a copy of the tiny generator's default
    schedule (1 warmup, 2 samples, a batch of 3 filled from 2 prompts)."""
    path = directory / f"{pkg}_{gen}.json"
    if gen == "TinyPixArtImageGenerator":
        shutil.copy(ws / "schedules" / "default.json", path)
    else:
        from ecad_tpu_torch.image_generators import TinyFluxImageGenerator

        TinyFluxImageGenerator(device="cpu").cache_schedule.to_json(path)
    tool.main([gen, "--input-embeddings", str(ws / pkg / gen), "--schedule", str(path),
               "--warmup-steps", "1", "--num-samples", "2", "--batch-size", "3", *extra])
    return json.loads(path.read_text())["metrics"]["latency"]


@pytest.fixture(scope="module")
def jax_latency(ws):
    """The JAX tool's metrics.latency once a generator, on the latent
    visualization: the schema does not depend on the decode (and the JAX
    tiny FLUX's --random-vae builds the 16-channel VAE, which its
    4-channel latents do not fit)."""
    return {gen: _latency(ws, ws, "jax", jlat, gen, [])
            for gen in ("TinyPixArtImageGenerator", "TinyFluxImageGenerator")}


@pytest.mark.parametrize("random_vae", [False, True], ids=["latents", "random_vae"])
@pytest.mark.parametrize("gen", ["TinyPixArtImageGenerator", "TinyFluxImageGenerator"])
def test_latency_schema_matches(ws, jax_latency, tmp_path, gen, random_vae):
    """compute_latency writes metrics.latency with the JAX tool's keys and
    list lengths, the batch filled by repeating the entries; ``gpu`` is
    "cpu" here."""
    want = jax_latency[gen]
    got = _latency(ws, tmp_path, "torch", tlat, gen,
                   [*CPU, *(["--random-vae"] if random_vae else [])])
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list):
            assert len(got[k]) == len(v)
        elif k == "gpu":
            assert got[k] == "cpu"
        elif k == "avg":
            assert got[k] > 0
        else:
            assert got[k] == v
    assert got["batch_size"] == 3 and len(got["latencies"]) == 2


def test_latency_profile_dir_writes_a_chrome_trace(ws, tmp_path):
    path = tmp_path / "s.json"
    shutil.copy(ws / "schedules" / "default.json", path)
    tlat.main(["TinyPixArtImageGenerator", "--input-embeddings",
               str(ws / "torch" / "TinyPixArtImageGenerator"), "--schedule", str(path),
               "--warmup-steps", "0", "--num-samples", "1", "--batch-size", "2",
               "--profile-dir", str(tmp_path / "prof"), *CPU])
    trace = json.loads((tmp_path / "prof" / "compute_latency_trace.json").read_text())
    assert trace["traceEvents"]


@pytest.fixture(scope="module")
def tiny_vae():
    """The JAX package's tiny VAE decoder pipeline and its params."""
    import jax
    from flax import linen as fnn

    import ecad_tpu.models.vae as jvae

    jcfg = jvae.VAEConfig.tiny()
    z0 = np.zeros((1, 4, 4, 4), np.float32)
    jmodel = jvae.VAEDecoder(jcfg)
    params = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(3), z0))()["params"]
    params = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    return jvae.VAEDecoderPipeline(jcfg, params), params


@pytest.mark.parametrize("gen", ["TinyPixArtImageGenerator", "TinyFluxImageGenerator"])
def test_random_vae_decode_matches_reference(monkeypatch, tiny_vae, gen):
    """decode_latents_device with use_random_vae against the JAX
    generator's, the random VAE on the tiny config (the JAX params bridged
    into the port), fp32: within one uint8 level, as
    tests/test_torch_pipeline.py::test_vae_decode_matches_reference
    states for the decoder. Without the VAE both give the latent
    visualization, exactly; the saved PNGs stay the visualization."""
    import ecad_tpu.image_generators as jgens
    import ecad_tpu.models.vae as jvae
    import ecad_tpu_torch.image_generators as tgens
    import ecad_tpu_torch.models.vae as tvae
    from ecad_tpu_torch.models.bridge import vae_state_dict

    jpipe, params = tiny_vae
    asked = []

    def torch_pipeline(latent_channels, device="cuda", seed=7):
        asked.append(latent_channels)
        model = tvae.VAEDecoder(tvae.VAEConfig.tiny())
        model.load_state_dict(vae_state_dict(params), strict=True)
        return tvae.VAEDecoderPipeline(model.eval().requires_grad_(False).to(device))

    monkeypatch.setattr(jvae, "random_decoder_pipeline", lambda latent_channels=4: jpipe)
    monkeypatch.setattr(tvae, "random_decoder_pipeline", torch_pipeline)
    jgen = getattr(jgens, gen)()
    tgen = getattr(tgens, gen)(device="cpu")
    z = np.random.default_rng(11).standard_normal((2, 4, 4, 4), dtype=np.float32)
    plain = tgen.decode_latents_device(torch.from_numpy(z))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jgen.decode_latents_device(z)))
    jgen.use_random_vae = tgen.use_random_vae = True
    want = np.asarray(jgen.decode_latents_device(z))
    got = tgen.decode_latents_device(torch.from_numpy(z))
    assert asked == [4]  # the tiny models' latents have 4 channels
    assert got.dtype == torch.uint8 and got.shape == want.shape == (2, 8, 8, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(tgen.decode_latents(torch.from_numpy(z)), jgen.decode_latents(z))


# ---------------------------------------------------------------------------
# the port's headline bench
# ---------------------------------------------------------------------------


def test_bench_tiny_on_the_cpu(capsys):
    """``python -m ecad_tpu_torch.bench --device cpu --tiny`` runs the
    arms in turns and prints the JAX bench's keys with the turns' spread."""
    result = tbench.main(["--device", "cpu", "--tiny", "--batch", "2", "--turns", "3",
                          "--warmup", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    d = line["detail"]
    assert d["batch"] == 2 and d["turns"] == 3
    for arm in tbench.ARMS:
        runs = d[f"{arm}_ms_per_image_turns"]
        assert len(runs) == 3 and min(runs) > 0
        assert d[f"{arm}_ms_per_image_range"] == [min(runs), max(runs)]
        assert d[f"{arm}_ms_per_image"] == float(np.median(runs))
    assert line["value"] == d["uncached_ms_per_image"] / d["cached_ms_per_image"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / (165.74 / 84.09))
    assert len(d["ratio_per_turn"]) == 3


def test_bench_arms_render_different_images(tmp_path):
    """The bench's arms on its one resident generator: unmasked embeddings,
    the schedules swapped in place on one pipeline, the random VAE's uint8
    images left on the device, and the two arms' images differ."""
    gen, emb = tbench.build("cpu", tiny=True, batch=2)
    assert len(emb) == 2 and not any("prompt_attention_mask" in e for e in emb)
    imgs, pipes = {}, set()
    with torch.inference_mode():
        for name, schedule in tbench.arms(tiny=True, tmp=tmp_path).items():
            gen.set_schedule(schedule)
            imgs[name] = gen.decode_latents_device(gen._generate_latents(emb, 0))
            pipes.add(id(gen.create_diffusion_pipeline()))
    assert len(pipes) == 1
    assert imgs["uncached"].shape == (2, 64, 64, 3) and imgs["uncached"].dtype == torch.uint8
    assert not torch.equal(imgs["uncached"], imgs["cached"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _cli_calls(ws, tmp_path):
    emb = str(ws / "torch" / "TinyPixArtImageGenerator")
    sched = tmp_path / "s.json"
    shutil.copy(ws / "schedules" / "default.json", sched)
    images = _image_tree(tmp_path / "imgs")
    return {
        "generate_embeddings": (temb.main, ["TinyPixArtImageGenerator", "--prompt-file",
                                            str(ws / "prompts.json"), "--output-dir",
                                            str(tmp_path / "e")]),
        "generate_images": (timg.main, ["TinyPixArtImageGenerator", "--input-embeddings",
                                        emb, "--output-dir", str(tmp_path / "i"),
                                        "--schedule", str(sched)]),
        "compute_latency": (tlat.main, ["TinyPixArtImageGenerator", "--input-embeddings",
                                        emb, "--schedule", str(sched)]),
        "score_images": (tscore.main, ["--image-dir", str(images)]),
        "compute_clip": (tclip.main, ["--image-dir", str(images), "--prompt-file",
                                      str(ws / "prompts.json"), "--scorer", "mock"]),
        "compute_fid": (tfid.main, ["--image-dir", str(images), "--stats",
                                    str(tmp_path / "st.npz"), "--make-stats"]),
        "bench": (tbench.main, ["--batch", "2"]),
    }


@pytest.mark.parametrize("tool", ["generate_embeddings", "generate_images",
                                  "compute_latency", "score_images", "compute_clip",
                                  "compute_fid", "bench"])
def test_tools_refuse_without_a_gpu(ws, tmp_path, monkeypatch, tool):
    """Without a GPU and without --device cpu each tool raises before it
    writes anything."""
    main, argv = _cli_calls(ws, tmp_path)[tool]
    before = _files(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert _files(tmp_path) == before


def test_weight_backed_scorers_and_extractors_name_their_item(ws, tmp_path, monkeypatch):
    """Without their weights the weight-backed scorers and extractors raise
    the reference's error naming the variable that holds them, and the
    tools write nothing (tests/test_torch_scorers.py runs them on tiny
    trees)."""
    from ecad_tpu_torch.scoring import clip_score, image_reward, inception

    for module in (clip_score, image_reward, inception):
        monkeypatch.setattr(module, "_RESIDENT", None)
    for var in ("ECAD_IMAGE_REWARD_CHECKPOINT", "ECAD_IMAGE_REWARD_TOKENIZER",
                "ECAD_CLIP_MODEL_DIR", "ECAD_INCEPTION_CHECKPOINT"):
        monkeypatch.delenv(var, raising=False)
    calls = _cli_calls(ws, tmp_path)
    images = str(tmp_path / "imgs")
    with pytest.raises(RuntimeError, match="ECAD_CLIP_MODEL_DIR"):
        tscore.main(["--image-dir", images, "--scorer", "clip", *CPU])
    with pytest.raises(RuntimeError, match="ECAD_IMAGE_REWARD_CHECKPOINT"):
        tscore.main(["--image-dir", images, "--scorer", "image_reward", *CPU])
    with pytest.raises(RuntimeError, match="ECAD_CLIP_MODEL_DIR"):
        tclip.main([*calls["compute_clip"][1][:4], *CPU])  # --scorer clip by default
    for extractor, var in (("inception", "ECAD_INCEPTION_CHECKPOINT"),
                           ("clip_vision", "ECAD_CLIP_MODEL_DIR")):
        with pytest.raises(RuntimeError, match=var):
            tfid.main(["--image-dir", images, "--stats", str(tmp_path / "x.npz"),
                       "--make-stats", "--extractor", extractor, *CPU])
    assert not list(tmp_path.rglob("*scores.json")) and not (tmp_path / "x.npz").exists()


def test_generate_embeddings_weights_root_encodes_with_t5(ws, tmp_path, monkeypatch):
    """`generate_embeddings --weights-root` on a tiny checkpoint tree
    (tests/test_torch_checkpoints.py, both packages' generators resized to
    it): the same file names as the JAX tool's, T5 embeddings within 2e-5
    and the tokenizer's masks equal."""
    from test_torch_checkpoints import patch_tiny, write_pixart_tree

    patch_tiny(monkeypatch)
    root = write_pixart_tree(tmp_path / "w")
    argv = ["PixArtAlphaImageGenerator", "--prompt-file", str(ws / "prompts.json"),
            "--weights-root", str(root)]
    temb.main([*argv, "--output-dir", str(tmp_path / "t"), *CPU])
    jemb.main([*argv, "--output-dir", str(tmp_path / "j")])
    got, want = load_embedding_dir(tmp_path / "t"), load_embedding_dir(tmp_path / "j")
    assert [e["name"] for e in got] == [e["name"] for e in want] and len(got) == 2
    for g, w in zip(got, want):
        for key in ("prompt_attention_mask", "negative_prompt_attention_mask"):
            np.testing.assert_array_equal(g[key], w[key])
        for key in ("prompt_embeds", "negative_prompt_embeds"):
            assert g[key].shape == (8, 32)
            np.testing.assert_allclose(g[key], w[key], rtol=2e-5, atol=2e-5)
