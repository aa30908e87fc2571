"""The port's FID (`ecad_tpu_torch.scoring.fid`, `compute_fid`) against the
JAX package's: `pixel_stats` features (JAX's antialiased linear resize,
rebuilt as one weight matrix per axis) within 1e-5, the Fréchet distance
exact on the same stats, stats files that load in either package, and the
FID of a directory against its own stats."""

import json

import numpy as np
import pytest

from ecad_tpu.benchmark import compute_fid as jtool
from ecad_tpu.scoring import fid as jfid
from ecad_tpu_torch.benchmark import compute_fid as ttool
from ecad_tpu_torch.scoring import fid as tfid

CPU = ["--device", "cpu"]


def _images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(3, 256, 256, 3), (4, 37, 53, 3), (2, 8, 8, 3),
                                   (2, 5, 300, 3)])
def test_pixel_stats_features_match(shape):
    """Downsampling (256², 37×53, 300 wide), an unchanged axis (8) and
    upsampling (5 high) give JAX's features within 1e-5."""
    imgs = _images(shape)
    want = jfid.pixel_stats_extractor(imgs)
    got = tfid.pixel_stats_extractor(imgs, "cpu")
    assert got.shape == want.shape == (shape[0], 192) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(256, 8), (37, 8), (53, 8), (5, 8), (8, 8)])
def test_resize_weights_are_jax_weight_matrices(n_in, n_out):
    """Each axis's matrix is JAX's ``compute_weight_mat`` for the linear
    (triangle) kernel with antialiasing."""
    from jax._src.image import scale as jscale

    kernel = jscale._kernels[jscale.ResizeMethod.LINEAR]
    want = jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel, True)
    got = tfid.triangle_resize_weights(n_in, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_frechet_distance_and_fid_between_are_exact():
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((40, 12)) * s + m for s, m in ((1.0, 0.0), (1.3, 0.2))]
    stats = [tfid.compute_statistics(f) for f in feats]
    for (mu, sigma), f in zip(stats, feats):
        jmu, jsigma = jfid.compute_statistics(f)
        np.testing.assert_array_equal(mu, jmu)
        np.testing.assert_array_equal(sigma, jsigma)
    (m1, s1), (m2, s2) = stats
    assert tfid.frechet_distance(m1, s1, m2, s2) == jfid.frechet_distance(m1, s1, m2, s2)
    a = tfid.FIDStats(m1, s1, "pixel_stats", 40)
    b = tfid.FIDStats(m2, s2, "pixel_stats", 40)
    want = jfid.fid_between(jfid.FIDStats(m1, s1, "pixel_stats", 40),
                            jfid.FIDStats(m2, s2, "pixel_stats", 40))
    assert tfid.fid_between(a, b) == want > 0
    assert tfid.fid_between(a, a) == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError, match="incomparable"):
        tfid.fid_between(a, tfid.FIDStats(m2, s2, "inception", 40))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stats_files_load_in_either_package(tmp_path, writer):
    imgs = _images((6, 32, 32, 3), seed=1)
    path = tmp_path / "stats.npz"
    if writer == "jax":
        jfid.FIDStats.from_images(imgs).save(path)
        stats = tfid.FIDStats.load(path, expect_extractor="pixel_stats")
        other = jfid.FIDStats.load(path)
    else:
        tfid.FIDStats.from_images(imgs, device="cpu").save(path)
        stats = jfid.FIDStats.load(path, expect_extractor="pixel_stats")
        other = tfid.FIDStats.load(path)
    assert (stats.extractor, stats.n) == (other.extractor, other.n) == ("pixel_stats", 6)
    np.testing.assert_array_equal(stats.mu, other.mu)
    np.testing.assert_array_equal(stats.sigma, other.sigma)
    with pytest.raises(ValueError, match="expected 'inception'"):
        tfid.FIDStats.load(path, expect_extractor="inception")


def _image_dir(root, n=6, side=48, seed=2):
    from PIL import Image

    root.mkdir(parents=True)
    for i, img in enumerate(_images((n, side, side, 3), seed)):
        Image.fromarray(img).save(root / f"{i:03d}__prompt_seed:000__image_seed:000.png")
    return root


def test_compute_fid_against_own_stats_and_the_jax_tool(tmp_path):
    """A directory against its own stats: FID ≤ 1e-6. Another directory
    against stats the JAX tool made: the JAX tool's FID, within the
    features' 1e-5."""
    ref = _image_dir(tmp_path / "ref")
    stats = tmp_path / "ref_stats.npz"
    ttool.main(["--image-dir", str(ref), "--stats", str(stats), "--make-stats", *CPU])
    ttool.main(["--image-dir", str(ref), "--stats", str(stats), *CPU])
    out = json.loads((ref / "fid_scores.json").read_text())
    assert abs(out["fid"]) <= 1e-6
    assert out["n_images"] == 6 and out["extractor"] == "pixel_stats"

    other = _image_dir(tmp_path / "other", seed=9)
    jstats = tmp_path / "jax_stats.npz"
    jtool.main(["--image-dir", str(ref), "--stats", str(jstats), "--make-stats"])
    jtool.main(["--image-dir", str(other), "--stats", str(jstats),
                "--output", str(tmp_path / "jax_fid.json")])
    ttool.main(["--image-dir", str(other), "--stats", str(jstats),
                "--output", str(tmp_path / "torch_fid.json"), *CPU])
    want = json.loads((tmp_path / "jax_fid.json").read_text())
    got = json.loads((tmp_path / "torch_fid.json").read_text())
    assert got.keys() == want.keys() and got["n_images"] == want["n_images"]
    assert got["fid"] > 0
    assert got["fid"] == pytest.approx(want["fid"], rel=1e-4)


@pytest.mark.parametrize("name", ["inception", "clip_vision"])
def test_weight_backed_extractors_name_their_item(name, monkeypatch):
    """The weight-backed extractors resolve and, without their weights,
    raise the reference's error naming the variable that holds them."""
    from ecad_tpu_torch.scoring import clip_score, inception

    var = {"inception": "ECAD_INCEPTION_CHECKPOINT", "clip_vision": "ECAD_CLIP_MODEL_DIR"}[name]
    monkeypatch.setattr({"inception": inception, "clip_vision": clip_score}[name],
                        "_RESIDENT", None)
    monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match=var):
        tfid.get_extractor(name)(np.zeros((1, 8, 8, 3), np.uint8), "cpu")
    with pytest.raises(KeyError):
        tfid.get_extractor("no_such_extractor")
