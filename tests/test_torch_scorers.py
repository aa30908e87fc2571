"""The scorer towers of the port (ImageReward, CLIP score, InceptionV3 FID)
against the JAX package on the CPU.

Each tower alone and end to end at the `tiny` configs (InceptionV3 at its
one size, on 2 images of 75²), with params bridged from the reference's
Flax tree (`models.bridge`); the three checkpoint converters on the same
synthetic checkpoint; the antialiased resize the scorers preprocess with;
the registry entries, the benchmark CLIs and the search CLI on tiny trees;
and the reference faults the port does not copy (ROADMAP.md §3 note 6).

Tolerances: the towers are fp32 in both packages; the port's outputs agree
with the reference's to fp32 round-off, 1e-5 relative plus 1e-5 of the
output's largest magnitude (1e-4 for InceptionV3's 94 convolutions), and
the resize within 1e-5 on [0, 1] pixels.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax
import jax.numpy as jnp

from ecad_tpu.models import clip as jclip
from ecad_tpu.scoring import clip_score as jcs
from ecad_tpu.scoring import image_reward as jir
from ecad_tpu.scoring import inception as jinc
from ecad_tpu_torch import scoring as tscoring
from ecad_tpu_torch.models import bridge
from ecad_tpu_torch.models import clip as tclip
from ecad_tpu_torch.models.common import load_module
from ecad_tpu_torch.scoring import clip_score as tcs
from ecad_tpu_torch.scoring import fid as tfid
from ecad_tpu_torch.scoring import image_reward as tir
from ecad_tpu_torch.scoring import inception as tinc
from test_torch_weights import CS, _state

pytest.importorskip("transformers")

REPO = Path(__file__).resolve().parent.parent
WORDS = "a the cat dog red blue photo of on mat sunset over sea bicycle".split()
PROMPTS = ["a red cat on the mat", "photo of a blue bicycle over the sea at sunset",
           "a dog"]


def close(got, want, rtol=1e-5, scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * np.abs(want).max())


def tensors(state: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def build(module_cls, config, params):
    with torch.device("meta"):
        model = module_cls(*config)
    return load_module(model, bridge._convert(params), torch.device("cpu"))


# ---------------------------------------------------------------------------
# synthetic checkpoints
# ---------------------------------------------------------------------------

VIT = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=4)
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=40, encoder_width=32)  # 35 tokens fit
MLP = (64, 16, 1)


def image_reward_state(seed=0, vit=VIT, bert=BERT, mlp=MLP) -> dict:
    """An ImageReward.pt-layout state dict (as tests/test_image_reward.py's
    `synthetic_image_reward_state`, at any widths; nonzero biases and norm
    affines, so that every converted leaf matters)."""
    rng = np.random.default_rng(seed)
    state = {}

    def rnd(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def lin(key, cin, cout):
        state[f"{key}.weight"], state[f"{key}.bias"] = rnd(cout, cin, std=cin ** -0.5), rnd(cout)

    def ln(key, d):
        state[f"{key}.weight"], state[f"{key}.bias"] = 1 + rnd(d, std=0.1), rnd(d)

    vd, p, bd = vit["hidden_size"], vit["patch_size"], bert["hidden_size"]
    ve = "blip.visual_encoder"
    state[f"{ve}.patch_embed.proj.weight"] = rnd(vd, 3, p, p, std=(3 * p * p) ** -0.5)
    state[f"{ve}.patch_embed.proj.bias"] = rnd(vd)
    state[f"{ve}.cls_token"] = rnd(1, 1, vd, std=1.0)
    state[f"{ve}.pos_embed"] = rnd(1, (vit["image_size"] // p) ** 2 + 1, vd, std=1.0)
    ln(f"{ve}.norm", vd)
    for i in range(vit["num_layers"]):
        b = f"{ve}.blocks.{i}"
        ln(f"{b}.norm1", vd)
        ln(f"{b}.norm2", vd)
        lin(f"{b}.attn.qkv", vd, 3 * vd)
        lin(f"{b}.attn.proj", vd, vd)
        lin(f"{b}.mlp.fc1", vd, 4 * vd)
        lin(f"{b}.mlp.fc2", 4 * vd, vd)
    te = "blip.text_encoder.bert"
    state[f"{te}.embeddings.word_embeddings.weight"] = rnd(bert["vocab_size"], bd, std=1.0)
    state[f"{te}.embeddings.position_embeddings.weight"] = rnd(
        bert["max_position_embeddings"], bd, std=1.0)
    ln(f"{te}.embeddings.LayerNorm", bd)
    for i in range(bert["num_layers"]):
        b = f"{te}.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{b}.attention.self.{n}", bd, bd)
            lin(f"{b}.crossattention.self.{n}", bd if n == "query" else bert["encoder_width"],
                bd)
        for a in ("attention", "crossattention"):
            lin(f"{b}.{a}.output.dense", bd, bd)
            ln(f"{b}.{a}.output.LayerNorm", bd)
        lin(f"{b}.intermediate.dense", bd, bert["intermediate_size"])
        lin(f"{b}.output.dense", bert["intermediate_size"], bd)
        ln(f"{b}.output.LayerNorm", bd)
    for j, (cin, cout) in enumerate(zip((bd, *mlp[:-1]), mlp)):
        lin(f"mlp.layers.{2 * j}", cin, cout)  # the head's Linears sit between activations
    return state


def clip_state(dims=(32, 32)) -> dict:
    """A transformers CLIPModel state dict at the tiny widths (vision, text)
    and a 16-wide projection: chip_smoke's name → shape specs, seeded
    (test_torch_weights' `_state`)."""
    vision, text = dims
    spec = {**CS.clip_vision_spec(tcs.CLIPVisionConfig.tiny(hidden_size=vision)),
            **CS.clip_spec(tclip.CLIPTextConfig.tiny(hidden_size=text))}
    CS._lin_spec(spec, "visual_projection", vision, 16, bias=False)
    CS._lin_spec(spec, "text_projection", text, 16, bias=False)
    return _state(spec, 3)


def inception_state() -> dict:
    """A pt_inception-layout state dict: tests/test_inception.py's
    independent torch mirror with default init and random batchnorm
    statistics."""
    from test_inception import TorchInceptionFID

    torch.manual_seed(0)
    tm = TorchInceptionFID().eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.8, 1.2)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}


def write_bert_tokenizer(d: Path) -> Path:
    """A WordPiece vocab.txt of 64 ids ([PAD] 0, [UNK] 1, [CLS] 2, [SEP] 3),
    loadable by AutoTokenizer through its tokenizer_config.json."""
    d.mkdir(parents=True, exist_ok=True)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS]
    vocab += [f"w{i}" for i in range(BERT["vocab_size"] - len(vocab))]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
         "model_max_length": 512}))
    return d


def write_image_reward_dir(d: Path, tokenizer_subdir: str | None = None) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    torch.save(tensors(image_reward_state()), d / "ImageReward.pt")
    write_bert_tokenizer(d / tokenizer_subdir if tokenizer_subdir else d)
    return d


def write_clip_dir(d: Path, dims=(32, 32)) -> Path:
    """An HF-layout CLIP directory: config.json (transformers' keys),
    model.safetensors and a WordLevel tokenizer (EOS 98, the vocabulary's
    last id)."""
    from safetensors.numpy import save_file
    from test_torch_checkpoints import write_tokenizer

    d.mkdir(parents=True, exist_ok=True)
    save_file(clip_state(dims), str(d / "model.safetensors"))
    layers = dict(intermediate_size=64, num_hidden_layers=2, num_attention_heads=4)
    (d / "config.json").write_text(json.dumps({
        "projection_dim": 16,
        "vision_config": dict(image_size=16, patch_size=8, hidden_size=dims[0], **layers),
        "text_config": dict(vocab_size=99, hidden_size=dims[1], max_position_embeddings=16,
                            **layers)}))
    write_tokenizer(d)
    return d


def write_inception_checkpoint(path: Path) -> Path:
    torch.save(inception_state(), path)
    return path


def patch_tiny_towers(monkeypatch):
    """The port's full-size ImageReward configs resized to the tiny tree's."""
    monkeypatch.setattr(tir.ViTConfig, "large", classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(tir.BertConfig, "base", classmethod(lambda cls: cls.tiny(**BERT)))


def bert_tokenizer(tmp_path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(write_bert_tokenizer(tmp_path / "tok")))


def uint8_images(n, side, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def reference_image_reward(tokenizer):
    params = jir.convert_image_reward_state_dict(image_reward_state())
    return jir.ImageRewardScorer(params, tokenizer, jir.ViTConfig.tiny(),
                                 jir.BertConfig.tiny(**BERT), mlp_dims=MLP)


def reference_clip(model_dir):
    state = clip_state()
    vcfg, tcfg = jcs.CLIPVisionConfig.tiny(), jclip.CLIPTextConfig.tiny()
    from transformers import AutoTokenizer

    return jcs.CLIPScorer(vcfg, tcfg, jcs.convert_clip_vision_state_dict(state, vcfg),
                          jclip.convert_clip_state_dict(state, tcfg),
                          state["visual_projection.weight"].T,
                          state["text_projection.weight"].T,
                          AutoTokenizer.from_pretrained(str(model_dir)))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side,size,method", [(256, 224, "bicubic"), (1024, 224, "bicubic"),
                                              (256, 299, "bilinear"), (1024, 299, "bilinear")])
def test_resize_matches_jax_image_resize(side, size, method):
    """`resize_images` (F.interpolate with antialias) against
    jax.image.resize on [0, 1] pixels, within 1e-5."""
    x = np.random.default_rng(side + size).random((2, side, side, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), method=method))
    got = tfid.resize_images(torch.from_numpy(x).permute(0, 3, 1, 2), size, method)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the three converters
# ---------------------------------------------------------------------------

def _converted(name):
    if name == "image_reward":
        state = image_reward_state()
        return (jir.convert_image_reward_state_dict(state),
                tir.convert_image_reward_state_dict(tensors(state)))
    if name == "clip_vision":
        state = clip_state()
        return (jcs.convert_clip_vision_state_dict(state, jcs.CLIPVisionConfig.tiny()),
                tcs.convert_clip_vision_state_dict(tensors(state),
                                                   tcs.CLIPVisionConfig.tiny()))
    state = inception_state()
    return (jinc.convert_inception_state_dict({k: v.numpy() for k, v in state.items()}),
            tinc.convert_inception_state_dict(state))


@pytest.mark.parametrize("name", ["image_reward", "clip_vision", "inception"])
def test_converters_give_the_reference_tree(name):
    """The port's converter and the reference's, on one synthetic
    checkpoint, give the same tree of equal arrays; the bridge then loads it
    into the port's module with every parameter filled (strict)."""
    want, got = _converted(name)
    fw, fg = flat(want), flat(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        np.testing.assert_array_equal(fg[k].numpy(), np.asarray(fw[k]), err_msg="/".join(k))
    module = {"image_reward": lambda: tir.ImageRewardModel(
                  tir.ViTConfig.tiny(), tir.BertConfig.tiny(**BERT), MLP),
              "clip_vision": lambda: tcs.CLIPVisionEncoder(tcs.CLIPVisionConfig.tiny()),
              "inception": tinc.InceptionV3FID}[name]
    to_state = {"image_reward": bridge.image_reward_state_dict,
                "clip_vision": bridge.clip_vision_state_dict,
                "inception": bridge.inception_state_dict}[name]
    with torch.device("meta"):
        model = module()
    load_module(model, to_state(got), torch.device("cpu"))


# ---------------------------------------------------------------------------
# ImageReward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ir_pair():
    params = jir.convert_image_reward_state_dict(image_reward_state())
    vit, bert = jir.ViTConfig.tiny(), jir.BertConfig.tiny(**BERT)
    model = build(tir.ImageRewardModel, (tir.ViTConfig.tiny(), tir.BertConfig.tiny(**BERT), MLP),
                  params)
    return params, vit, bert, model


@pytest.mark.parametrize("tower", ["vit", "bert", "mlp", "model"])
def test_image_reward_towers_match_reference(ir_pair, tower):
    """ViT, the cross-attention BERT with a ragged mask, the reward head and
    the whole model on seeded inputs."""
    params, vit, bert, model = ir_pair
    rng = np.random.default_rng(1)
    px = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(0, 64, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, 5:] = 0
    ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
    feats = rng.standard_normal((3, 32)).astype(np.float32)
    t = torch.from_numpy
    with torch.no_grad():
        if tower == "vit":
            want = jax.jit(jir.VisionTransformer(vit).apply)(
                {"params": params["visual_encoder"]}, jnp.asarray(px))
            got = model.visual_encoder(t(px).permute(0, 3, 1, 2))
        elif tower == "bert":
            want = jax.jit(jir.BertCrossEncoder(bert).apply)(
                {"params": params["text_encoder"]}, jnp.asarray(ids), jnp.asarray(ctx),
                jnp.asarray(mask))
            got = model.text_encoder(t(ids), t(ctx), t(mask))
        elif tower == "mlp":
            want = jir.RewardMLP(MLP).apply({"params": params["mlp"]}, jnp.asarray(feats))
            got = model.mlp(t(feats))
        else:
            want = jax.jit(jir.ImageRewardModel(vit, bert, mlp_dims=MLP).apply)(
                {"params": params}, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask))
            got = model(t(px).permute(0, 3, 1, 2), t(ids), t(mask))
    close(got.numpy(), np.asarray(want))


def test_image_reward_scorer_payload_matches_reference(ir_pair, tmp_path):
    """`ImageRewardScorer` end to end — uint8 images at 24² (bicubic to the
    ViT's 16²), a BERT tokenizer's 35 tokens, the payload — against the
    reference's, as a numpy array and as a tensor."""
    tok = bert_tokenizer(tmp_path)
    imgs = uint8_images(3, 24)
    want = reference_image_reward(tok)(imgs, PROMPTS, ["p0", "p1", "p0"])
    scorer = tir.ImageRewardScorer(ir_pair[3], tok)
    for batch in (imgs, torch.from_numpy(imgs)):
        got = scorer(batch, PROMPTS, ["p0", "p1", "p0"])
        assert got.keys() == want.keys() and got["avg_by_prompt"].keys() == {"p0", "p1"}
        close([got["total_score"], *got["score_by_prompt_id"]["p0"]],
              [want["total_score"], *want["score_by_prompt_id"]["p0"]])


def test_image_reward_registry_entry_loads_the_tree(tmp_path, monkeypatch):
    """`get_scorer("image_reward")` builds the resident scorer from the
    ECAD_IMAGE_REWARD_* variables on the images' device (the CPU here) and
    scores like the reference's; without them it raises the reference's
    error."""
    patch_tiny_towers(monkeypatch)
    monkeypatch.setattr(tir, "_RESIDENT", None)
    d = write_image_reward_dir(tmp_path / "ir")
    imgs = uint8_images(3, 24)
    for var in (tir.ENV_CHECKPOINT, tir.ENV_TOKENIZER):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match=tir.ENV_CHECKPOINT):
        tscoring.get_scorer("image_reward")(torch.from_numpy(imgs), PROMPTS)
    monkeypatch.setenv(tir.ENV_CHECKPOINT, str(d / "ImageReward.pt"))
    monkeypatch.setenv(tir.ENV_TOKENIZER, str(d))
    got = tscoring.get_scorer("image_reward")(torch.from_numpy(imgs), PROMPTS)
    assert tir._RESIDENT.device == torch.device("cpu")
    want = reference_image_reward(tir._RESIDENT.tokenizer)(imgs, PROMPTS)
    close(got["total_score"], want["total_score"])


# ---------------------------------------------------------------------------
# CLIP score
# ---------------------------------------------------------------------------

def test_clip_vision_tower_matches_reference():
    state = clip_state()
    cfg = jcs.CLIPVisionConfig.tiny()
    params = jcs.convert_clip_vision_state_dict(state, cfg)
    model = build(tcs.CLIPVisionEncoder, (tcs.CLIPVisionConfig.tiny(),), params)
    px = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax.jit(jcs.CLIPVisionEncoder(cfg).apply)({"params": params}, jnp.asarray(px))
    with torch.no_grad():
        got = model(torch.from_numpy(px).permute(0, 3, 1, 2))
    close(got.numpy(), np.asarray(want))


def test_clip_scorer_from_tree_matches_reference(tmp_path):
    """`CLIPScorer.from_weights` on a tiny HF-layout tree (config.json,
    safetensors, a WordLevel tokenizer) against the reference's scorer
    built from the same arrays: features, payload."""
    d = write_clip_dir(tmp_path / "clip")
    scorer = tcs.CLIPScorer.from_weights(d, "cpu")
    assert scorer.vision_config == tcs.CLIPVisionConfig.tiny()
    assert scorer.text_config == tclip.CLIPTextConfig.tiny()
    ref = reference_clip(d)
    imgs = uint8_images(3, 20, seed=3)
    want = ref(imgs, PROMPTS)
    got = scorer(imgs, PROMPTS)
    close(list(got["avg_by_prompt"].values()), list(want["avg_by_prompt"].values()))
    feats = jcs.CLIPVisionEncoder(ref.vision_config).apply(
        {"params": ref.vision_params}, ref.preprocess(imgs))
    close(scorer.image_features(torch.from_numpy(imgs)).numpy(), np.asarray(feats))


# ---------------------------------------------------------------------------
# InceptionV3 FID
# ---------------------------------------------------------------------------

def test_inception_features_match_reference():
    """InceptionV3FID's 2048-d features on 2 images of 75² (its least input)
    through both converters, and the extractor's preprocessing (299²
    bilinear, 2x − 1) on 2 uint8 images against the reference's."""
    state = inception_state()
    params = jinc.convert_inception_state_dict({k: v.numpy() for k, v in state.items()})
    extractor = tinc.InceptionFeatureExtractor(
        build(tinc.InceptionV3FID, (), params))
    x = np.random.default_rng(4).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = jax.jit(jinc.InceptionV3FID().apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = extractor.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 2048)
    close(got.numpy(), np.asarray(want), rtol=1e-4, scale=1e-4)
    # the reference extractor's preprocessing (inception.py:262-267), fed
    # to the same network
    imgs = uint8_images(2, 40, seed=5)
    x = jax.image.resize(jnp.asarray(imgs, jnp.float32) / 255.0, (2, 299, 299, 3), "bilinear")
    with torch.no_grad():
        want = extractor.model(torch.from_numpy(np.asarray(2.0 * x - 1.0)).permute(0, 3, 1, 2))
    close(extractor(imgs), want.numpy(), rtol=1e-4, scale=1e-4)


# ---------------------------------------------------------------------------
# the reference's faults (ROADMAP.md §3 note 6)
# ---------------------------------------------------------------------------

def test_reference_get_scorer_clip_needs_its_module_imported():
    """Fault 1: in a fresh process the reference's get_scorer("clip") raises
    KeyError (it imports only image_reward), so its compute_clip's default
    scorer fails; the port registers clip on demand."""
    code = ("import os; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "from ecad_tpu.scoring import get_scorer\n"
            "try:\n    get_scorer('clip')\nexcept KeyError as e:\n    print('KeyError', e)\n"
            "from ecad_tpu_torch.scoring import get_scorer as tget\n"
            "print(tget('clip').__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "KeyError" in out.stdout and "unknown scorer 'clip'" in out.stdout
    assert out.stdout.strip().endswith("_clip_scorer")


def test_clip_from_weights_reads_the_towers_widths(tmp_path, monkeypatch):
    """Fault 2: the reference's CLIPScorer.from_weights builds fixed default
    configs. A tree at those defaults (here the tiny ones, patched into the
    reference) scores the same in both packages; a tree whose text tower is
    wider than the defaults fails to score in the reference, and the port
    reads its widths from config.json."""
    monkeypatch.setattr(jcs, "CLIPVisionConfig", jcs.CLIPVisionConfig.tiny)
    monkeypatch.setattr(jcs, "CLIPTextConfig", jclip.CLIPTextConfig.tiny)
    imgs = uint8_images(2, 16, seed=6)
    d = write_clip_dir(tmp_path / "defaults")
    want = jcs.CLIPScorer.from_weights(d)(imgs, PROMPTS[:2])
    got = tcs.CLIPScorer.from_weights(d, "cpu")(imgs, PROMPTS[:2])
    close(got["total_score"], want["total_score"])
    wide = write_clip_dir(tmp_path / "wide", dims=(32, 48))
    from flax.errors import ScopeParamShapeError

    with pytest.raises(ScopeParamShapeError, match=r"\(99, 48\)"):
        jcs.CLIPScorer.from_weights(wide)(imgs, PROMPTS[:2])
    scorer = tcs.CLIPScorer.from_weights(wide, "cpu")
    assert scorer.text_config.hidden_size == 48 and scorer.vision_config.hidden_size == 32
    assert np.isfinite(scorer(imgs, PROMPTS[:2])["total_score"])


# ---------------------------------------------------------------------------
# the CLIs on tiny trees
# ---------------------------------------------------------------------------

def _png_tree(root: Path, n=3, side=24) -> tuple[Path, Path]:
    """One schedule directory of PNGs named in the image_reward mode, and
    the prompt file that resolves their ids."""
    from PIL import Image

    d = root / "images" / "sched"
    d.mkdir(parents=True)
    for i, img in enumerate(uint8_images(n, side, seed=7)):
        Image.fromarray(img).save(d / f"{i:03d}__prompt_id:{i}__x__image_seed:0.png")
    prompts = root / "prompts.json"
    prompts.write_text(json.dumps([{"id": str(i), "prompt": PROMPTS[i % 3]}
                                   for i in range(n)]))
    return root / "images", prompts


def test_score_images_with_image_reward_on_a_tiny_tree(tmp_path, monkeypatch):
    from PIL import Image

    from ecad_tpu_torch.benchmark import score_images

    patch_tiny_towers(monkeypatch)
    monkeypatch.setattr(tir, "_RESIDENT", None)
    d = write_image_reward_dir(tmp_path / "ir")
    monkeypatch.setenv(tir.ENV_CHECKPOINT, str(d / "ImageReward.pt"))
    monkeypatch.setenv(tir.ENV_TOKENIZER, str(d))
    images, prompts = _png_tree(tmp_path)
    score_images.main(["--image-dir", str(images), "--prompt-file", str(prompts),
                       "--scorer", "image_reward", "--exactly-n-images", "3",
                       "--device", "cpu"])
    got = json.loads((images / "sched" / "scores.json").read_text())
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB"))
                     for p in sorted((images / "sched").glob("*.png"))])
    texts = [PROMPTS[i % 3] for i in range(3)]
    want = reference_image_reward(tir._RESIDENT.tokenizer)(imgs, texts, ["0", "1", "2"])
    assert got["avg_by_prompt"].keys() == {"0", "1", "2"}
    close(list(got["avg_by_prompt"].values()), list(want["avg_by_prompt"].values()))


def test_compute_clip_default_scorer_on_a_tiny_tree(tmp_path, monkeypatch):
    from ecad_tpu_torch.benchmark import compute_clip

    monkeypatch.setattr(tcs, "_RESIDENT", None)
    d = write_clip_dir(tmp_path / "clip")
    monkeypatch.setenv(tcs.ENV_MODEL_DIR, str(d))
    images, prompts = _png_tree(tmp_path)
    compute_clip.main(["--image-dir", str(images), "--prompt-file", str(prompts),
                       "--device", "cpu"])  # --scorer clip by default
    got = json.loads((images / "sched" / "clip_scores.json").read_text())
    assert len(got["score_by_prompt_id"]) == 3
    assert all(0 <= v <= 100 for v in got["avg_by_prompt"].values())


@pytest.mark.parametrize("extractor", ["inception", "clip_vision"])
def test_compute_fid_weight_backed_extractor_on_a_tiny_tree(tmp_path, monkeypatch, extractor):
    """`compute_fid --make-stats` then the FID of another tree; the
    registry's features are the reference's (clip_vision) or the
    extractor's built from the same checkpoint (inception)."""
    from PIL import Image

    from ecad_tpu_torch.benchmark import compute_fid

    if extractor == "inception":
        monkeypatch.setattr(tinc, "_RESIDENT", None)
        monkeypatch.setenv(tinc.ENV_CHECKPOINT,
                           str(write_inception_checkpoint(tmp_path / "pt_inception.pt")))
        dim = 2048
    else:
        monkeypatch.setattr(tcs, "_RESIDENT", None)
        monkeypatch.setenv(tcs.ENV_MODEL_DIR, str(write_clip_dir(tmp_path / "clip")))
        dim = 32
    a, b = tmp_path / "a", tmp_path / "b"
    for root, seed in ((a, 8), (b, 9)):
        root.mkdir()
        for i, img in enumerate(uint8_images(3, 20, seed)):
            Image.fromarray(img).save(root / f"{i}.png")
    stats = tmp_path / "stats.npz"
    compute_fid.main(["--image-dir", str(a), "--stats", str(stats), "--make-stats",
                      "--extractor", extractor, "--device", "cpu"])
    compute_fid.main(["--image-dir", str(b), "--stats", str(stats), "--extractor", extractor,
                      "--device", "cpu"])
    out = json.loads((b / "fid_scores.json").read_text())
    assert out["extractor"] == extractor and out["n_images"] == 3 and np.isfinite(out["fid"])
    with np.load(stats) as s:
        assert s["mu"].shape == (dim,) and str(s["extractor"]) == extractor
    imgs = uint8_images(3, 20, 8)
    got = tfid.get_extractor(extractor)(imgs, "cpu")
    if extractor == "clip_vision":
        ref = reference_clip(tmp_path / "clip")
        want = jcs.CLIPVisionEncoder(ref.vision_config).apply(
            {"params": ref.vision_params}, ref.preprocess(imgs))
        close(got, np.asarray(want))
    else:  # the reference extractor's parity: test_inception_features_match_reference
        want = tinc.InceptionFeatureExtractor.from_weights(tmp_path / "pt_inception.pt", "cpu")
        np.testing.assert_array_equal(got, want(imgs))


def test_train_searches_with_image_reward_on_a_tiny_tree(tmp_path, monkeypatch):
    """`genetic.train --scorer image_reward --image-reward-dir` (the
    tokenizer one level down) on the tiny PixArt tree: one cycle whose
    candidates are decoded by the tree's VAE and scored by the tiny
    ImageReward on the device the decode left them on; scores equal the
    reference scorer's on the same images."""
    from test_torch_checkpoints import patch_tiny, write_pixart_tree

    from ecad_tpu_torch.genetic import train
    from ecad_tpu_torch.models.vae import VAEDecoderPipeline

    patch_tiny(monkeypatch, reference=False)
    patch_tiny_towers(monkeypatch)
    monkeypatch.setattr(tir, "_RESIDENT", None)
    for var in (tir.ENV_CHECKPOINT, tir.ENV_TOKENIZER):
        monkeypatch.setenv(var, "")  # restored after the run sets them
    root = write_pixart_tree(tmp_path / "w")
    ir = write_image_reward_dir(tmp_path / "ir", tokenizer_subdir="bert-base-uncased")
    decoded = []
    decode = VAEDecoderPipeline.decode_device
    monkeypatch.setattr(VAEDecoderPipeline, "decode_device",
                        lambda self, z: decoded.append(decode(self, z)) or decoded[-1])
    train.main(["--name", "ir", "--population-size", "4", "--num-inference-steps", "3",
                "--num-prompts", "2", "--random-seed-gen-0", "--tiny-model", "--device", "cpu",
                "--num-cycles", "1", "--scorer", "image_reward", "--image-reward-dir", str(ir),
                "--weights-root", str(root), "--populations-dir", str(tmp_path / "pops"),
                "--benchmarks-dir", str(tmp_path / "bench")])
    assert os.environ[tir.ENV_TOKENIZER] == str(ir / "bert-base-uncased")
    assert len(decoded) == 4 and all(isinstance(x, torch.Tensor) for x in decoded)
    scores = sorted((tmp_path / "bench" / "ir" / "gen_001").rglob("scores.json"))
    assert len(scores) == 4
    ref = reference_image_reward(tir._RESIDENT.tokenizer)
    for path, imgs in zip(scores, decoded):
        got = json.loads(path.read_text())
        want = ref(imgs.numpy(), ["prompt_0", "prompt_1"])
        close(got["total_score"], want["total_score"])
