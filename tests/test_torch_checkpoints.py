"""The slice as a whole on the CPU: a tiny checkpoint tree on disk (a tiny
PixArt or FLUX transformer, tiny T5 and CLIP encoders, a tiny VAE, and a
WordLevel ``tokenizer.json`` built offline with ``tokenizers``), served by
the JAX package's generator and by the port's from the same files.

The generators' full-size configurations are monkeypatched to the tiny
ones here, in the test only: ``model_config``, the block counts, text
length and image side on the generator classes, ``T5Config.xxl``,
``VAEConfig.sd`` / ``.flux`` and the CLIP config on both packages. Noise
comes from numpy and goes to both pipelines (jax.random and
torch.Generator give different numbers from one seed). Everything is
fp32: embeddings agree within 2e-5, masks exactly, final latents within
1e-4 relative plus 1e-5 of their largest magnitude (the random checkpoints
drive them to a few hundred), uint8 images within one level."""

import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import jax.numpy as jnp

from ecad_tpu.image_generators import flux as jgf
from ecad_tpu.image_generators import pixart as jgp
from ecad_tpu.models import clip as jclip
from ecad_tpu.models import flux as jfx
from ecad_tpu.models import pixart as jpx
from ecad_tpu.models import t5 as jt5
from ecad_tpu.models import vae as jvae
from ecad_tpu_torch.image_generators import flux as tgf
from ecad_tpu_torch.image_generators import pixart as tgp
from ecad_tpu_torch.models import clip as tclip
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models import t5 as tt5
from ecad_tpu_torch.models import vae as tvae
from test_torch_weights import CS, clip_state, t5_state, vae_state
from test_weight_conversion import _flux_state, _pixart_state

safetensors_numpy = pytest.importorskip("safetensors.numpy")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

PIXART_256 = "PixArt-alpha/PixArt-XL-2-256x256"
PIXART_PIPE = "PixArt-alpha/PixArt-XL-2-1024-MS"
FLUX = "black-forest-labs/FLUX.1-dev"
STEPS = 4
TEXT_LEN = 8
EOS = 98  # the tiny CLIP's EOS id, below both tiny vocabularies
WORDS = "a the cat dog red blue photo of on mat sunset over sea bicycle".split()
PROMPTS = ["a red cat on the mat", "photo of a blue bicycle over the sea at sunset"]

EMB_TOL = dict(rtol=2e-5, atol=2e-5)
JCLIPConfig = jclip.CLIPTextConfig  # `patch_tiny` replaces the module's name

T5_TINY = dict(num_layers=2)
PIXART_TINY = {}
FLUX_TINY = dict(in_channels=64, pooled_dim=32)  # 16 latent channels, CLIP's width
VAE_FLUX_TINY = dict(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159)


def write_tokenizer(d, eos=EOS):
    """A WordLevel tokenizer (pad 0, unk 1, words, EOS) that appends EOS."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    fill = [f"w{i}" for i in range(eos - 2 - len(WORDS))]
    vocab = {"<pad>": 0, "<unk>": 1, **{w: i + 2 for i, w in enumerate(WORDS + fill)},
             "</s>": eos}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", eos)])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
        "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}))


def _save(d, state, name="model.safetensors", shards=1):
    d.mkdir(parents=True, exist_ok=True)
    keys = sorted(state)
    for i in range(shards):
        part = keys[i::shards]
        fname = name if shards == 1 else f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        safetensors_numpy.save_file({k: np.ascontiguousarray(state[k]) for k in part},
                                    str(d / fname))


def write_pixart_tree(root):
    """PixArt-α 256's transformer and the 1024-MS pipeline repo's T5 (two
    shards), tokenizer and VAE, at the tiny shapes."""
    _save(root / PIXART_256 / "transformer", _pixart_state(jpx.PixArtConfig.tiny()),
          "diffusion_pytorch_model.safetensors")
    _save(root / PIXART_PIPE / "text_encoder", t5_state(jt5.T5Config.tiny(**T5_TINY), 1),
          shards=2)
    write_tokenizer(root / PIXART_PIPE / "tokenizer")
    _save(root / PIXART_PIPE / "vae", vae_state(jvae.VAEConfig.tiny(), 2),
          "diffusion_pytorch_model.safetensors")
    return root


def write_flux_tree(root, public: bool):
    """FLUX.1-dev's repo at the tiny shapes: the public layout (CLIP in
    text_encoder/ + tokenizer/, T5 in text_encoder_2/ + tokenizer_2/), or
    the reference's, where both encoders are read from text_encoder/ and
    tokenizer/ (one directory holding both tensor sets)."""
    repo = root / FLUX
    fcfg = jfx.FluxConfig.tiny(**FLUX_TINY)
    _save(repo / "transformer", _flux_state(fcfg), "diffusion_pytorch_model.safetensors")
    t5 = t5_state(jt5.T5Config.tiny(**T5_TINY), 1)
    clip = clip_state(JCLIPConfig.tiny(hidden_size=32), 3)
    if public:
        _save(repo / "text_encoder", clip)
        write_tokenizer(repo / "tokenizer")
        _save(repo / "text_encoder_2", t5)
        write_tokenizer(repo / "tokenizer_2")
    else:
        _save(repo / "text_encoder", {**t5, **clip})
        write_tokenizer(repo / "tokenizer")
    _save(repo / "vae", vae_state(jvae.VAEConfig.tiny(**VAE_FLUX_TINY), 2),
          "diffusion_pytorch_model.safetensors")
    return root


def patch_tiny(monkeypatch, reference: bool = True):
    """The full-size generators and encoders of the port (and of the JAX
    package, with `reference`) resized to the tiny checkpoints' shapes."""
    sides = [(tgp, tgf, tt5, tvae, tclip, torch.float32, tpx, tfx)]
    if reference:
        sides.append((jgp, jgf, jt5, jvae, jclip, jnp.float32, jpx, jfx))
    for gp, gf, t5, vae, clip, f32, px, fx in sides:
        monkeypatch.setattr(gp.PixArtImageGenerator, "model_config", lambda self, px=px, f32=f32:
                            px.PixArtConfig.tiny(dtype=f32, quant=self.quant, **PIXART_TINY))
        monkeypatch.setattr(gp.PixArtImageGenerator, "num_blocks", 2)
        monkeypatch.setattr(gp.PixArtImageGenerator, "text_len", TEXT_LEN)
        monkeypatch.setattr(gf.FluxImageGenerator, "model_config", lambda self, fx=fx, f32=f32:
                            fx.FluxConfig.tiny(dtype=f32, quant=self.quant, **FLUX_TINY))
        for name, value in (("num_blocks", 2), ("num_single_blocks", 3),
                            ("text_len", TEXT_LEN), ("height", 64), ("width", 64)):
            monkeypatch.setattr(gf.FluxImageGenerator, name, value)
        monkeypatch.setattr(t5.T5Config, "xxl", classmethod(
            lambda cls, t5=t5, f32=f32, **kw: t5.T5Config.tiny(dtype=f32, **{**T5_TINY, **kw})))
        monkeypatch.setattr(vae.VAEConfig, "sd", classmethod(
            lambda cls, vae=vae: vae.VAEConfig.tiny()))
        monkeypatch.setattr(vae.VAEConfig, "flux", classmethod(
            lambda cls, vae=vae: vae.VAEConfig.tiny(**VAE_FLUX_TINY)))
    tiny_clip = tclip.CLIPTextConfig.tiny(hidden_size=32)
    monkeypatch.setattr(tclip.CLIPTextConfig, "large", classmethod(lambda cls: tiny_clip))
    if reference:
        # the reference builds CLIP's config by calling the class
        jtiny = JCLIPConfig.tiny(hidden_size=32)
        monkeypatch.setattr(jclip, "CLIPTextConfig", lambda: jtiny)


@pytest.fixture()
def pixart_tree(tmp_path, monkeypatch):
    patch_tiny(monkeypatch)
    return write_pixart_tree(tmp_path / "weights")


def assert_latents_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _noise(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _stack(embeddings, key):
    return np.stack([np.asarray(e[key]) for e in embeddings])


def test_pixart_alpha_serves_the_tree_like_reference(pixart_tree, tmp_path):
    """T5 embeddings and masks, 4 DPM-Solver++ steps with CFG and the real
    masks, the VAE decode, and the PNGs `generate_images` writes."""
    jgen = jgp.PixArtAlphaImageGenerator(weights_root=pixart_tree,
                                         num_inference_steps=STEPS)
    tgen = tgp.PixArtAlphaImageGenerator(weights_root=pixart_tree,
                                         num_inference_steps=STEPS, device="cpu")
    jemb, temb = jgen.encode_prompts(PROMPTS), tgen.encode_prompts(PROMPTS)
    for key in ("prompt_attention_mask", "negative_prompt_attention_mask"):
        np.testing.assert_array_equal(_stack(temb, key), _stack(jemb, key))
    # the tokenizer's lengths, not the hash encoder's words + 1
    assert [int(m.sum()) for m in _stack(temb, "prompt_attention_mask")] == [7, 8]
    for key in ("prompt_embeds", "negative_prompt_embeds"):
        np.testing.assert_allclose(_stack(temb, key), _stack(jemb, key), **EMB_TOL)

    noise = _noise((2, 8, 8, 4))
    args = [_stack(jemb, k) for k in ("prompt_embeds", "negative_prompt_embeds",
                                      "prompt_attention_mask",
                                      "negative_prompt_attention_mask")]
    jpipe = jgen.create_diffusion_pipeline()
    want = np.asarray(jpipe.build_denoise_fn(donate=False)(jpipe.params, noise, *args))
    with torch.inference_mode():
        got = tgen.create_diffusion_pipeline().denoise(
            torch.from_numpy(noise), *(torch.from_numpy(a) for a in args))
    assert_latents_close(got.numpy(), want)
    assert isinstance(tgen._ensure_vae().model, tvae.VAEDecoder)
    img_t, img_j = tgen.decode_latents(got), jgen.decode_latents(jnp.asarray(want))
    assert img_t.shape == (2, 16, 16, 3) and img_t.dtype == np.uint8
    assert np.abs(img_t.astype(int) - np.asarray(img_j).astype(int)).max() <= 1

    images = tgen.generate_images(temb, output_dir=tmp_path / "out")
    assert len(list((tmp_path / "out").glob("*.png"))) == 2
    assert images[0].shape == (16, 16, 3)


def test_pixart_checkpoint_static_quant_calibrates_on_loaded_model(pixart_tree):
    """A static quant mode on a checkpoint: the model is loaded in the
    weight-storage layout and calibrated on it with the T5 embeddings."""
    gen = tgp.PixArtAlphaImageGenerator(weights_root=pixart_tree, quant="int8_w_static",
                                        num_inference_steps=2, device="cpu")
    model = gen.create_diffusion_pipeline().model
    assert model.config.act_scales is not None
    assert model.blocks[0].attn1.to_q.weight.dtype == torch.int8
    with torch.inference_mode():
        latents = gen._generate_latents(gen.encode_prompts(PROMPTS[:1]), seed=0)
    assert torch.isfinite(latents).all()


@pytest.fixture()
def flux_trees(tmp_path, monkeypatch):
    patch_tiny(monkeypatch)
    return (write_flux_tree(tmp_path / "merged", public=False),
            write_flux_tree(tmp_path / "public", public=True))


def test_flux_serves_the_reference_layout_like_reference(flux_trees):
    """T5 and CLIP read from text_encoder/ (the reference's layout): the
    embeddings, 4 flow-match steps and the 16-channel VAE decode agree."""
    root = flux_trees[0]
    jgen = jgf.FluxImageGenerator(weights_root=root, num_inference_steps=STEPS)
    tgen = tgf.FluxImageGenerator(weights_root=root, num_inference_steps=STEPS,
                                  device="cpu")
    jemb, temb = jgen.encode_prompts(PROMPTS), tgen.encode_prompts(PROMPTS)
    for key in ("prompt_embeds", "pooled_prompt_embeds"):
        np.testing.assert_allclose(_stack(temb, key), _stack(jemb, key), **EMB_TOL)
    txt, pooled = _stack(jemb, "prompt_embeds"), _stack(jemb, "pooled_prompt_embeds")
    noise = _noise((2, 16, 64))
    jpipe = jgen.create_diffusion_pipeline()
    want = np.asarray(jpipe.build_denoise_fn(donate=False)(jpipe.params, noise, txt, pooled))
    with torch.inference_mode():
        got = tgen.create_diffusion_pipeline().denoise(
            *(torch.from_numpy(a) for a in (noise, txt, pooled)))
    assert_latents_close(got.numpy(), want)
    lat_t = tfx.unpack_latents(got, 4, 4)
    lat_j = jfx.unpack_latents(jnp.asarray(want), 4, 4)
    img_t, img_j = tgen.decode_latents(lat_t), np.asarray(jgen.decode_latents(lat_j))
    assert img_t.shape == (2, 16, 16, 3)
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1


def test_flux_public_layout_reads_t5_from_text_encoder_2(flux_trees):
    """FLUX.1-dev's public layout: the port reads T5 from text_encoder_2/ and
    CLIP from text_encoder/, giving each encoder's own output; the
    reference's T5 loader reads text_encoder/ (CLIP's tensors) and fails."""
    root = flux_trees[1]
    repo = root / FLUX
    tgen = tgf.FluxImageGenerator(weights_root=root, num_inference_steps=STEPS,
                                  device="cpu")
    [emb] = tgen.encode_prompts(PROMPTS[:1])
    jcfg = jt5.T5Config.tiny(**T5_TINY)
    t5 = jt5.T5EncoderPipeline(jcfg, jt5.load_t5_weights(repo / "text_encoder_2", jcfg),
                               tgen.create_encoder_pipeline().t5.tokenizer, TEXT_LEN)
    np.testing.assert_allclose(emb["prompt_embeds"], t5.encode(PROMPTS[0])[0], **EMB_TOL)
    clip = jclip.CLIPTextPipeline.from_weights(root, FLUX)
    np.testing.assert_allclose(emb["pooled_prompt_embeds"],
                               clip.encode_pooled(PROMPTS[0]), **EMB_TOL)
    with pytest.raises(KeyError):
        jgf.FluxImageGenerator(weights_root=root).create_encoder_pipeline()


def test_inference_cli_serves_the_tree(pixart_tree, tmp_path):
    """`inference.cli --weights-root`: T5 embeddings saved, PNGs decoded by the
    checkpoint's VAE (16×16 from the 8×8 latents, where the latent
    visualisation would be 8×8), equal to the generator's own images."""
    from PIL import Image

    from ecad_tpu_torch.inference.cli import main
    from ecad_tpu_torch.utils.io import load_embedding_dir

    (tmp_path / "p.txt").write_text("\n".join(PROMPTS) + "\n")
    main(["PixArtAlphaImageGenerator", "--prompt-file", str(tmp_path / "p.txt"),
          "--weights-root", str(pixart_tree), "--num-inference-steps", str(STEPS),
          "--device", "cpu", "--output-dir", str(tmp_path / "o")])
    pngs = sorted((tmp_path / "o" / "images").glob("*.png"))
    assert len(pngs) == 2
    arrays = [np.asarray(Image.open(p)) for p in pngs]
    assert all(a.shape == (16, 16, 3) for a in arrays)
    gen = tgp.PixArtAlphaImageGenerator(weights_root=pixart_tree,
                                        num_inference_steps=STEPS, device="cpu")
    emb = load_embedding_dir(tmp_path / "o" / "embeddings")
    assert int(emb[0]["prompt_attention_mask"].sum()) == 7
    with torch.inference_mode():
        want = gen.generate_images(emb)
    for a, w in zip(arrays, want):
        np.testing.assert_array_equal(a, w)


def test_chip_smoke_writer_and_specs_make_loadable_trees(tmp_path):
    """chip_smoke's checkpoints phase on the CPU at the tiny shapes: its
    safetensors writer gives files the ``safetensors`` package reads back
    bit for bit (F32, F16, BF16); its PixArt and FLUX name → shape specs
    are the key sets tests/test_weight_conversion.py builds; every spec,
    filled and converted, loads into the port's module strictly; and its
    tokenizer stand-in pads and ends as T5's and CLIP's do."""
    from safetensors.torch import load_file

    from ecad_tpu_torch.models.bridge import (
        clip_state_dict,
        flux_state_dict,
        pixart_state_dict,
        t5_state_dict,
        vae_state_dict,
    )
    from ecad_tpu_torch.models.weights import (
        convert_flux_state_dict,
        convert_pixart_state_dict,
    )

    cs = CS
    arrays = {"a": torch.randn(3, 5), "b": torch.randn(7).half(),
              "c": torch.randn(2, 2, 3).bfloat16()}
    n = cs.write_safetensors(tmp_path / "x.safetensors", arrays)
    assert n == (tmp_path / "x.safetensors").stat().st_size
    back = load_file(str(tmp_path / "x.safetensors"))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)

    pcfg, fcfg = tpx.PixArtConfig.tiny(), tfx.FluxConfig.tiny()
    t5cfg, vcfg = tt5.T5Config.tiny(num_layers=3), tvae.VAEConfig.tiny()
    ccfg = tclip.CLIPTextConfig.tiny()
    assert set(cs.pixart_spec(pcfg)) == set(_pixart_state(pcfg))
    assert set(cs.flux_spec(fcfg)) == set(_flux_state(fcfg))
    assert set(cs.t5_spec(t5cfg, range(0, 2))) | set(cs.t5_spec(t5cfg, range(2, 3))) == \
        set(cs.t5_spec(t5cfg, range(3)))  # shards split by layer cover the model

    def arrays_of(spec, dtype=torch.float32):
        return cs.seeded_arrays(spec, 0, dtype, device="cpu")

    loads = [
        (tpx.PixArtTransformer(pcfg), pixart_state_dict(convert_pixart_state_dict(
            arrays_of(cs.pixart_spec(pcfg)), pcfg))),
        (tfx.FluxTransformer(fcfg), flux_state_dict(convert_flux_state_dict(
            arrays_of(cs.flux_spec(fcfg), torch.bfloat16), fcfg))),
        (tt5.T5Encoder(t5cfg), t5_state_dict(tt5.convert_t5_state_dict(
            arrays_of(cs.t5_spec(t5cfg, range(3)), torch.bfloat16), t5cfg))),
        (tvae.VAEDecoder(vcfg), vae_state_dict(tvae.convert_vae_decoder_state_dict(
            arrays_of(cs.vae_spec(vcfg)), vcfg))),
        (tclip.CLIPTextEncoder(ccfg), clip_state_dict(tclip.convert_clip_state_dict(
            arrays_of(cs.clip_spec(ccfg)), ccfg))),
    ]
    for model, state in loads:
        model.load_state_dict(state, strict=True)

    tok = cs.WordHashTokenizer(32128, 1, 0)
    out = tok("a red cat", max_length=8)
    assert out["input_ids"].shape == (1, 8) and out["input_ids"][0, 3] == 1
    assert out["attention_mask"].tolist() == [[1, 1, 1, 1, 0, 0, 0, 0]]
    clip = cs.WordHashTokenizer(49408, 49407, 49407, bos=49406)
    ids = clip("a red cat", max_length=77)["input_ids"][0]
    assert ids[0] == 49406 and ids[4] == 49407 and ids.max() <= 49407
