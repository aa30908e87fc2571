"""The port's checkpoint loaders and converters (models/weights.py, the
checkpoint halves of models/vae.py, t5.py and clip.py) against the JAX
package's on the CPU.

State dicts carry diffusers and transformers key names: PixArt's and
FLUX's as tests/test_weight_conversion.py builds them, T5's, CLIP's and the
VAE's from chip_smoke.py's specs, filled from a seeded generator; files
are written with the ``safetensors`` package and ``torch.save``. The
port's trees must equal the reference's array for array (the port keeps
each tensor's dtype where the reference widens to fp32, so values are
compared after widening, bit for bit)."""

import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import clip as jclip
from ecad_tpu.models import pixart as jpx
from ecad_tpu.models import t5 as jt5
from ecad_tpu.models import vae as jvae
from ecad_tpu.models import weights as jw
from ecad_tpu.models.flux import FluxConfig as JFluxConfig
from ecad_tpu_torch.models import clip as tclip
from ecad_tpu_torch.models import flux as tfx
from ecad_tpu_torch.models import pixart as tpx
from ecad_tpu_torch.models import t5 as tt5
from ecad_tpu_torch.models import vae as tvae
from ecad_tpu_torch.models import weights as tw
from ecad_tpu_torch.models.bridge import pixart_state_dict
from test_weight_conversion import _flux_state, _pixart_state

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")


# ---------------------------------------------------------------------------
# state-dict builders (diffusers / transformers key names): the name →
# shape specs of chip_smoke.py's checkpoints phase, filled from a seeded
# generator on the CPU, plus the tensors public files carry that no
# converter reads
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _state(spec: dict, seed: int) -> dict:
    return {k: v.numpy() for k, v in
            CS.seeded_arrays(spec, seed, torch.float32, device="cpu").items()}


def vae_state(c, seed=0) -> dict:
    """A diffusers AutoencoderKL state dict for `c`: the decoder, the
    post-quant conv, and two encoder tensors the decoder's converter skips."""
    state = _state(CS.vae_spec(c), seed)
    state["encoder.conv_in.weight"] = np.zeros((c.block_out_channels[0], 3, 3, 3), np.float32)
    state["quant_conv.weight"] = np.zeros((2 * c.latent_channels,) * 2 + (1, 1), np.float32)
    return state


def t5_state(c, seed=0) -> dict:
    """A transformers T5EncoderModel state dict for `c`, with the tied
    ``encoder.embed_tokens.weight`` the converter does not read."""
    state = _state(CS.t5_spec(c, range(c.num_layers)), seed)
    state["encoder.embed_tokens.weight"] = state["shared.weight"]
    return state


def clip_state(c, seed=0) -> dict:
    """A transformers CLIPTextModel state dict for `c`, with the
    ``position_ids`` buffer older files carry."""
    state = _state(CS.clip_spec(c), seed)
    state["text_model.embeddings.position_ids"] = np.arange(
        c.max_position_embeddings, dtype=np.int64)[None]
    return state


def torch_state(state: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def assert_trees_equal(got, want, path=""):
    """Same keys at every level; every port tensor, widened, bit-equal to
    the reference's array (of the same shape)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), path
    assert tuple(got.shape) == want.shape, (path, tuple(got.shape), want.shape)
    g = got.numpy() if got.dtype == torch.int8 else got.float().numpy()
    np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=path)


# ---------------------------------------------------------------------------
# load_state_dict
# ---------------------------------------------------------------------------


def test_load_state_dict_safetensors_shards_like_reference(tmp_path):
    """Two shards (F32 and F16) and an index file: the same keys and bit-equal
    arrays on both sides, in the files' dtypes."""
    state = _pixart_state(tpx.PixArtConfig.tiny())
    keys = sorted(state)
    half = len(keys) // 2
    safetensors_numpy.save_file({k: state[k] for k in keys[:half]},
                                str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors_numpy.save_file({k: state[k].astype(np.float16) for k in keys[half:]},
                                str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {}}))
    want = jw.load_state_dict(tmp_path)
    got = tw.load_state_dict(tmp_path)
    assert set(got) == set(want) == set(state)
    for k in keys:
        assert got[k].dtype == (torch.float32 if k in keys[:half] else torch.float16)
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_load_state_dict_bin_like_reference(tmp_path):
    state = t5_state(tt5.T5Config.tiny())
    state.pop("encoder.embed_tokens.weight")
    torch.save(torch_state(state), tmp_path / "pytorch_model.bin")
    want = jw.load_state_dict(tmp_path)
    got = tw.load_state_dict(tmp_path)
    assert set(got) == set(want) == set(state)
    for k in state:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


REFERENCE_LOADER_ALONE = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("w", sys.argv[1])
w = importlib.util.module_from_spec(spec)
spec.loader.exec_module(w)
assert "ml_dtypes" not in sys.modules
try:
    w.load_state_dict(sys.argv[2])
except TypeError as e:
    print("TypeError", e)
"""


def test_bf16_safetensors_read_by_port_and_by_reference_only_beside_jax(tmp_path):
    """FLUX.1-dev ships in bf16: the port reads the file bit for bit, in
    bf16. The reference's numpy reader gives the same bits where JAX (and
    with it ``ml_dtypes``, which teaches numpy ``bfloat16``) is loaded, as in
    this process and in every process of the JAX package; its loader alone
    raises TypeError."""
    import subprocess
    import sys
    from pathlib import Path

    rng = np.random.default_rng(3)
    tensors = {f"w{i}": torch.from_numpy(rng.standard_normal((5, 7), dtype=np.float32))
               .to(torch.bfloat16) for i in range(3)}
    safetensors_torch.save_file(tensors, str(tmp_path / "model.safetensors"))
    got = tw.load_state_dict(tmp_path)
    want = jw.load_state_dict(tmp_path)
    for k, v in tensors.items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), v.view(torch.int16))
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      want[k].view(np.int16))
    ref = Path(jw.__file__)
    r = subprocess.run([sys.executable, "-c", REFERENCE_LOADER_ALONE, str(ref),
                        str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("TypeError") and "bfloat16" in r.stdout


def test_reader_takes_every_listed_dtype_and_refuses_others(tmp_path):
    rng = np.random.default_rng(4)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal(6, dtype=np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal(4, dtype=np.float32)).bfloat16(),
        "i64": torch.arange(5, dtype=torch.int64) - 2,
        "i32": torch.arange(3, dtype=torch.int32) * -7,
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 1, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "empty": torch.zeros((0, 4)),
    }
    safetensors_torch.save_file(tensors, str(tmp_path / "a.safetensors"))
    got = tw.read_safetensors(tmp_path / "a.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    safetensors_torch.save_file({"f64": torch.zeros(2, dtype=torch.float64)},
                                str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        tw.read_safetensors(tmp_path / "b.safetensors")


def test_reader_copies_an_unaligned_tensor(tmp_path):
    """A 3-byte U8 tensor ahead of an F32 one leaves the F32 bytes at an odd
    offset: the reader gives it aligned bytes of its own, the same values."""
    f32 = np.array([1.5, -2.25, 3.0], np.float32)
    u8 = np.array([7, 8, 9], np.uint8)
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [3], "data_offsets": [3, 15]}}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    (tmp_path / "u.safetensors").write_bytes(
        struct.pack("<Q", len(raw)) + raw + u8.tobytes() + f32.tobytes())
    got = tw.read_safetensors(tmp_path / "u.safetensors")
    np.testing.assert_array_equal(got["a"].numpy(), u8)
    np.testing.assert_array_equal(got["b"].numpy(), f32)


def test_no_weight_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tw.load_state_dict(tmp_path)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [256, 1024])
def test_convert_pixart_like_reference(side):
    kw = {} if side == 256 else dict(use_additional_conditions=True, dim=48,
                                     num_heads=4, head_dim=12)
    config = jpx.PixArtConfig.tiny(**kw)
    state = _pixart_state(config)
    want = jw.convert_pixart_state_dict(state, config)
    got = tw.convert_pixart_state_dict(torch_state(state), config)
    assert_trees_equal(got, want)
    assert ("resolution_embedder" in got["adaln_single"]) == (side == 1024)


def test_convert_flux_like_reference():
    config = JFluxConfig.tiny()
    state = _flux_state(config)
    assert_trees_equal(tw.convert_flux_state_dict(torch_state(state), config),
                       jw.convert_flux_state_dict(state, config))


@pytest.mark.parametrize("old_attention", [False, True])
def test_convert_vae_decoder_like_reference(old_attention):
    """Also the old checkpoints' 1×1-conv attention projections."""
    config = jvae.VAEConfig.tiny()
    state = vae_state(config)
    if old_attention:
        for k in [k for k in state if ".attentions.0.to_" in k and k.endswith("weight")]:
            state[k] = state[k][:, :, None, None]
    assert_trees_equal(tvae.convert_vae_decoder_state_dict(torch_state(state), config),
                       jvae.convert_vae_decoder_state_dict(state, config))


def test_convert_t5_like_reference():
    config = jt5.T5Config.tiny(num_layers=3)
    state = t5_state(config)
    assert_trees_equal(tt5.convert_t5_state_dict(torch_state(state), config),
                       jt5.convert_t5_state_dict(state, config))


def test_convert_clip_like_reference():
    config = jclip.CLIPTextConfig.tiny()
    state = clip_state(config)
    assert_trees_equal(tclip.convert_clip_state_dict(torch_state(state), config),
                       jclip.convert_clip_state_dict(state, config))


@pytest.mark.parametrize("family", ["pixart", "flux"])
def test_unconsumed_key_raises_the_reference_error(family):
    """A checkpoint tensor no mapping reads fails loudly, with the
    reference's message; torch bookkeeping keys are tolerated."""
    if family == "pixart":
        config, state, key = jpx.PixArtConfig.tiny(), _pixart_state, \
            "adaln_single.emb.mystery_embedder.linear_1.weight"
        convert = (jw.convert_pixart_state_dict, tw.convert_pixart_state_dict)
    else:
        config, state, key = JFluxConfig.tiny(), _flux_state, \
            "transformer_blocks.0.attn.extra.weight"
        convert = (jw.convert_flux_state_dict, tw.convert_flux_state_dict)
    extra = state(config)
    extra[key] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError) as want:
        convert[0](extra, config)
    with pytest.raises(ValueError) as got:
        convert[1](torch_state(extra), config)
    assert str(got.value) == str(want.value) and key in str(got.value)
    tolerated = state(config)
    tolerated["text_model.embeddings.position_ids"] = np.zeros((1, 4), np.int64)
    convert[1](torch_state(tolerated), config)


@pytest.mark.parametrize("quant", ["int8_w", "int8_w_static"])
def test_storage_quantize_like_reference(quant):
    """The int8 kernels and fp32 scales of every weight-storage site are the
    reference's bit for bit; every other tensor passes through."""
    jcfg = jpx.PixArtConfig.tiny(quant=quant)
    tcfg = tpx.PixArtConfig.tiny(quant=quant)
    state = _pixart_state(jcfg)
    want = jw._storage_quantize(jw.convert_pixart_state_dict(state, jcfg), jcfg,
                                jpx.init_params)
    want = jax.tree.map(np.asarray, fnn.meta.unbox(want))
    got = tw._storage_quantize(
        pixart_state_dict(tw.convert_pixart_state_dict(torch_state(state), tcfg)),
        tcfg, tpx.PixArtTransformer)
    bridged = pixart_state_dict(want)
    assert set(got) == set(bridged)
    n_int8 = 0
    for k, v in bridged.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k].float(), v.float()), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == 10 * jcfg.num_blocks  # attn1 4, attn2 4, ff 2 a block
    model = tpx.PixArtTransformer(tcfg)
    model.load_state_dict(got, strict=True)


def test_storage_quantize_leaves_float_modes_alone():
    cfg = tpx.PixArtConfig.tiny(quant="int8")
    state = {"x": torch.ones(2)}
    assert tw._storage_quantize(state, cfg, tpx.PixArtTransformer) is state


def test_load_pixart_and_flux_params_like_reference(tmp_path):
    """`load_*_params` on a written tree: the port's state_dict equals the
    reference's param tree carried through `bridge`, and loads strictly
    into the port's module in the checkpoint's place (`init_model(state=)`)."""
    pcfg = jpx.PixArtConfig.tiny()
    d = tmp_path / "p" / "transformer"
    d.mkdir(parents=True)
    safetensors_numpy.save_file(_pixart_state(pcfg),
                                str(d / "diffusion_pytorch_model.safetensors"))
    want = pixart_state_dict(jw.load_pixart_params(tmp_path, "p", pcfg))
    got = tw.load_pixart_params(tmp_path, "p", tpx.PixArtConfig.tiny())
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k
    model = tpx.init_model(tpx.PixArtConfig.tiny(dtype=torch.bfloat16), device="cpu",
                           state=got)
    assert model.blocks[0].attn1.to_q.weight.dtype == torch.bfloat16
    assert torch.equal(model.blocks[0].attn1.to_q.weight,
                       got["blocks.0.attn1.to_q.weight"].bfloat16())

    fcfg = JFluxConfig.tiny()
    d = tmp_path / "f" / "transformer"
    d.mkdir(parents=True)
    fstate = {k: torch.from_numpy(v).bfloat16() for k, v in _flux_state(fcfg).items()}
    safetensors_torch.save_file(fstate, str(d / "diffusion_pytorch_model.safetensors"))
    got = tw.load_flux_params(tmp_path, "f", tfx.FluxConfig.tiny())
    model = tfx.init_model(tfx.FluxConfig.tiny(), device="cpu", state=got)
    sd = model.state_dict()
    assert torch.equal(sd["blocks.0.attn.to_q.weight"],
                       fstate["transformer_blocks.0.attn.to_q.weight"])
    # the QK-norm scales stay fp32 in the module, as built
    assert sd["blocks.0.attn.norm_qk.q_scale"].dtype == torch.float32
