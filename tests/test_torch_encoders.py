"""The port's text encoders (models/t5.py, models/clip.py) against the JAX
package's on the CPU: tiny fp32 configurations, the JAX encoder's seeded
init carried across through `bridge`, inputs made from numpy. Every
position is compared, padded ones included, within 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from ecad_tpu.models import clip as jclip
from ecad_tpu.models import t5 as jt5
from ecad_tpu_torch.models import clip as tclip
from ecad_tpu_torch.models import t5 as tt5
from ecad_tpu_torch.models.bridge import clip_state_dict, t5_state_dict

TOL = dict(rtol=2e-5, atol=2e-5)


def _params(model, *args):
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    return jax.tree.map(np.asarray, fnn.meta.unbox(params))


def _t5_pair(**kw):
    jcfg = jt5.T5Config.tiny(**kw)
    ids = np.zeros((1, 4), np.int32)
    params = _params(jt5.T5Encoder(jcfg), jnp.asarray(ids))
    model = tt5.T5Encoder(tt5.T5Config.tiny(**kw)).eval().requires_grad_(False)
    model.load_state_dict(t5_state_dict(params), strict=True)
    return jcfg, params, model


@pytest.mark.parametrize("seq", [10, 40])
def test_t5_encoder_matches_reference(seq):
    """A padded batch (one row masked after 6 tokens); 40 tokens reach the
    log-spaced position buckets."""
    jcfg, params, model = _t5_pair()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    mask = np.ones((2, seq), np.int32)
    mask[1, 6:] = 0
    want = jt5.T5Encoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)
    )
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and without a mask
    want = jt5.T5Encoder(jcfg).apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_t5_relative_position_buckets_equal():
    for q, k, nb, md in ((10, 10, 32, 128), (120, 120, 32, 128), (7, 300, 8, 16)):
        np.testing.assert_array_equal(
            tt5.relative_position_buckets(q, k, nb, md),
            jt5.relative_position_buckets(q, k, nb, md),
        )


def test_t5_bf16_keeps_norm_weights_and_output_fp32():
    """In bf16 the Dense weights are bf16, the norm weights and the position
    table fp32, and the output fp32 (bf16 × fp32 norm weight)."""
    cfg = tt5.T5Config.tiny(dtype=torch.bfloat16)
    model = tt5.T5Encoder(cfg)
    torch.nn.init.normal_(model.token_embedding)
    torch.nn.init.normal_(model.relative_attention_bias)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["layer_0.attention.q.weight"] == torch.bfloat16
    assert dtypes["layer_1.wo.weight"] == torch.bfloat16
    assert dtypes["layer_0.attn_layer_norm"] == torch.float32
    assert dtypes["relative_attention_bias"] == torch.float32
    assert dtypes["final_layer_norm"] == torch.float32
    with torch.no_grad():
        out = model(torch.arange(6)[None])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_clip_text_encoder_matches_reference():
    jcfg = jclip.CLIPTextConfig.tiny()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 97, (2, 12)).astype(np.int32)
    ids[0, 7] = ids[0, 10] = 98  # the first EOS is pooled
    ids[1, 11] = 98
    params = _params(jclip.CLIPTextEncoder(jcfg), jnp.asarray(ids))
    model = tclip.CLIPTextEncoder(tclip.CLIPTextConfig.tiny()).eval()
    model.load_state_dict(clip_state_dict(params), strict=True)
    want_h, want_p = jclip.CLIPTextEncoder(jcfg).apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got_h, got_p = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(got_p.numpy()[0], got_h.numpy()[0, 7])


class _Tok:
    """Tokenizer stand-in: ids from the prompt's bytes, then EOS and pad."""

    def __init__(self, vocab, eos, pad):
        self.vocab, self.eos, self.pad = vocab, eos, pad

    def __call__(self, prompt, padding, max_length, truncation, return_tensors):
        assert (padding, truncation, return_tensors) == ("max_length", True, "np")
        ids = [b % (self.vocab - 3) + 2 for b in prompt.encode()][: max_length - 1]
        ids.append(self.eos)
        n = len(ids)
        ids += [self.pad] * (max_length - n)
        return {"input_ids": np.array([ids], np.int64),
                "attention_mask": (np.arange(max_length) < n).astype(np.int64)[None]}


def test_pipelines_encode_like_the_reference():
    """`T5EncoderPipeline.encode` and `CLIPTextPipeline.encode_pooled` on
    one tokenizer: host arrays equal to the reference pipelines'."""
    jcfg, params, model = _t5_pair()
    tok = _Tok(jcfg.vocab_size, 1, 0)
    want_e, want_m = jt5.T5EncoderPipeline(jcfg, params, tok, 12).encode("a cat")
    got_e, got_m = tt5.T5EncoderPipeline(model.config, model, tok, 12).encode("a cat")
    assert got_e.dtype == np.float32 and got_e.shape == (12, 32)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got_e, want_e, **TOL)

    ccfg = jclip.CLIPTextConfig.tiny()
    cparams = _params(jclip.CLIPTextEncoder(ccfg), jnp.zeros((1, 16), jnp.int32))
    cmodel = tclip.CLIPTextEncoder(tclip.CLIPTextConfig.tiny()).eval()
    cmodel.load_state_dict(clip_state_dict(cparams))
    ctok = _Tok(ccfg.vocab_size, ccfg.eos_token_id, ccfg.eos_token_id)
    want = jclip.CLIPTextPipeline(ccfg, cparams, ctok).encode_pooled("a dog")
    got = tclip.CLIPTextPipeline(cmodel.config, cmodel, ctok).encode_pooled("a dog")
    np.testing.assert_allclose(got, want, **TOL)
