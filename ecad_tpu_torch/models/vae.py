"""AutoencoderKL decoder in PyTorch.

Counterpart of ``ecad_tpu/models/vae.py`` (:23-259): post-quant 1×1 conv →
conv_in → mid block (resnet, single-head spatial attention, resnet) → up
blocks of resnets with nearest ×2 upsampling between them → GroupNorm →
conv_out. The public functions take and return NHWC, as the reference
does; inside, the convolutions run NCHW through cuDNN. GroupNorm runs in
fp32 with eps 1e-6 and casts back. The mid-attention is plain
``matmul``/``softmax`` (the reference uses plain XLA attention there, :102),
with fp32 logits and softmax and probabilities cast back, as
``jax.nn.dot_product_attention`` does, taken in blocks of query rows so
that a 2048² image's 65536 tokens never hold all their logits at once
(each row's softmax is its own, so the function is unchanged). Module and
parameter names follow the reference's param tree, so
`bridge.vae_state_dict` maps one onto the other; a diffusers checkpoint
loads through `convert_vae_decoder_state_dict` and
`VAEDecoderPipeline.from_weights`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device

# fp32 logits the mid-attention holds at once (1 GiB): query rows are taken
# in blocks of this many divided by (batch · tokens) — one block at 256²
# (batch 8, 1024 tokens), two at 1024² (batch 2, 16384 tokens), 16 blocks
# of 4096 rows at 2048² (batch 1, 65536 tokens)
_MID_ATTENTION_LOGITS = 2**28


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    out_channels: int = 3
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    dtype: torch.dtype = torch.float32

    @classmethod
    def sd(cls, **kw) -> "VAEConfig":
        """PixArt's (SD) 4-channel autoencoder (ecad_tpu/models/vae.py:34-36)."""
        return cls(**kw)

    @classmethod
    def flux(cls, **kw) -> "VAEConfig":
        """FLUX.1's 16-channel autoencoder (ecad_tpu/models/vae.py:38-42)."""
        d = dict(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        d = dict(
            latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=4,
        )
        d.update(kw)
        return cls(**d)


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in fp32 (eps 1e-6), cast back to the input dtype."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype) -> None:
        super().__init__(groups, channels, eps=1e-6, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(),
            self.eps,
        ).to(x.dtype)


def _conv(cin: int, cout: int, kernel: int, dtype: torch.dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, config: VAEConfig) -> None:
        super().__init__()
        g, dt = config.norm_num_groups, config.dtype
        self.norm1 = GroupNorm(g, cin, dt)
        self.conv1 = _conv(cin, cout, 3, dt)
        self.norm2 = GroupNorm(g, cout, dt)
        self.conv2 = _conv(cout, cout, 3, dt)
        self.conv_shortcut = _conv(cin, cout, 1, dt) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    def __init__(self, ch: int, config: VAEConfig) -> None:
        super().__init__()
        dt = config.dtype
        self.group_norm = GroupNorm(config.norm_num_groups, ch, dt)
        self.to_q = nn.Linear(ch, ch, dtype=dt)
        self.to_k = nn.Linear(ch, ch, dtype=dt)
        self.to_v = nn.Linear(ch, ch, dtype=dt)
        self.to_out = nn.Linear(ch, ch, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        b, ch, hh, ww = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        kt = k.float().transpose(1, 2)
        t = hh * ww
        rows = max(1, _MID_ATTENTION_LOGITS // (b * t))
        attn = torch.empty_like(q)
        for r0 in range(0, t, rows):
            logits = (q[:, r0 : r0 + rows].float() @ kt) * (1.0 / math.sqrt(ch))
            attn[:, r0 : r0 + rows] = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        out = self.to_out(attn)
        return x + out.transpose(1, 2).reshape(b, ch, hh, ww)


class VAEDecoder(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        c = config
        self.config = c
        dt = c.dtype
        ch = c.block_out_channels[-1]
        self.post_quant_conv = _conv(c.latent_channels, c.latent_channels, 1, dt)
        self.conv_in = _conv(c.latent_channels, ch, 3, dt)
        self.mid_resnet_1 = ResnetBlock(ch, ch, c)
        self.mid_attn = MidAttention(ch, c)
        self.mid_resnet_2 = ResnetBlock(ch, ch, c)
        rev = tuple(reversed(c.block_out_channels))
        self._up: list[str] = []
        cin = ch
        for bi, out_ch in enumerate(rev):
            for ri in range(c.layers_per_block + 1):
                name = f"up_{bi}_resnet_{ri}"
                self.add_module(name, ResnetBlock(cin, out_ch, c))
                self._up.append(name)
                cin = out_ch
            if bi < len(rev) - 1:
                name = f"up_{bi}_upsample"
                self.add_module(name, _conv(out_ch, out_ch, 3, dt))
                self._up.append(name)
        self.conv_norm_out = GroupNorm(c.norm_num_groups, cin, dt)
        self.conv_out = _conv(cin, c.out_channels, 3, dt)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, latent_channels) NHWC → (B, 8h, 8w, 3) NHWC in [-1, 1]."""
        c = self.config
        z = (z / c.scaling_factor + c.shift_factor).to(c.dtype)
        h = self.post_quant_conv(z.permute(0, 3, 1, 2))
        h = self.conv_in(h)
        h = self.mid_resnet_2(self.mid_attn(self.mid_resnet_1(h)))
        for name in self._up:
            if name.endswith("_upsample"):
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, name)(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# weights (ecad_tpu/models/vae.py:148-212): diffusers AutoencoderKL keys →
# the reference's param tree, which `bridge.vae_state_dict` maps onto the
# port's module; tensors stay in the checkpoint's dtype (the reference
# widens to fp32, the module's load casts)
# ---------------------------------------------------------------------------


def _cv(state, key):
    out = {"kernel": state[f"{key}.weight"].permute(2, 3, 1, 0)}
    if f"{key}.bias" in state:
        out["bias"] = state[f"{key}.bias"]
    return out


def _gn(state, key):
    return {"scale": state[f"{key}.weight"], "bias": state[f"{key}.bias"]}


def _attn_lin(state, key):
    w = state[f"{key}.weight"]
    if w.ndim == 4:  # old checkpoints use 1×1 convs for attention projections
        w = w[:, :, 0, 0]
    out = {"kernel": w.T}
    if f"{key}.bias" in state:
        out["bias"] = state[f"{key}.bias"]
    return out


def _resnet(state, key):
    p = {
        "norm1": _gn(state, f"{key}.norm1"),
        "conv1": _cv(state, f"{key}.conv1"),
        "norm2": _gn(state, f"{key}.norm2"),
        "conv2": _cv(state, f"{key}.conv2"),
    }
    if f"{key}.conv_shortcut.weight" in state:
        p["conv_shortcut"] = _cv(state, f"{key}.conv_shortcut")
    return p


def convert_vae_decoder_state_dict(state: dict, config: VAEConfig) -> dict:
    """The decoder half of a diffusers AutoencoderKL state dict (its
    ``post_quant_conv`` and ``decoder.*``; the encoder's keys are not
    read) → the reference's VAEDecoder param tree."""
    d = "decoder"
    attn = f"{d}.mid_block.attentions.0"
    params = {
        "post_quant_conv": _cv(state, "post_quant_conv"),
        "conv_in": _cv(state, f"{d}.conv_in"),
        "mid_resnet_1": _resnet(state, f"{d}.mid_block.resnets.0"),
        "mid_resnet_2": _resnet(state, f"{d}.mid_block.resnets.1"),
        "mid_attn": {
            "group_norm": _gn(state, f"{attn}.group_norm"),
            "to_q": _attn_lin(state, f"{attn}.to_q"),
            "to_k": _attn_lin(state, f"{attn}.to_k"),
            "to_v": _attn_lin(state, f"{attn}.to_v"),
            "to_out": _attn_lin(state, f"{attn}.to_out.0"),
        },
        "conv_norm_out": _gn(state, f"{d}.conv_norm_out"),
        "conv_out": _cv(state, f"{d}.conv_out"),
    }
    n_up = len(config.block_out_channels)
    for bi in range(n_up):
        for ri in range(config.layers_per_block + 1):
            params[f"up_{bi}_resnet_{ri}"] = _resnet(
                state, f"{d}.up_blocks.{bi}.resnets.{ri}"
            )
        if bi < n_up - 1:
            params[f"up_{bi}_upsample"] = _cv(
                state, f"{d}.up_blocks.{bi}.upsamplers.0.conv"
            )
    return params


class VAEDecoderPipeline:
    def __init__(self, model: VAEDecoder) -> None:
        self.model = model
        self.config = model.config

    @classmethod
    def from_weights(
        cls, weights_root: Path | str, repo: str, latent_channels: int = 4,
        device: str | torch.device = "cuda",
    ) -> "VAEDecoderPipeline":
        """The checkpoint's decoder from ``weights_root/repo/vae``, in fp32 on
        `device`, as the reference serves it (``VAEConfig.sd()``, or
        ``.flux()`` for 16 latent channels; ref :224-232)."""
        from .bridge import vae_state_dict
        from .common import load_module
        from .weights import load_state_dict

        config = VAEConfig.flux() if latent_channels == 16 else VAEConfig.sd()
        state = load_state_dict(Path(weights_root) / repo / "vae")
        with torch.device("meta"):
            model = VAEDecoder(config)
        params = convert_vae_decoder_state_dict(state, config)
        return cls(load_module(model, vae_state_dict(params), resolve_device(device)))

    @torch.inference_mode()
    def decode_device(self, latents: torch.Tensor) -> torch.Tensor:
        """NHWC latents → (B, H, W, 3) uint8 images, left on the device."""
        img = self.model(latents.float())
        img = torch.clamp(img.float() / 2 + 0.5, 0, 1)
        return torch.round(img * 255).to(torch.uint8)

    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """NHWC latents → (B, H, W, 3) uint8 images on the host."""
        return self.decode_device(latents).cpu().numpy()


@torch.no_grad()
def _randomize_vae_(model: VAEDecoder, seed: int) -> VAEDecoder:
    """Seeded random weights in place: conv/linear weights N(0, 1/fan_in)
    (LeCun normal, Flax's default), biases 0, norm weights 1."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            module.bias.zero_()
    return model


def random_decoder_pipeline(
    latent_channels: int = 4, device: str | torch.device = "cuda", seed: int = 7
) -> VAEDecoderPipeline:
    """Architecture-faithful decoder with random bf16 weights, built on the
    device: the compute cost of the real VAE without a checkpoint. 4 latent
    channels give PixArt's (SD) autoencoder, 16 FLUX's."""
    if latent_channels not in (4, 16):
        raise ValueError(f"no autoencoder with {latent_channels} latent channels")
    dev = resolve_device(device)
    config = (VAEConfig.flux if latent_channels == 16 else VAEConfig)(
        dtype=torch.bfloat16
    )
    with torch.device("meta"):
        model = VAEDecoder(config)
    model = model.to_empty(device=dev)
    return VAEDecoderPipeline(
        _randomize_vae_(model, seed).eval().requires_grad_(False)
    )
