"""Frozen VisMVSNet feature-extractor CNN (2-enc/1-dec residual U-Net) as a
PyTorch module in eval mode (port of ``mvsdf_tpu/data/featext.py``).

Architecture parity target: ``code/utils/my_utils.py:530-708`` (BasicBlock /
UNet / FeatExt): 5x5 stride-2 stem -> encoder [32, 64, 128] (stride 1/2/2,
2 residual blocks each) -> 2 decoder stages (deconv + concat-skip + conv +
1 residual block) -> three 32-channel heads at 1/8, 1/4, 1/2 of the input
resolution. Only head [2] (half-res) is consumed by the dataset.

The submodules carry the reference's names (``init_conv.0``,
``unet.enc_blocks.2d2_0.0.conv1``, ``unet.dec_blocks.2d16_3.2.0``,
``final_conv_3``), so the ``module.feat_ext.*`` part of the released
``vismvsnet.pt`` loads with ``load_state_dict``. BatchNorm uses its running
statistics. The convolutions are cuDNN's on the card: the JAX package runs
them through XLA's convolution too, no hand-written kernel.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FILTERS = (32, 64, 128)
ENC_NAMES = ("2d2_0", "2d4_1", "2d8_2")
DEC_NAMES = ("2d16_3", "2d8_4")


class BasicBlock(nn.Module):
    """Residual block (ref my_utils.py:530-578)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, 0, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class UNet(nn.Module):
    """Encoder blocks '2d{scale}_{idx}' and decoder blocks [deconv, conv,
    [residual block]] (ref my_utils.py:600-686)."""

    def __init__(self):
        super().__init__()
        enc, prev = {}, 16
        for i, (name, f) in enumerate(zip(ENC_NAMES, FILTERS)):
            enc[name] = nn.Sequential(BasicBlock(prev, f, 1 if i == 0 else 2),
                                      BasicBlock(f, f, 1))
            prev = f
        self.enc_blocks = nn.ModuleDict(enc)
        dec = {}
        for name, f in zip(DEC_NAMES, FILTERS[-2::-1]):
            dec[name] = nn.Sequential(
                nn.ConvTranspose2d(prev, f, 3, 2, 1, output_padding=1,
                                   bias=False),
                nn.Conv2d(2 * f, f, 3, 1, 1, bias=False),
                nn.Sequential(BasicBlock(f, f, 1)))
            prev = f
        self.dec_blocks = nn.ModuleDict(dec)

    def forward(self, x):
        enc_out = []
        for block in self.enc_blocks.values():
            x = block(x)
            enc_out.append(x)
        outs = [x]
        for i, (deconv, post, res) in enumerate(self.dec_blocks.values()):
            x = torch.cat([deconv(x), enc_out[-2 - i]], dim=1)
            x = res(post(x))
            outs.append(x)
        return outs


class FeatExt(nn.Module):
    """x (N, 3, H, W) ImageNet-normalized -> (f8, f4, f2), 32 channels each
    at 1/8, 1/4, 1/2 resolution (ref my_utils.py:688-708)."""

    def __init__(self):
        super().__init__()
        self.init_conv = nn.Sequential(
            nn.Conv2d(3, 16, 5, 2, 2, bias=False), nn.BatchNorm2d(16),
            nn.ReLU())
        self.unet = UNet()
        self.final_conv_1 = nn.Conv2d(128, 32, 3, 1, 1, bias=False)
        self.final_conv_2 = nn.Conv2d(64, 32, 3, 1, 1, bias=False)
        self.final_conv_3 = nn.Conv2d(32, 32, 3, 1, 1, bias=False)
        self.eval()

    def forward(self, x):
        o8, o4, o2 = self.unet(self.init_conv(x))
        return (self.final_conv_1(o8), self.final_conv_2(o4),
                self.final_conv_3(o2))


@contextlib.contextmanager
def tf32_off():
    """f32 convolutions and matmuls on the card inside the block (TF32 would
    widen the features' distance from the JAX package's f32 ones)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no autotuning, inside the block;
    the caller's settings after it. Left to itself cuDNN may pick a
    nondeterministic algorithm for the FeatExt's convolutions (the
    decoder's transposed ones among them), and then every process computes
    slightly other frozen features and two training runs of the same seed
    part at their first feature-consistency step. The features are
    computed once a scene load, so this costs nothing a step."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = saved


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _bn_init(c, rng, prefix):
    return {prefix + ".weight": np.ones((c,)),
            prefix + ".bias": np.zeros((c,)),
            prefix + ".running_mean": rng.normal(0, 0.1, (c,)),
            prefix + ".running_var": np.ones((c,)),
            prefix + ".num_batches_tracked": np.zeros((), np.int64)}


def _conv_init(rng, cout, cin, k):
    bound = np.sqrt(1.0 / (cin * k * k))
    return rng.uniform(-bound, bound, (cout, cin, k, k))


def _block_init(rng, cin, cout, stride, prefix):
    sd = {prefix + ".conv1.weight": _conv_init(rng, cout, cin, 3)}
    sd.update(_bn_init(cout, rng, prefix + ".bn1"))
    sd[prefix + ".conv2.weight"] = _conv_init(rng, cout, cout, 3)
    sd.update(_bn_init(cout, rng, prefix + ".bn2"))
    if stride != 1 or cin != cout:
        sd[prefix + ".downsample.0.weight"] = _conv_init(rng, cout, cin, 1)
        sd.update(_bn_init(cout, rng, prefix + ".downsample.1"))
    return sd


def init_feat_ext(rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """Random weights with the pretrained topology, as a ``FeatExt`` state
    dict, drawn from ``rng`` in the JAX package's ``init_feat_ext`` order:
    the same seed gives the same weights (bring-up and tests; real use
    loads vismvsnet.pt)."""
    sd = {"init_conv.0.weight": _conv_init(rng, 16, 3, 5)}
    sd.update(_bn_init(16, rng, "init_conv.1"))
    prev = 16
    for i, (name, f) in enumerate(zip(ENC_NAMES, FILTERS)):
        p = f"unet.enc_blocks.{name}"
        sd.update(_block_init(rng, prev, f, 1 if i == 0 else 2, p + ".0"))
        sd.update(_block_init(rng, f, f, 1, p + ".1"))
        prev = f
    for name, f in zip(DEC_NAMES, FILTERS[-2::-1]):
        p = f"unet.dec_blocks.{name}"
        sd[p + ".0.weight"] = rng.uniform(-0.05, 0.05, (prev, f, 3, 3))
        sd[p + ".1.weight"] = _conv_init(rng, f, 2 * f, 3)
        sd.update(_block_init(rng, f, f, 1, p + ".2.0"))
        prev = f
    sd["final_conv_1.weight"] = _conv_init(rng, 32, 128, 3)
    sd["final_conv_2.weight"] = _conv_init(rng, 32, 64, 3)
    sd["final_conv_3.weight"] = _conv_init(rng, 32, 32, 3)
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The FeatExt state dict of vismvsnet.pt (the full VisMVSNet
    checkpoint; ref my_utils.py:702): its ``module.feat_ext.*`` entries
    with the prefix taken off, or the whole dict if it has none."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    prefix = "module.feat_ext."
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sub or dict(sd)


def make_feat_ext(state: Dict[str, torch.Tensor], device) -> FeatExt:
    """A FeatExt in eval mode on ``device`` holding ``state`` (strict)."""
    net = FeatExt()
    net.load_state_dict(state)
    return net.to(device).eval()
