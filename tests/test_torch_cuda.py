"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip without a GPU. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mvsdf_tpu_torch.fields import sdf as t_sdf
from mvsdf_tpu_torch.fields.embedder import positional_encoding
from mvsdf_tpu_torch.tracing.kernels import sdf_mlp as K

SMALL = dict(feature_vector_size=16, dims=(64,) * 4, skip_in=(2,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small_padded", "full"])
def test_sdf_mlp_kernel_matches_plain_version(cuda, kw):
    """Max |kernel - plain| <= 1e-4 on SDF values of order 1 (f32 sums in
    another order), ragged row counts, one launch counted per call."""
    net = t_sdf.init_implicit(t_sdf.ImplicitConfig(**kw),
                              np.random.default_rng(0)).to(cuda)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
        packed = K.pack_sdf_weights(net)
        for n in (1, 31, 4097):
            x = torch.rand((n, 3), device=cuda) * 2 - 1
            pe = positional_encoding(x, 6)
            before = K.sdf_mlp.launches
            got = K.sdf_mlp(packed, pe)
            torch.cuda.synchronize()
            assert K.sdf_mlp.launches == before + 1
            ref = K.sdf_mlp_reference(packed, pe)
            assert got.shape == (n,)
            assert (got - ref).abs().max().item() <= 1e-4
