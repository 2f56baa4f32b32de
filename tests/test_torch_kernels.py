"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU: a CUDA
kernel has no CPU mode. This file imports torch only, so it also runs where
JAX is not installed (the repository's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerance: the kernel against the plain version computed in f32 from the same
inputs (TF32 off). f32 atol 1e-4: FMA order over up to 4096 keys. bf16 atol
2e-2: p is rounded to bf16 before p.v and the output to bf16, as in the TPU
kernel.
"""

import pytest
import torch

from sd_video_gen_tpu_torch.ops import _kernels
from sd_video_gen_tpu_torch.ops import attention as patt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 4096, 40), (8, 1024, 80),
                                   (8, 256, 160), (8, 64, 160),
                                   (1, 4096, 512), (5, 64, 512),
                                   (3, 77, 40), (2, 100, 72), (1, 33, 512),
                                   (2, 1, 8)])
def test_flash_attention_matches_plain(cuda, shape, dtype, atol):
    """Path shapes, plus ragged T and head dims between the kernel's buckets."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    scale = shape[-1] ** -0.5
    before = _kernels.LAUNCHES["flash_attention"]
    out = patt.attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = patt.reference_attention(q.float(), k.float(), v.float(), scale)
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        patt.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        patt.flash_attention(x, x, x)
    x = torch.zeros(1, 4, 520, device=cuda)
    with pytest.raises(ValueError, match="d <= 512"):
        patt.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="equal"):
        patt.flash_attention(q, q[:, :4], q[:, :4])
