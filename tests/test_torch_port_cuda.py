"""The port's CUDA kernels against their plain PyTorch versions on the card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
On a machine with one (and no JAX), run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import pytest
import torch

from dana_tpu_torch.ops import cisa_attention as ca
from dana_tpu_torch.ops import roi_align as ra

pytestmark = pytest.mark.cuda

TOL = 1e-4      # float32 sums in another order than the plain version


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('shape', [
    (2, 3, 100, 400, 256, 1024),
    (2, 3, 77, 1, 256, 1024),        # Ns = 1
    (3, 2, 33, 57, 64, 1100),        # ragged Nq, C past one channel chunk
    (1, 1, 16, 2000, 32, 8),         # a large support set
])
def test_cisa_kernel_matches_plain(dev, shape):
    g, s, nq, ns, d, c = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(g, nq, d, device=dev, generator=gen)
    k = torch.randn(g, s, ns, d, device=dev, generator=gen)
    v = torch.randn(g, s, ns, c, device=dev, generator=gen)
    u = torch.softmax(torch.randn(g, s, ns, device=dev, generator=gen), -1)
    before = ca.cisa_attention_shots.launches
    got = ca.cisa_attention_shots(q, k, v, u, d ** -0.5, 0.1)
    want = ca.cisa_attention_shots_plain(q, k, v, u, d ** -0.5, 0.1)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert ca.cisa_attention_shots.launches == before + 1


def test_cisa_kernel_refuses_too_many_keys(dev):
    q = torch.zeros(1, 4, 256, device=dev)
    k = torch.zeros(1, 1, 20000, 256, device=dev)
    v = torch.zeros(1, 1, 20000, 8, device=dev)
    u = torch.zeros(1, 1, 20000, device=dev)
    with pytest.raises(ValueError, match='shared memory'):
        ca.cisa_attention_shots(q, k, v, u, 1.0, 0.1)


def test_roi_align_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = torch.randn(2, 10, 12, 40, device=dev, generator=gen)
    edge = torch.tensor([
        [-40, -30, 60, 50], [150, 140, 260, 230], [-100, 20, -20, 60],
        [30, 30, 30.4, 30.2], [80, 80, 60, 50], [0, 0, 2000, 1900],
        [5.5, 7.25, 159.0, 191.0], [16, 16, 16 + 21 * 16, 48]],
        device=dev)
    xy = torch.rand(2, 24, 2, device=dev, generator=gen) * 150
    wh = torch.rand(2, 24, 2, device=dev, generator=gen) * 90 + 1
    rois = torch.cat([edge.expand(2, -1, -1),
                      torch.cat([xy, xy + wh], -1)], 1).contiguous()
    for p in (7, 5):
        before = ra.roi_align.launches
        got = ra.roi_align(feat, rois, p)
        torch.testing.assert_close(got, ra.roi_align_plain(feat, rois, p),
                                   rtol=TOL, atol=TOL)
        assert ra.roi_align.launches == before + 1
    with pytest.raises(TypeError):
        ra.roi_align(feat.double(), rois)
    with pytest.raises(ValueError):
        ra.roi_align(feat[:, :, ::2], rois)
