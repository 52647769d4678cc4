"""The trunk's BN-act epilogue (dana_tpu_torch/ops/bn_act.py) on the CPU:
the epilogue and its gradient, and the op `dana_torch::bn_act`, against
the chain they replace (the frozen BN, the residual's BN, the sum and the
ReLU as separate ops, with autograd's gradients), bit for bit, in float32
and bf16, in both layouts; the ResNet blocks against a copy of their forward
before the epilogue; and a block exported through the op's fake
implementation.  The kernel's side is in tests/test_torch_port_cuda.py."""

import pytest
import torch
import torch.nn.functional as F

from dana_tpu_torch.models import layers as L
from dana_tpu_torch.models import resnet
from dana_tpu_torch.ops import bn_act as ba

DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def _bn(c, gen):
    """A frozen BN with statistics that are not trivial."""
    bn = L.FrozenBatchNorm2d(c)
    bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
    bn.bias.copy_(torch.randn(c, generator=gen))
    bn.running_mean.copy_(torch.randn(c, generator=gen))
    bn.running_var.copy_(torch.rand(c, generator=gen) + 0.1)
    return bn


def _chain(x, bn, residual=None, residual_bn=None):
    """The chain as the trunk ran it before the epilogue."""
    y = bn(x)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual))
    return F.relu(y)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('residual', ['none', 'identity', 'bn'])
@pytest.mark.parametrize('layout', ['nchw', 'nhwc'])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_bn_act_matches_chain(dtype, layout, residual):
    """Forward and the gradients of x and the residual, bit for bit, and
    the op `dana_torch::bn_act` (the call an exported program holds) equal
    to the chain's forward."""
    gen = torch.Generator().manual_seed(7)
    dt = DTYPES[dtype]
    fmt = torch.channels_last if layout == 'nhwc' else torch.contiguous_format
    x0, r0 = (torch.randn(2, 8, 5, 6, generator=gen).to(dt)
              .contiguous(memory_format=fmt) for _ in range(2))
    g = torch.randn(2, 8, 5, 6, generator=gen).to(dt)
    bn, rbn = _bn(8, gen), _bn(8, gen)
    res_bn = rbn if residual == 'bn' else None
    outs = []
    for fn in (_chain, L.bn_act):
        x = x0.clone().requires_grad_()
        r = r0.clone().requires_grad_() if residual != 'none' else None
        y = fn(x, bn, r, res_bn)
        y.backward(g)
        outs.append((y, x.grad, None if r is None else r.grad))
    (y0, gx0, gr0), (y1, gx1, gr1) = outs
    _same(y1, y0)
    _same(gx1, gx0)
    if gr0 is not None:
        _same(gr1, gr0)
    rbn_args = res_bn.affine(dt) if res_bn else (None, None)
    _same(ba.bn_act_op(x0, *bn.affine(dt), None if residual == 'none'
                       else r0, *rbn_args), y0)


def _present_bottleneck(self, x):
    out = F.relu(self.bn1(self.conv1(x)))
    out = F.relu(self.bn2(self.conv2(out)))
    out = self.bn3(self.conv3(out))
    residual = x if self.downsample is None else self.downsample(x)
    return F.relu(out + residual)


def _present_basic(self, x):
    out = F.relu(self.bn1(self.conv1(x)))
    out = self.bn2(self.conv2(out))
    residual = x if self.downsample is None else self.downsample(x)
    return F.relu(out + residual)


def _block(kind, inplanes, planes, stride, gen):
    block = (resnet.Bottleneck if kind == 'bottleneck'
             else resnet.BasicBlock)(inplanes, planes, stride)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, L.FrozenBatchNorm2d):
                m.load_state_dict(_bn(m.weight.numel(), gen).state_dict())
            elif isinstance(m, L.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * 0.2)
    return block


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('kind, inplanes, planes, stride', [
    ('bottleneck', 16, 8, 2),      # a downsample with its BN
    ('bottleneck', 32, 8, 1),      # the identity residual
    ('basic', 8, 16, 2),
], ids=['bottleneck-down', 'bottleneck-identity', 'basic-down'])
def test_block_matches_present_forward(kind, inplanes, planes, stride,
                                       dtype):
    """A block's output and the gradients of its input and of every conv
    weight, bit for bit, against its forward before the epilogue."""
    gen = torch.Generator().manual_seed(11)
    dt = DTYPES[dtype]
    block = _block(kind, inplanes, planes, stride, gen)
    present = _present_bottleneck if kind == 'bottleneck' else _present_basic
    x0 = (torch.randn(2, inplanes, 9, 10, generator=gen).to(dt)
          .contiguous(memory_format=torch.channels_last))
    outs = []
    for fwd in (present, type(block).forward):
        block.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        y = fwd(block, x)
        y.backward(torch.ones_like(y))
        outs.append((y, x.grad, [p.grad for p in block.parameters()]))
    (y0, gx0, gw0), (y1, gx1, gw1) = outs
    _same(y1, y0)
    _same(gx1, gx0)
    assert len(gw0) == len(gw1) > 0
    for a, b in zip(gw1, gw0):
        _same(a, b)


def test_bn_act_export_holds_the_op():
    """A bottleneck with a downsample exported: its three epilogues are
    the op, traced through its fake implementation, and the program
    equals the module."""
    gen = torch.Generator().manual_seed(3)
    block = _block('bottleneck', 16, 8, 2, gen).eval()
    x = torch.randn(1, 16, 9, 10, generator=gen).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        ep = torch.export.export(block, (x,), strict=False)
        got = ep.module()(x)
        want = block(x)
    ops = [n.target for n in ep.graph.nodes if n.op == 'call_function']
    assert ops.count(torch.ops.dana_torch.bn_act.default) == 3
    _same(got, want)


def test_bn_act_refuses_other_devices():
    x = torch.zeros(1, 4, 2, 2, device='meta')
    s = torch.ones(4, device='meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        ba.bn_act(x, s, s)


def test_bn_act_refuses_a_gradient_of_the_bn():
    """A frozen BN's scale and offset are buffers: one that wants a
    gradient is refused, not silently given none."""
    x = torch.randn(1, 4, 2, 2, requires_grad=True)
    s = torch.ones(4, requires_grad=True)
    with pytest.raises(ValueError, match='no gradient'):
        ba.bn_act(x, s, torch.zeros(4))


@pytest.mark.parametrize('dtype', [torch.float16, torch.float64],
                         ids=['f16', 'f64'])
def test_bn_act_kernel_refuses_other_dtypes(dtype):
    """The CUDA wrappers refuse a dtype the kernel does not take before
    they reach the card (the CPU runs the chain in any dtype)."""
    x = torch.zeros(1, 8, 2, 2, dtype=dtype)
    s = torch.ones(8, dtype=dtype)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        ba._forward_cuda(x, s, s, None, None, None)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        ba._backward_cuda(x, x, s, None, False)
    _same(ba.bn_act(x, s, s), F.relu(x + 1))


def _nhwc(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize('case, vector', [
    ('nhwc', True),
    ('nhwc_bf16', True),
    ('c_off_the_vector', False),      # 6 float32 channels: not 16 bytes
    ('bf16_c_off_the_vector', False),  # 12 bf16 channels
    ('nchw', False),
    ('residual_nchw', False),
    ('unaligned', False),
])
def test_bn_act_layout_picks_the_path(case, vector):
    """The kernels' path from the strides: the vector path only where
    every operand is channels-last and dense, C fills 16-byte vectors and
    every pointer is 16-byte aligned; the strided path's shapes carry each
    operand's own strides."""
    x = {'nhwc_bf16': lambda: _nhwc(2, 16, 3, 5, dtype=torch.bfloat16),
         'c_off_the_vector': lambda: _nhwc(2, 6, 3, 5),
         'bf16_c_off_the_vector': lambda: _nhwc(2, 12, 3, 5,
                                                dtype=torch.bfloat16),
         'nchw': lambda: torch.zeros(2, 8, 3, 5),
         # channels-last, dense, 4 bytes past an aligned allocation
         'unaligned': lambda: torch.zeros(1 + 2 * 3 * 5 * 8)[1:]
         .view(2, 3, 5, 8).permute(0, 3, 1, 2)}.get(
             case, lambda: _nhwc(2, 8, 3, 5))()
    if case == 'unaligned':
        assert x.is_contiguous(memory_format=torch.channels_last)
    r = torch.zeros(x.shape, dtype=x.dtype) if case == 'residual_nchw' \
        else torch.empty_like(x)
    shapes = ba._layout([x, r, torch.empty_like(x)])
    assert (shapes is None) == vector
    if not vector:
        assert list(shapes.size) == list(x.shape)
        assert list(shapes.stride[0]) == list(x.stride())
        assert list(shapes.stride[1]) == list(r.stride())
