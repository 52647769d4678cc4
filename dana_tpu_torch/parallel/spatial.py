"""Spatial partitioning of the trunk (`--sp N`), written out: the JAX
package places the query's H over a mesh axis and lets GSPMD partition
every convolution; here each of N devices holds a block of rows of every
activation, and before each convolution and pool it takes the halo rows
its window needs from its neighbours' blocks.

Output rows [o0, o1) of a window k, stride s, pad p read input rows
[o0 s - p, (o1 - 1) s - p + k).  Rows outside the map are the layer's
padding (zeros before a convolution, -inf before a max pool) and are
added only at the map's global top and bottom, never at a block boundary.
The blocks of every activation are the rows [floor(i h / N), floor((i+1)
h / N)) of its height h, so a residual's two branches line up.  Only
copies cross the devices: each device computes its rows with the same
arithmetic as the unsharded layer.  An int8 conv (`layers.QuantConv2d`)
quantizes every block at the scale of the whole map (`halo_int8_conv`):
one max reduced on the first block's device, so the blocks' int8 sums are
the whole conv's.

`spatial_base` runs a trunk's `base` this way (the bottleneck ResNets,
with the stride on conv1, and VGG16) and gathers the rows on the first
block's device; the rest of the forward runs there unsharded.
`shard_trunk_spatial` makes a detector's trunk compute its base features
so, as `shard_params_tp` splits its wide layers.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from dana_tpu_torch.models import layers as L
from dana_tpu_torch.models import resnet, vgg


def out_rows(h: int, k: int, s: int, p: int, ceil_mode=False) -> int:
    """The output height of a window k / stride s / pad p over h rows
    (PyTorch's rule: in ceil mode a last window must start inside the map
    or its top padding)."""
    span = h + 2 * p - k
    o = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (o - 1) * s >= h + p:
        o -= 1
    return o


def bounds(h: int, n: int) -> list:
    """The n + 1 block boundaries of h rows."""
    return [i * h // n for i in range(n + 1)]


def halo_windows(xs, k, s, p, ceil_mode=False, fill=0.0):
    """xs: NCHW row blocks (block i on its device).  -> for each block of
    the output rows, the input rows its windows read, gathered on that
    block's device and padded with `fill` where they leave the map."""
    n = len(xs)
    starts = [0]
    for x in xs:
        starts.append(starts[-1] + x.shape[2])
    h = starts[-1]
    ob = bounds(out_rows(h, k, s, p, ceil_mode), n)
    wins = []
    for i, x in enumerate(xs):
        o0, o1 = ob[i], ob[i + 1]
        if o1 <= o0:
            raise ValueError(f'spatial sharding: {ob[-1]} output rows do not '
                             f'give each of {n} devices a row')
        r0, r1 = o0 * s - p, (o1 - 1) * s - p + k
        parts = []
        for j, xj in enumerate(xs):
            a, b = max(r0, starts[j]), min(r1, starts[j + 1])
            if a < b:
                parts.append(xj[:, :, a - starts[j]:b - starts[j]]
                             .to(x.device))
        t = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
        top, bottom = max(0, -r0), max(0, r1 - h)
        if top or bottom:
            t = F.pad(t, (0, 0, top, bottom), value=fill)
        wins.append(t)
    return wins


def halo_conv(xs, convs):
    """A Conv2d over row blocks: convs[i] (the layer's replica on block
    i's device, a `layers.Conv2d`: its weight cast to the input's dtype,
    or a `layers.QuantConv2d`: `halo_int8_conv`) runs on block i's halo
    window; the H padding is the window's."""
    c = convs[0]
    if isinstance(c, L.QuantConv2d):
        return halo_int8_conv(xs, convs)
    (k, _), (s, sw), (p, pw) = c.kernel_size, c.stride, c.padding
    outs = []
    for t, conv in zip(halo_windows(xs, k, s, p), convs):
        bias = None if conv.bias is None else conv.bias.to(t.dtype)
        outs.append(F.conv2d(t, conv.weight.to(t.dtype), bias, (s, sw),
                             (0, pw), conv.dilation, conv.groups))
    return outs


def halo_int8_conv(xs, convs):
    """A `layers.QuantConv2d` over row blocks, at the scale of the whole
    tensor the JAX package's conv sees: each block's max |x| over its own
    rows (the halo copies repeat rows of other blocks and the zero padding
    cannot raise it), reduced on the first block's device (then over the
    data rows of a `layers.ScaleGroup`), and every halo window quantized at
    that one scale on its own device."""
    c = convs[0]
    k, s, p = c.w_int8.shape[2], c.stride, c.padding
    lead = xs[0].device
    amax = torch.stack([L.activation_amax(x).to(lead) for x in xs]).amax()
    amax = L.group_amax(amax)
    return [L.dynamic_int8_conv(t, conv.w_int8, conv.w_scale, conv.bias, s,
                                (0, p), amax.to(t.device))
            for t, conv in zip(halo_windows(xs, k, s, p), convs)]


def halo_max_pool(xs, k, s, ceil_mode):
    """`layers.max_pool` (no padding) over row blocks."""
    return [F.max_pool2d(t, k, s, 0, ceil_mode=ceil_mode)
            for t in halo_windows(xs, k, s, 0, ceil_mode, -torch.inf)]


def _each(fn, *lists):
    return [fn(*a) for a in zip(*lists)]


def _bottleneck(blocks, xs):
    out = halo_conv(xs, [b.conv1 for b in blocks])
    out = _each(lambda b, o: L.bn_act(o, b.bn1), blocks, out)
    out = halo_conv(out, [b.conv2 for b in blocks])
    out = _each(lambda b, o: L.bn_act(o, b.bn2), blocks, out)
    out = halo_conv(out, [b.conv3 for b in blocks])
    if blocks[0].downsample is None:
        return _each(lambda b, o, x: L.bn_act(o, b.bn3, x), blocks, out, xs)
    res = halo_conv(xs, [b.downsample[0] for b in blocks])
    return _each(lambda b, o, r: L.bn_act(o, b.bn3, r, b.downsample[1]),
                 blocks, out, res)


def _resnet(trunks, xs):
    ys = halo_conv(xs, [t.conv1 for t in trunks])
    ys = _each(lambda t, y: L.bn_act(y, t.bn1), trunks, ys)
    ys = halo_max_pool(ys, 3, 2, ceil_mode=True)
    for name in ('layer1', 'layer2', 'layer3'):
        for i in range(len(getattr(trunks[0], name))):
            blocks = [getattr(t, name)[i] for t in trunks]
            if not isinstance(blocks[0], resnet.Bottleneck):
                raise NotImplementedError('spatial sharding covers the '
                                          'bottleneck ResNets')
            ys = _bottleneck(blocks, ys)
    return ys


def _vgg(trunks, xs):
    convs = iter(vgg.CONV_IDX)
    for v in vgg._CFG:
        if v == 'M':
            xs = halo_max_pool(xs, 2, 2, ceil_mode=False)
        else:
            key = str(next(convs))
            xs = [F.relu(y) for y in
                  halo_conv(xs, [t.features[key] for t in trunks])]
    return xs


def spatial_base(trunks, blocks):
    """The trunk's base features of a query split into row blocks
    (`shard_query_spatial`): trunks[i] is the trunk module on blocks[i]'s
    device, blocks [B, h_i, W, 3] NHWC.  -> [B, H/16, W/16, C] on
    blocks[0]'s device, equal to `trunks[0].base` of the whole query."""
    xs = [L.nhwc_to_nchw(b) for b in blocks]
    run = _vgg if isinstance(trunks[0], vgg.VGG16) else _resnet
    ys = run(trunks, xs)
    lead = blocks[0].device
    return L.nchw_to_nhwc(torch.cat([y.to(lead) for y in ys], dim=2))


def _sharded_base(trunks, devices, x):
    from dana_tpu_torch.parallel import shard_query_spatial
    return spatial_base(trunks, shard_query_spatial(x, devices))


def shard_trunk_spatial(model, devices, trunks):
    """Spatial parallelism over `devices` (one 'model' row of a grid):
    the detector's trunk computes the base features of every image it is
    given (the queries, and the supports it encodes) with the image's rows
    split over the devices (`shard_query_spatial`, `spatial_base`).
    trunks[i] is the trunk on devices[i]; the model's own trunk stands in
    for trunks[0].  In place -> the model."""
    own = model.backbone
    own.base = functools.partial(_sharded_base, [own, *trunks[1:]],
                                 [torch.device(d) for d in devices])
    return model


__all__ = ['out_rows', 'bounds', 'halo_windows', 'halo_conv',
           'halo_int8_conv', 'halo_max_pool', 'spatial_base',
           'shard_trunk_spatial']
