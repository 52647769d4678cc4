"""The plain reference of the Faster R-CNN skeleton that DAnA and FSOD
share: a Caffe-style ResNet-50 C4 trunk, the RPN, anchors, the proposal
layer with greedy NMS, RoIAlign, the RoI tail (layer4), the detection
postprocess, the training target layers, the losses and SGD.

Plain PyTorch in float32 over NCHW maps, and NumPy for the greedy NMS
walk; no kernel, cache or batching trick of the measured program, and no
import of it.  Weights are a dict of tensors under the reference
checkpoint's names (`backbone.layer1.0.conv1.weight`, `RCNN_rpn.RPN_Conv.
weight`, ...), made by the benchmark from the seed.

Semantics follow the published detector as the JAX package and its port
define it (py-faster-rcnn's +1 box convention, a stable descending score
sort, IoU strictly above the threshold suppresses, RoIAlign with an
adaptive sample count capped at 16, uniform draws ranked for the target
layers' sampling).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

RESNET50_BLOCKS = (3, 4, 6, 3)
FEAT_STRIDE = 16
# the reference's frozen stages: conv1 (and its BN) and layer1
FROZEN_PREFIXES = ('backbone.conv1.', 'backbone.bn1.', 'backbone.layer1.')


# ----------------------------------------------------------------- weights

def resnet50_spec():
    """[(name, shape, mean, std)] of the ResNet-50 trunk: He-normal convs
    (the stem's scaled to the pixels' range of about +-128), frozen BNs
    (identity statistics; each bottleneck's last BN scale 0.25, so the
    residual branches contribute without blowing up the map)."""
    spec = [('backbone.conv1.weight', (64, 3, 7, 7), 0.0,
             math.sqrt(2.0 / 147) / 64)]
    spec += _bn('backbone.bn1', 64)
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                              RESNET50_BLOCKS)):
        for b in range(blocks):
            p = f'backbone.layer{li + 1}.{b}'
            out = planes * 4
            spec += [_conv(f'{p}.conv1', planes, inplanes, 1)]
            spec += _bn(f'{p}.bn1', planes)
            spec += [_conv(f'{p}.conv2', planes, planes, 3)]
            spec += _bn(f'{p}.bn2', planes)
            spec += [_conv(f'{p}.conv3', out, planes, 1)]
            spec += _bn(f'{p}.bn3', out, scale=0.25)
            if b == 0:
                spec += [_conv(f'{p}.downsample.0', out, inplanes, 1)]
                spec += _bn(f'{p}.downsample.1', out)
            inplanes = out
    return spec


def _conv(name, cout, cin, k, gain=2.0):
    return (f'{name}.weight', (cout, cin, k, k), 0.0,
            math.sqrt(gain / (cin * k * k)))


def _bn(name, c, scale=1.0):
    return [(f'{name}.weight', (c,), scale, 0.0),
            (f'{name}.bias', (c,), 0.0, 0.0),
            (f'{name}.running_mean', (c,), 0.0, 0.0),
            (f'{name}.running_var', (c,), 1.0, 0.0)]


def linear_spec(name, cout, cin, gain=1.0, bias=True):
    """A linear layer [cout, cin] with unit-gain normal weights (scaled by
    `gain`) and a small normal bias."""
    out = [(f'{name}.weight', (cout, cin), 0.0, gain / math.sqrt(cin))]
    if bias:
        out.append((f'{name}.bias', (cout,), 0.0, 0.01))
    return out


def conv_spec(name, cout, cin, k, gain=1.0, bias=True):
    out = [(f'{name}.weight', (cout, cin, k, k), 0.0,
            gain / math.sqrt(cin * k * k))]
    if bias:
        out.append((f'{name}.bias', (cout,), 0.0, 0.01))
    return out


def rpn_spec(din, num_anchors, gain=1.0):
    return (conv_spec('RCNN_rpn.RPN_Conv', 512, din, 3, gain=gain)
            + conv_spec('RCNN_rpn.RPN_cls_score', 2 * num_anchors, 512, 1,
                        gain=0.15)
            + conv_spec('RCNN_rpn.RPN_bbox_pred', 4 * num_anchors, 512, 1,
                        gain=0.05))


def make_weights(spec, seed, device):
    """The weights of `spec` from `seed`: one normal draw of every leaf's
    entries at once from a torch.Generator on `device`, split and scaled
    leaf by leaf.  The same seed gives the same weights on the same
    device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(shape) for _, shape, _, std in spec if std)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, mean, std in spec:
        n = math.prod(shape)
        if std:
            out[name] = draw[at:at + n].view(shape) * std + mean
            at += n
        else:
            out[name] = torch.full(shape, float(mean), device=device)
    return out


def trainable(name):
    """True for a leaf the training step updates: a conv or linear weight or
    bias outside the frozen stages (the trunk's BNs are frozen buffers)."""
    parts = name.split('.')
    bn = parts[-2].startswith('bn') or 'downsample.1.' in name
    return not name.startswith(FROZEN_PREFIXES) and not bn


# ------------------------------------------------------------------- trunk

def conv(x, w, name, stride=1, padding=0, groups=1):
    return F.conv2d(x, w[f'{name}.weight'], w.get(f'{name}.bias'), stride,
                    padding, groups=groups)


def frozen_bn(x, w, name, eps=1e-5):
    scale = w[f'{name}.weight'] * torch.rsqrt(w[f'{name}.running_var'] + eps)
    offset = w[f'{name}.bias'] - w[f'{name}.running_mean'] * scale
    return x * scale[:, None, None] + offset[:, None, None]


def bottleneck(x, w, p, stride):
    out = F.relu(frozen_bn(conv(x, w, f'{p}.conv1', stride), w, f'{p}.bn1'))
    out = F.relu(frozen_bn(conv(out, w, f'{p}.conv2', 1, 1), w, f'{p}.bn2'))
    out = frozen_bn(conv(out, w, f'{p}.conv3'), w, f'{p}.bn3')
    if f'{p}.downsample.0.weight' in w:
        x = frozen_bn(conv(x, w, f'{p}.downsample.0', stride), w,
                      f'{p}.downsample.1')
    return F.relu(out + x)


def layer(x, w, li):
    for b in range(RESNET50_BLOCKS[li - 1]):
        stride = 2 if (b == 0 and li > 1) else 1
        x = bottleneck(x, w, f'backbone.layer{li}.{b}', stride)
    return x


def resnet_base(x, w):
    """Mean-subtracted images NCHW [N, 3, H, W] -> layer3's map [N, 1024,
    H/16, W/16]: conv1 7x7/2 pad 3, BN, ReLU, max pool 3/2 ceil mode,
    layer1-3 (the stride on each stage's first 1x1 conv, Caffe style)."""
    x = F.relu(frozen_bn(conv(x, w, 'backbone.conv1', 2, 3), w,
                         'backbone.bn1'))
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    for li in (1, 2, 3):
        x = layer(x, w, li)
    return x


def resnet_tail(pooled, w):
    """layer4 and its spatial mean: [N, 1024, P, P] -> [N, 2048]."""
    return layer(pooled, w, 4).mean(dim=(2, 3))


def query_images(im_uint8, pixel_means):
    """uint8 BGR [B, H, W, 3] -> mean-subtracted float32 NCHW."""
    means = torch.tensor(pixel_means, dtype=torch.float32,
                         device=im_uint8.device)
    return (im_uint8.float() - means).permute(0, 3, 1, 2)


def avg_pool14(x):
    return F.avg_pool2d(x, 14, 1)


def linear(x, w, name):
    return F.linear(x, w[f'{name}.weight'], w.get(f'{name}.bias'))


# --------------------------------------------------------------------- RPN

def rpn(corr, w, num_anchors):
    """corr NCHW [B, din, h, w] -> (logits [B, N, 2], fg probs [B, N],
    deltas [B, N, 4]), N = h*w*A in (h, w, a) order; the cls channels are
    bg [0:A] and fg [A:2A]."""
    b, _, h, wd = corr.shape
    a = num_anchors
    x = F.relu(conv(corr, w, 'RCNN_rpn.RPN_Conv', 1, 1))
    raw = conv(x, w, 'RCNN_rpn.RPN_cls_score').permute(0, 2, 3, 1)
    logits = torch.stack([raw[..., :a], raw[..., a:]], dim=-1)
    logits = logits.reshape(b, h * wd * a, 2)
    probs = torch.softmax(logits, dim=-1)[..., 1]
    deltas = conv(x, w, 'RCNN_rpn.RPN_bbox_pred').permute(0, 2, 3, 1) \
        .reshape(b, h * wd * a, 4)
    return logits, probs, deltas


def base_anchors(scales, ratios, base_size=16):
    """py-faster-rcnn's anchor table [A, 4] (float64)."""
    def whctr(a):
        w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def make(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    base = np.array([0, 0, base_size - 1, base_size - 1], np.float64)
    w, h, cx, cy = whctr(base)
    ratios = np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    out = []
    for anchor in make(ws, hs, cx, cy):
        w, h, cx, cy = whctr(anchor)
        out.append(make(w * np.asarray(scales, np.float64),
                        h * np.asarray(scales, np.float64), cx, cy))
    return np.vstack(out)


def anchors(fh, fw, scales, ratios, device):
    """The anchor grid [fh*fw*A, 4] float32 in (h, w, a) order."""
    base = base_anchors(scales, ratios)
    sy, sx = np.meshgrid(np.arange(fh) * FEAT_STRIDE,
                         np.arange(fw) * FEAT_STRIDE, indexing='ij')
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    grid = (base[None] + shifts).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def _whctr(boxes):
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return w, h, boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h


def decode(boxes, deltas):
    w, h, cx, cy = _whctr(boxes)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def encode(ex, gt):
    ew, eh, ecx, ecy = _whctr(ex)
    gw, gh, gcx, gcy = _whctr(gt)
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(gw / ew), torch.log(gh / eh)], dim=-1)


def clip(boxes, im_hw):
    """boxes [B, N, 4], im_hw [B, 2] (height, width)."""
    h, w = im_hw[:, None, 0:1], im_hw[:, None, 1:2]
    x = torch.minimum(torch.maximum(boxes[..., 0::2], torch.zeros_like(w)),
                      w - 1)
    y = torch.minimum(torch.maximum(boxes[..., 1::2], torch.zeros_like(h)),
                      h - 1)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def iou(a, b):
    """Pairwise IoU (+1 convention) [..., N, 4] x [..., K, 4]."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def greedy_nms(boxes, valid, thresh, max_out, chunk=2048):
    """Greedy NMS of one image's score-sorted boxes [N, 4] (valid [N]
    bool): the overlap matrix by chunks of rows on the boxes' device, the
    walk in NumPy.  -> kept positions (a list, at most max_out)."""
    n = boxes.shape[0]
    over = np.zeros((n, n), bool)
    th = torch.tensor(thresh, dtype=torch.float32)
    for lo in range(0, n, chunk):
        over[lo:lo + chunk] = (iou(boxes[lo:lo + chunk], boxes)
                               > th.to(boxes.device)).cpu().numpy()
    ok = valid.cpu().numpy().copy()
    keep = []
    for i in range(n):
        if not ok[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        ok[i + 1:] &= ~over[i, i + 1:]
    return keep


def proposals(probs, deltas, anchor_grid, im_info, pre_nms, post_nms,
              thresh):
    """Decode, clip, the top `pre_nms` by a stable descending sort, greedy
    NMS -> (rois [B, post, 5] with the image index in column 0 and zero
    rows past the kept count, mask [B, post])."""
    b, n = probs.shape
    k = min(pre_nms, n)
    boxes = clip(decode(anchor_grid[None].expand(b, -1, -1), deltas),
                 im_info[:, :2])
    scores, order = torch.sort(probs, dim=1, descending=True, stable=True)
    rois = torch.zeros(b, post_nms, 5, device=probs.device)
    mask = torch.zeros(b, post_nms, dtype=torch.bool, device=probs.device)
    for i in range(b):
        sboxes = boxes[i, order[i, :k]]
        keep = greedy_nms(sboxes, torch.ones(k, dtype=torch.bool), thresh,
                          post_nms)
        rois[i, :len(keep), 1:] = sboxes[keep]
        rois[i, :, 0] = i
        mask[i, :len(keep)] = True
    return rois, mask


# ---------------------------------------------------------------- RoIAlign

def _axis_weights(lo, hi, size, pooled, max_samples=16):
    """[..., pooled, size] bilinear weights of one axis: a bin of the roi
    [lo, hi] (feature coordinates) averages ceil(extent / pooled) samples
    (at most max_samples), a sample outside [-1, size] weighs 0, others
    clamp to the map as the reference CUDA kernel does."""
    extent = torch.clamp(hi - lo, min=1.0)
    pooled_t = torch.full_like(extent, pooled)
    bin_sz = extent / pooled_t
    q = torch.floor(extent / pooled_t)
    count = torch.clamp(q + (q * pooled < extent).to(q.dtype), 1,
                        max_samples)
    p = torch.arange(pooled, device=lo.device, dtype=lo.dtype)
    s = torch.arange(max_samples, device=lo.device, dtype=lo.dtype)
    x = (lo[..., None, None] + p[:, None] * bin_sz[..., None, None]
         + (s + 0.5) * (bin_sz / count)[..., None, None])
    take = (s < count[..., None, None]) & (x >= -1.0) & (x <= size)
    xc = torch.clamp(x, min=0.0)
    x_low = torch.clamp(torch.floor(xc), max=size - 1)
    frac = torch.where(x_low >= size - 1, 0.0, xc - x_low)
    x_high = torch.clamp(x_low + 1, max=size - 1)
    wt = take.to(lo.dtype) / count[..., None, None]
    u = torch.arange(size, device=lo.device, dtype=lo.dtype)
    contrib = ((u == x_low[..., None]) * (wt * (1 - frac))[..., None]
               + (u == x_high[..., None]) * (wt * frac)[..., None])
    return contrib.sum(dim=-2)


def roi_align(feat, rois, pooled=7, scale=1.0 / FEAT_STRIDE):
    """feat NCHW [B, C, H, W], rois [B, R, 5] (image index ignored: row b
    pools from image b) -> [B, R, C, P, P], the separable RoIAlign sum
    Wy feat Wx^T, image by image."""
    r = rois[..., 1:].float() * scale
    h, w = feat.shape[2:]
    wy = _axis_weights(r[..., 1], r[..., 3], h, pooled)
    wx = _axis_weights(r[..., 0], r[..., 2], w, pooled)
    return torch.stack([torch.einsum('rph,chw,rqw->rcpq', wy[i], feat[i],
                                     wx[i]) for i in range(feat.shape[0])])


# ------------------------------------------------------------- postprocess

def postprocess(rois, cls_prob, bbox_pred, im_info, stds=(0.1, 0.1, 0.2, 0.2),
                score_thresh=0.05, nms_thresh=0.3, max_per_image=100):
    """-> (dets [B, max, 5] (x1, y1, x2, y2, score) in raw-image
    coordinates, valid [B, max]): denormalised deltas decoded on the rois,
    clipped, rescaled; greedy NMS over the scores above the threshold."""
    b = rois.shape[0]
    deltas = bbox_pred * torch.tensor(stds, device=rois.device)
    boxes = clip(decode(rois[..., 1:5], deltas), im_info[:, :2])
    boxes = boxes / im_info[:, None, 2:3]
    scores = cls_prob[..., 1]
    dets = torch.zeros(b, max_per_image, 5, device=rois.device)
    valid = torch.zeros(b, max_per_image, dtype=torch.bool,
                        device=rois.device)
    for i in range(b):
        s = torch.where(scores[i] > score_thresh, scores[i], -torch.inf)
        ss, order = torch.sort(s, descending=True, stable=True)
        keep = greedy_nms(boxes[i, order], torch.isfinite(ss), nms_thresh,
                          max_per_image)
        idx = order[keep]
        dets[i, :len(keep), :4] = boxes[i, idx]
        dets[i, :len(keep), 4] = scores[i, idx]
        valid[i, :len(keep)] = True
    return dets, valid


# ------------------------------------------------------------ training

def _rank(u, mask):
    """Rank of each True entry among the True entries in the order of its
    draw u; False entries rank after them (stable sorts)."""
    r = torch.where(mask, u, torch.inf)
    return torch.argsort(torch.argsort(r, dim=-1, stable=True), dim=-1,
                         stable=True)


def _take(x, idx):
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(*idx.shape[:2], *x.shape[2:]))


def iou_masked(boxes, gt):
    """IoU of [B, N, 4] boxes with gt [B, G, 5]: a zero-area gt row
    (padding) gives 0, a zero-area box -1."""
    g = gt[..., :4]
    ov = iou(boxes, g)
    gz = ((g[..., 2] - g[..., 0] + 1.0) == 1.0) & \
        ((g[..., 3] - g[..., 1] + 1.0) == 1.0)
    bz = ((boxes[..., 2] - boxes[..., 0] + 1.0) == 1.0) & \
        ((boxes[..., 3] - boxes[..., 1] + 1.0) == 1.0)
    ov = torch.where(gz[..., None, :], 0.0, ov)
    return torch.where(bz[..., :, None], -1.0, ov)


def anchor_targets(anchor_grid, gt, im_info, u_fg, u_bg, batch=256,
                   fg_fraction=0.5, pos=0.7, neg=0.3):
    """The RPN's labels [B, N] in {-1, 0, 1}, targets [B, N, 4], inside and
    outside weights [B, N]: anchors leaving the image are ignored, each
    gt's best anchors and those above `pos` are fg, below `neg` bg; at most
    fg_fraction * batch fg and bg to fill the batch, each picked by the
    rank of its uniform draw."""
    inside = ((anchor_grid[:, 0] >= 0) & (anchor_grid[:, 1] >= 0)
              & (anchor_grid[:, 2] < im_info[:, None, 1])
              & (anchor_grid[:, 3] < im_info[:, None, 0]))
    b = gt.shape[0]
    ov = iou_masked(anchor_grid[None].expand(b, -1, -1), gt)
    ov = torch.where(inside[..., None], ov, -1.0)
    max_ov, argmax = ov.max(dim=2).values, ov.argmax(dim=2)
    gt_max = ov.max(dim=1).values
    gt_max = torch.where(gt_max == 0.0, 1e-5, gt_max)
    best = (ov == gt_max[:, None, :]).any(dim=2)
    labels = torch.full_like(max_ov, -1, dtype=torch.long)
    labels = torch.where(max_ov < neg, 0, labels)
    labels = torch.where(best, 1, labels)
    labels = torch.where(max_ov >= pos, 1, labels)
    labels = torch.where(inside, labels, -1)
    fg = labels == 1
    labels = torch.where(fg & ~(_rank(u_fg, fg) < int(fg_fraction * batch)),
                         -1, labels)
    n_bg = batch - (labels == 1).sum(dim=1, keepdim=True)
    bg = labels == 0
    labels = torch.where(bg & ~(_rank(u_bg, bg) < n_bg), -1, labels)
    assigned = _take(gt[..., :4], argmax)
    targets = encode(anchor_grid[None].expand_as(assigned), assigned)
    targets = torch.where(inside[..., None], targets, 0.0)
    in_w = (labels == 1).float()
    n_ex = (labels >= 0).sum(dim=1, keepdim=True).clamp(min=1).float()
    out_w = torch.where(labels >= 0, 1.0 / n_ex, 0.0)
    return labels, targets, in_w, out_w


def roi_targets(rois, gt, u_rank, u_fg, u_bg, per_image=128, fg_fraction=0.25,
                fg_thresh=0.5, bg_hi=0.5, bg_lo=0.1,
                stds=(0.1, 0.1, 0.2, 0.2)):
    """Sample per_image rois an image from the proposals and the gt boxes:
    fg (IoU >= fg_thresh) without replacement by the ranks of u_rank, at
    most fg_fraction of the slots; bg (IoU in [bg_lo, bg_hi)) with
    replacement, floor(u * n_bg); one kind alone fills every slot with
    replacement.  -> rois [B, S, 5], labels [B, S], targets, inside and
    outside weights [B, S, 4]."""
    b, s = rois.shape[0], per_image
    fg_per = int(round(fg_fraction * per_image)) or 1
    cand = torch.cat([rois, torch.cat([gt.new_zeros(*gt.shape[:2], 1),
                                       gt[..., :4]], -1)], 1)
    t = cand.shape[1]
    ov = iou_masked(cand[..., 1:5], gt)
    max_ov, assign = ov.max(dim=2).values, ov.argmax(dim=2)
    cls = gt[..., 4].gather(1, assign)
    fg = max_ov >= fg_thresh
    bg = (max_ov < bg_hi) & (max_ov >= bg_lo)
    n_fg, n_bg = fg.sum(1), bg.sum(1)
    fg_order = torch.argsort(torch.where(fg, _rank(u_rank, fg), t), dim=1,
                             stable=True)
    bg_pos = torch.argsort((~bg).long(), dim=1, stable=True)
    fg_pos = torch.argsort((~fg).long(), dim=1, stable=True)
    both = (n_fg > 0) & (n_bg > 0)
    only_fg = (n_fg > 0) & (n_bg == 0)
    valid = n_fg + n_bg > 0
    zero = torch.zeros_like(n_fg)
    fg_count = torch.where(both, n_fg.clamp(max=fg_per),
                           torch.where(only_fg, s, zero))
    slot = torch.arange(s, device=rois.device)
    is_fg = slot[None] < fg_count[:, None]
    fg_sel = torch.where(both[:, None], fg_order[:, :s],
                         fg_pos.gather(1, (u_fg * n_fg[:, None]).long()))
    u_bg_s = u_bg.gather(1, (slot[None] - fg_count[:, None]) % s)
    bg_sel = bg_pos.gather(1, (u_bg_s * n_bg.clamp(min=1)[:, None]).long())
    sel = torch.where(is_fg, fg_sel, bg_sel)
    out = _take(cand, sel)
    out = torch.cat([torch.arange(b, device=rois.device, dtype=rois.dtype)
                     [:, None, None].expand(b, s, 1), out[..., 1:]], -1)
    labels = torch.where(is_fg, cls.gather(1, sel), 0.0).long()
    labels = torch.where(valid[:, None], labels, 0)
    targets = encode(out[..., 1:5], _take(gt[..., :4], assign.gather(1, sel)))
    targets = targets / torch.tensor(stds, device=rois.device)
    posm = ((labels > 0) & valid[:, None])[..., None]
    targets = torch.where(posm, targets, 0.0)
    in_w = posm.float().expand(-1, -1, 4)
    out = torch.where(valid[:, None, None], out, 0.0)
    return out, labels, targets, in_w, in_w.clone()


def smooth_l1(pred, targets, in_w, out_w, sigma=1.0, dims=None):
    s2 = sigma * sigma
    d = in_w * (pred - targets)
    a = d.abs()
    flag = (a < 1.0 / s2).float()
    loss = out_w * (flag * 0.5 * s2 * d * d + (1 - flag) * (a - 0.5 / s2))
    dims = tuple(range(1, loss.dim())) if dims is None else dims
    return loss.sum(dim=dims).mean()


def masked_ce(logits, labels, mask):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def _desc_rank(x):
    order = torch.argsort(-x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def hard_mined_picks(margin, labels, neg_margin):
    """The background rois the 1:2:1 loss picks, from the positive and the
    negative branch's fg - bg score margins (a softmax's fg probability
    orders as its margin) -> (bg picks, negative picks), flat bool."""
    fg = labels.reshape(-1) > 0
    m = fg.numel()
    n_fg = fg.sum()
    bg0 = (2 * n_fg).clamp(1, int(2 * m * 0.25))
    bg1 = torch.minimum(n_fg.clamp(min=1), bg0)
    bg = ~fg & (_desc_rank(torch.where(fg, -torch.inf,
                                       margin.reshape(-1))) < bg0)
    return bg, _desc_rank(neg_margin.reshape(-1)) < bg1


def hard_mined_ce(logits, labels, neg_logits):
    """DAnA's 1:2:1 loss over the batch's M rois: every fg roi (label 1),
    the clamp(2 n_fg, 1, M/2) bg rois of highest fg probability (label 0),
    the clamp(n_fg, 1, that) negative-support rois of highest fg
    probability (label 0); mean over the picked."""
    m = labels.numel()
    lg, ng = logits.reshape(m, 2), neg_logits.reshape(m, 2)
    fg = labels.reshape(m) > 0
    with torch.no_grad():
        n_fg = fg.sum()
        bg0 = (2 * n_fg).clamp(1, int(2 * m * 0.25))
        bg1 = torch.minimum(n_fg.clamp(min=1), bg0)
        fgp = torch.softmax(lg, -1)[:, 1]
        bg_pick = ~fg & (_desc_rank(torch.where(fg, -torch.inf, fgp)) < bg0)
        neg_pick = _desc_rank(torch.softmax(ng, -1)[:, 1]) < bg1
        count = n_fg + bg_pick.sum() + neg_pick.sum()
    lp, nlp = torch.log_softmax(lg, -1), torch.log_softmax(ng, -1)
    total = ((-lp[:, 1] * fg).sum() + (-lp[:, 0] * bg_pick).sum()
             + (-nlp[:, 0] * neg_pick).sum())
    return total / count.clamp(min=1)


def sgd_step(w, grads, velocity, lr, momentum=0.9, weight_decay=5e-4):
    """One SGD step in place on the trainable leaves of `w`: biases at
    twice the lr and no weight decay, the rest at lr with weight decay;
    v = momentum * v + (g + wd * p) (the first v is that sum); p -= lr' v."""
    for name, g in grads.items():
        bias = name.endswith('bias')
        d = g if bias else g + weight_decay * w[name]
        v = velocity.get(name)
        velocity[name] = d.clone() if v is None else v.mul_(momentum).add_(d)
        w[name] = w[name] - (2 * lr if bias else lr) * velocity[name]
