"""The model's operations per request or step, and the hand-kernel sites
with their least times, counted from a cell's configuration and traffic
whatever implements them.

`model_flops(cfg, traffic)`: the forward of every convolution, linear,
attention product and relation head (DAnA, FSOD), and in training the
backward of each trained layer with the input gradients it needs (twice
the forward, once where only the weight gradient is needed; nothing for
the frozen stem and layer1).  Elementwise work, softmaxes, pooling and
the box arithmetic are not counted.

`kernel_sites(cfg, traffic)`: [(kernel name pattern, least seconds)] of
one request or step, for the hand kernels the path launches: K1 (CISA,
`cisa_shots_kernel`) at each attention site, K2 / K3 (RoIAlign,
`roi_align_fwd_kernel` / `roi_align_pw_kernel`), NMS (`mask_kernel`,
`walk_kernel`).
"""

from __future__ import annotations

from portbench.work import cisa, conv, nms, peaks, roi_align

C, TAIL = 1024, 2048


def _sizes(cfg, traffic):
    m = cfg['model']
    h, w = cfg['canvas']
    fh, fw = conv.map_size(h, w)
    sh, sw = conv.map_size(cfg['support_px'], cfg['support_px'])
    return m, traffic['batch'], h, w, fh, fw, sh * sw


def _anchors(m):
    return len(m['anchor_scales']) * len(m['anchor_ratios'])


def _head_rows(m, train):
    return m['rois_per_image'] if train else m['test_post_nms']


def _dana_forward(cfg, traffic, train):
    """(forward flops, the part that trains: its backward at 2x)."""
    m, b, h, w, fh, fw, ns = _sizes(cfg, traffic)
    s, d, p2 = m['n_shot'], m['rpn_reduce_dim'], m['pooling_size'] ** 2
    r = _head_rows(m, train)
    nq = fh * fw
    heads = (cisa.projections_flops(b, nq, s, ns, C, d,
                                    m['semantic_enhance'])
             + cisa.flops(b, nq, s, ns, d, C)
             + conv.conv_flops(b, 2 * C, 512, 3, fh, fw)
             + conv.conv_flops(b, 512, 6 * _anchors(m), 1, fh, fw)
             + conv.trunk_flops(b * r, 7, 7, stages=(4,))
             + conv.linear_flops(b * r, TAIL, 4))
    branches = 2 if train else 1          # the negative supports' scores
    score = (cisa.projections_flops(b, r * p2, s, p2, C,
                                    m['rcnn_reduce_dim'])
             + cisa.flops(b, r * p2, s, p2, m['rcnn_reduce_dim'], C)
             + conv.linear_flops(b * r * p2, 2 * C, 64)
             + conv.linear_flops(b * r, 64 * p2, 1024)
             + conv.linear_flops(b * r, 1024, 2))
    return heads + branches * score


def _fsod_forward(cfg, traffic):
    m, b, h, w, fh, fw, _ = _sizes(cfg, traffic)
    r, p2 = m['test_post_nms'], m['pooling_size'] ** 2
    ch, cw = fh - 6, fw - 6
    sup = cfg['support_px']
    q = C // 4
    return (conv.trunk_flops(b * m['n_shot'], sup, sup)
            + 2 * b * C * ch * cw * p2
            + conv.conv_flops(b, C, 512, 3, ch, cw)
            + conv.conv_flops(b, 512, 6 * _anchors(m), 1, ch, cw)
            + conv.trunk_flops(b * r, 7, 7, stages=(4,))
            + conv.linear_flops(b * r, TAIL, 4)
            + conv.linear_flops(b * r * p2 + b * p2, C, C)
            + 2 * b * r * C * p2
            + conv.linear_flops(b * r, 2 * C, C)
            + conv.linear_flops(b * r, C, C)
            + conv.linear_flops(b * r * p2, 2 * C, q)
            + conv.conv_flops(b * r, q, q, 3, 3, 3)
            + conv.linear_flops(b * r * 9, q, C)
            + 3 * conv.linear_flops(b * r, C, 2))


def model_flops(cfg, traffic):
    """Operations of one request (serving) or one step (training)."""
    m, b, h, w, *_ = _sizes(cfg, traffic)
    train = traffic['kind'] == 'train'
    sup = cfg['support_px']
    if m['framework'] == 'fsod':
        if train:
            raise NotImplementedError('FSOD training is not a cell')
        return conv.trunk_flops(b, h, w) + _fsod_forward(cfg, traffic)
    queries = conv.trunk_flops(b, h, w)
    if not train:                        # the supports are cached
        return queries + _dana_forward(cfg, traffic, False)
    n_sup = b * m['n_way'] * m['n_shot']
    forward = (queries + conv.trunk_flops(n_sup, sup, sup)
               + _dana_forward(cfg, traffic, True))
    backward = (conv.trunk_backward_flops(b, h, w)
                + conv.trunk_backward_flops(n_sup, sup, sup)
                + 2 * _dana_forward(cfg, traffic, True))
    return forward + backward


def kernel_sites(cfg, traffic):
    m, b, h, w, fh, fw, ns = _sizes(cfg, traffic)
    train = traffic['kind'] == 'train'
    p2 = m['pooling_size'] ** 2
    r = _head_rows(m, train)
    sites = []
    if m['framework'] in ('DAnA', 'cisa'):
        s = m['n_shot']
        for g, nq, n, d in ((b, fh * fw, ns, m['rpn_reduce_dim']),
                            (b, r * p2, p2, m['rcnn_reduce_dim'])):
            sites.append(('cisa_shots_kernel', peaks.least_s(
                cisa.flops(g, nq, s, n, d, C),
                cisa.nbytes(g, nq, s, n, d, C))))
        if train:                        # the negative supports' RoI site
            sites.append(sites[-1])
    if train:
        sites.append(('roi_align_pw_kernel', peaks.least_s(
            0, roi_align.train_bytes(b, fh, fw, C, r))))
        pre, post = m['train_pre_nms'], m['train_post_nms']
        nms_calls = [(pre, post)]
    else:
        sites.append(('roi_align_fwd_kernel', peaks.least_s(
            0, roi_align.serve_bytes(b, fh, fw, C, r))))
        post = cfg['postprocess']
        nms_calls = [(m['test_pre_nms'], m['test_post_nms']),
                     (m['test_post_nms'], post['max_per_image'])]
    for n, keep in nms_calls:
        sites.append(('nms', peaks.least_s(0, nms.nbytes(b, n, keep))))
    return sites
