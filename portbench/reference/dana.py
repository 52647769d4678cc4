"""The plain reference of DAnA (arXiv:2102.12152) on the ResNet-50 C4
trunk: the dual-awareness attention (the BA block's channel vector on the
supports, then CISA: query tokens attend each shot's support tokens, a
unary term added to the probabilities, the mean over shots) at the RPN
and at the R-CNN head, the RPN, the proposals, RoIAlign, layer4, the box
branch and the score head; the detection postprocess; and the episodic
training losses.

Serving returns a record of every stage (`serve`), training the four
losses (`train_losses`).  Where a record is given as `follow`, the stages
after the proposals pool the rois of that record instead of the
reference's own: a float32 rounding difference reorders near-equal RPN
scores and NMS then keeps other boxes, so the later stages can only be
compared on the same rois.  The proposals themselves are compared as
sets (the benchmark's judge).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import detector as D

C = 1024            # layer3's channels
TAIL = 2048         # layer4's channels


def spec(cfg):
    """[(name, shape, mean, std)] of the detector's weights and frozen
    statistics, scaled so that the attention, the RPN scores and the
    class scores stay off saturation on the random trunk's maps (rms about
    4): near-equal saturated scores would tie."""
    m = cfg['model']
    a = len(m['anchor_scales']) * len(m['anchor_ratios'])
    p = m['pooling_size']
    out = D.resnet50_spec()
    for site, red in (('rpn', m['rpn_reduce_dim']),
                      ('rcnn', m['rcnn_reduce_dim'])):
        out += D.linear_spec(f'{site}_unary_layer', 1, C, gain=0.25)
        out += D.linear_spec(f'{site}_adapt_q_layer', red, C, gain=0.25)
        out += D.linear_spec(f'{site}_adapt_k_layer', red, C, gain=0.25)
    out += D.rpn_spec(2 * C, a)
    out += D.linear_spec('rcnn_transform_layer', 64, 2 * C)
    out += D.linear_spec('output_score_layer.linear1', 1024, 64 * p * p)
    out += D.linear_spec('output_score_layer.linear2', 2, 1024, gain=0.25)
    out += D.linear_spec('RCNN_bbox_pred', 4, TAIL, gain=0.1)
    if m['semantic_enhance']:
        out += D.linear_spec('rpn_channel_k_layer', 1, C, gain=0.25)
    return out


def positional(length, d, device):
    """The sinusoidal table [length, d]: sin on even, cos on odd channels,
    computed in float64 and rounded to float32."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(length, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def cisa(q_tokens, s_tokens, w, site, m, se=None):
    """q_tokens [B, (R,) Nq, C] attend s_tokens [B, S, Ns, C] -> [B, (R,)
    Nq, C]: q and k projected and centred over their tokens, scores scaled
    by 1/sqrt(reduce dim), softmax over the support tokens plus
    unary_gamma times the unary softmax, times the support tokens, the
    mean over the S shots; all the image's query tokens (every roi's)
    attend the image's supports."""
    if se is not None:
        wt = torch.softmax(D.linear(s_tokens, w, se), dim=-2)
        glob = (wt * s_tokens).sum(dim=-2, keepdim=True)
        s_tokens = s_tokens + m['gamma'] * F.leaky_relu(glob)
    q = D.linear(q_tokens, w, f'{site}_adapt_q_layer')
    q = q - q.mean(dim=-2, keepdim=True)
    k = D.linear(s_tokens, w, f'{site}_adapt_k_layer')
    k = k - k.mean(dim=-2, keepdim=True)
    u = torch.softmax(D.linear(s_tokens, w, f'{site}_unary_layer'),
                      dim=-2)[..., 0]
    b, d, s = q.shape[0], q.shape[-1], s_tokens.shape[1]
    scale = 1.0 / math.sqrt(m[f'{site}_reduce_dim'])
    scores = torch.einsum('bqd,bsnd->bsqn', q.reshape(b, -1, d), k) * scale
    probs = torch.softmax(scores, dim=-1) + m['unary_gamma'] * u[:, :, None]
    out = torch.einsum('bsqn,bsnc->bqc', probs, s_tokens) / s
    return out.reshape(*q_tokens.shape)


def supports(w, ims):
    """Support images [N, S, H, W, 3] (mean-subtracted float) -> (maps [N,
    S, C, h, w], pooled [N, S, C, h-13, w-13])."""
    n, s = ims.shape[:2]
    f = D.resnet_base(ims.reshape(n * s, *ims.shape[2:]).permute(0, 3, 1, 2),
                      w)
    p = D.avg_pool14(f)
    return f.reshape(n, s, *f.shape[1:]), p.reshape(n, s, *p.shape[1:])


def tokens(maps, pe):
    """[B, S, C, h, w] -> [B, S, h*w, C] + pe."""
    b, s, c = maps.shape[:3]
    t = maps.reshape(b, s, c, -1).transpose(-1, -2)
    return t + pe[:t.shape[2]]


def rpn_site(w, m, feat, sup_maps):
    """The RPN's attention: feat [B, C, h, w] attends the positive
    supports' maps -> (the attended map NHWC [B, h, w, C], the concat NCHW
    [B, 2C, h, w])."""
    b, c, h, wd = feat.shape
    pe = positional(sup_maps.shape[-2] * sup_maps.shape[-1], c, feat.device)
    q = feat.permute(0, 2, 3, 1).reshape(b, h * wd, c)
    se = 'rpn_channel_k_layer' if m['semantic_enhance'] else None
    dense = cisa(q, tokens(sup_maps, pe), w, 'rpn', m, se).reshape(b, h, wd,
                                                                  c)
    return dense, torch.cat([feat, dense.permute(0, 3, 1, 2)], dim=1)


def scores(w, m, pooled, sup_pooled):
    """The score head: pooled [B, R, C, P, P] attends the supports' pooled
    maps [B, S, C, P, P] -> cls_score [B, R, 2]: the query tokens and their
    attended supports concatenated, projected to 64 a token, flattened
    token-major, two linears."""
    b, r, c, p, _ = pooled.shape
    pe = positional(p * p, c, pooled.device)
    q = pooled.reshape(b, r, c, p * p).transpose(-1, -2) + pe
    dense = cisa(q, tokens(sup_pooled, pe), w, 'rcnn', m)
    corr = D.linear(torch.cat([q, dense], dim=-1), w, 'rcnn_transform_layer')
    x = F.relu(D.linear(corr.reshape(b, r, -1), w,
                        'output_score_layer.linear1'))
    return D.linear(x, w, 'output_score_layer.linear2')


def box_branch(w, pooled):
    b, r = pooled.shape[:2]
    tail = D.resnet_tail(pooled.reshape(b * r, *pooled.shape[2:]), w)
    return D.linear(tail.reshape(b, r, -1), w, 'RCNN_bbox_pred')


def serve(w, cfg, im, im_info, class_supports, classes, follow=None,
          keep_rois=16):
    """One request: uint8 queries [B, H, W, 3], im_info [B, 3], each
    query's class in `classes`, the supports of each class in
    `class_supports` ({cls: [S, H, W, 3] mean-subtracted}) -> the record of
    every stage (NHWC maps; `pooled` holds the first `keep_rois` rois of
    each image), the rois after the proposals those of `follow` when
    given."""
    m = cfg['model']
    a = len(m['anchor_scales']) * len(m['anchor_ratios'])
    feat = D.resnet_base(D.query_images(im, m['pixel_means']), w)
    cls_sup = {c: supports(w, s[None]) for c, s in class_supports.items()}
    sup_f = torch.cat([cls_sup[int(c)][0] for c in classes])
    sup_p = torch.cat([cls_sup[int(c)][1] for c in classes])
    dense, corr = rpn_site(w, m, feat, sup_f)
    _, probs, deltas = D.rpn(corr, w, a)
    grid = D.anchors(feat.shape[2], feat.shape[3], m['anchor_scales'],
                     m['anchor_ratios'], feat.device)
    rois, mask = D.proposals(probs, deltas, grid, im_info, m['test_pre_nms'],
                             m['test_post_nms'], m['rpn_nms_thresh'])
    own_rois, own_mask = rois, mask
    if follow is not None:
        rois, mask = follow['rois'], follow['mask']
    pooled = D.roi_align(feat, rois, m['pooling_size'])
    bbox_pred = box_branch(w, pooled)
    cls_prob = torch.softmax(scores(w, m, pooled, sup_p), dim=-1)
    post = cfg['postprocess']
    dets, valid = D.postprocess(rois, cls_prob, bbox_pred, im_info,
                                stds=m['bbox_normalize_stds'],
                                score_thresh=post['score_thresh'],
                                nms_thresh=post['nms_thresh'],
                                max_per_image=post['max_per_image'])
    return dict(
        feat=feat.permute(0, 2, 3, 1), attn=dense, probs=probs,
        deltas=deltas, rois=rois, mask=mask, own_rois=own_rois,
        own_mask=own_mask,
        pooled=pooled[:, :keep_rois].permute(0, 1, 3, 4, 2),
        cls_prob=cls_prob, bbox_pred=bbox_pred, dets=dets, valid=valid,
        support={c: (f.permute(0, 1, 3, 4, 2), p.permute(0, 1, 3, 4, 2))
                 for c, (f, p) in cls_sup.items()})


def train_proposals(cfg, probs, deltas, im_info, map_hw):
    """The training proposal layer on given RPN outputs (the stage by
    itself: replayed on the program's own scores and deltas)."""
    m = cfg['model']
    grid = D.anchors(*map_hw, m['anchor_scales'], m['anchor_ratios'],
                     probs.device)
    return D.proposals(probs, deltas, grid, im_info, m['train_pre_nms'],
                       m['train_post_nms'], m['rpn_nms_thresh'])


def train_losses(w, cfg, batch, draws, follow_rois=None):
    """The episodic training step's four losses on `batch` (uint8 queries,
    im_info, gt_boxes [B, G, 5], support_ims [B, way*shot, H, W, 3], the
    first shot ones positive) with the target layers' uniform `draws`;
    the proposals those of `follow_rois` when given.  -> (losses dict,
    {own_rois, own_mask: the reference's own proposals, probs, deltas:
    its RPN outputs, map_hw, mining: the hard-mined loss's score margins
    and labels})."""
    m = cfg['model']
    a = len(m['anchor_scales']) * len(m['anchor_ratios'])
    shot = m['n_shot']
    feat = D.resnet_base(D.query_images(batch['im_data'], m['pixel_means']),
                         w)
    sup_f, sup_p = supports(w, batch['support_ims'])
    _, corr = rpn_site(w, m, feat, sup_f[:, :shot])
    logits, probs, deltas = D.rpn(corr, w, a)
    grid = D.anchors(feat.shape[2], feat.shape[3], m['anchor_scales'],
                     m['anchor_ratios'], feat.device)
    info, gt = batch['im_info'], batch['gt_boxes']
    with torch.no_grad():
        own = D.proposals(probs.detach(), deltas.detach(), grid, info,
                          m['train_pre_nms'], m['train_post_nms'],
                          m['rpn_nms_thresh'])
        rois = own[0]
        if follow_rois is not None:
            # rows the followed side left out take the reference's own
            rois = torch.cat([follow_rois, rois[len(follow_rois):]])
        labels, at_t, at_in, at_out = D.anchor_targets(
            grid, gt, info, draws['anchor_fg'], draws['anchor_bg'],
            batch=m['rpn_batchsize'], fg_fraction=m['rpn_fg_fraction'],
            pos=m['rpn_pos_overlap'], neg=m['rpn_neg_overlap'])
        s_rois, s_labels, s_t, s_in, s_out = D.roi_targets(
            rois, gt, draws['roi_fg_rank'], draws['roi_fg'], draws['roi_bg'],
            per_image=m['rois_per_image'], fg_fraction=m['fg_fraction'],
            fg_thresh=m['fg_thresh'], bg_hi=m['bg_thresh_hi'],
            bg_lo=m['bg_thresh_lo'], stds=m['bbox_normalize_stds'])
    pooled = D.roi_align(feat, s_rois, m['pooling_size'])
    bbox_pred = box_branch(w, pooled)
    cls_score = scores(w, m, pooled, sup_p[:, :shot])
    neg_score = scores(w, m, pooled, sup_p[:, shot:m['n_way'] * shot])
    losses = dict(
        rpn_loss_cls=D.masked_ce(logits, labels, labels != -1),
        rpn_loss_box=D.smooth_l1(deltas, at_t, at_in[..., None],
                                 at_out[..., None], sigma=3.0),
        rcnn_loss_cls=D.hard_mined_ce(cls_score, s_labels, neg_score),
        rcnn_loss_bbox=D.smooth_l1(bbox_pred.reshape(-1, 4),
                                   s_t.reshape(-1, 4), s_in.reshape(-1, 4),
                                   s_out.reshape(-1, 4), sigma=1.0,
                                   dims=(1,)))
    mining = torch.stack([cls_score[..., 1] - cls_score[..., 0],
                          neg_score[..., 1] - neg_score[..., 0],
                          s_labels.float()]).detach()
    return losses, dict(own_rois=own[0], own_mask=own[1],
                        probs=probs.detach(), deltas=deltas.detach(),
                        map_hw=tuple(feat.shape[2:]), mining=mining)
