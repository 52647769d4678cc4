"""Device ms a traced step charged to the forward's top-level `dana.*`
ranges (one dot: trunk, support_trunk, rpn_attention, rpn_heads,
proposals, targets, roi_align, rcnn_head, losses), not dana.backward or
dana.update."""


def read(run):
    t = run.trace
    if run.kind != 'train' or t is None or not t.device or not t.units:
        return None
    return 1e3 * t.charged_s(
        lambda n: n.startswith('dana.') and n.count('.') == 1
        and n not in ('dana.backward', 'dana.update')) / t.units
