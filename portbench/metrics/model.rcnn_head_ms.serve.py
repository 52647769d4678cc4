"""Device ms a traced request charged to the program's `dana.rcnn_head`
range (layer4 on the rois, the box branch, the RoI attention or relation
heads)."""


def read(run):
    t = run.trace
    if run.kind != 'serve' or t is None or not t.device or not t.units:
        return None
    return 1e3 * t.charged_s(lambda n: n == 'dana.rcnn_head') / t.units
