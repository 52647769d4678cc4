"""The shares of a peak that the per-layer readers (metrics/) report.

`roofline`: the hand kernels' share of their roofline in the traced
stretch: the sum of the least times of the hand-kernel sites of a request
or step (work/detector.py, from the cell's shapes at the card's published
peaks) over the device time of those kernels, found by kernel name.

`mfu`: the whole request's or step's share of the card's float32 peak:
the model's operations of one (work/detector.py, counted from the
configuration's shapes) over its median service time (from the start of
the call to its result on the host), over 495 TFLOP/s.
"""

from portbench import harness
from portbench.work import detector, peaks

PATTERNS = {'cisa_shots_kernel': r'\bcisa_shots_kernel\b',
            'roi_align_fwd_kernel': r'\broi_align_fwd_kernel\b',
            'roi_align_pw_kernel': r'\broi_align_pw_kernel\b',
            'nms': r'(?<![\w:<])(mask_kernel|walk_kernel)\b'}


def roofline(run, kind):
    t = run.trace
    if run.kind != kind or t is None or not t.device or not t.units:
        return None
    sites = detector.kernel_sites(run.cfg, run.traffic)
    least = t.units * sum(s for _, s in sites)
    spent = sum(t.kernel_s(PATTERNS[k]) for k in {k for k, _ in sites})
    return 100.0 * least / spent if spent else None


def mfu(run, kind):
    if run.kind != kind or run.device.type != 'cuda' or not run.service_s:
        return None
    flops = detector.model_flops(run.cfg, run.traffic)
    return 100.0 * flops / harness.median(run.service_s) \
        / peaks.FLOAT32_FLOP_PER_S
