"""Reading a traced stretch of the window from torch.profiler's chrome
trace.

Every kernel, copy and memset on the card is charged to the host ranges
(`dana.*` of the program, `bench.*` of the benchmark) that were open when
it was launched, through the trace's correlation ids, which also covers
the kernels the program launches through ctypes (no aten op is their
parent).  (The attribution of tools/profile_torch_predict.py.)  The
device's busy time is the union of the device intervals, so kernels and
copies that overlap on two streams count once, clipped to the stretch's
service intervals: the `bench.request` / `bench.step` ranges around each
traced request or step.
"""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
SERVICE = ('bench.request', 'bench.step')


class Trace:
    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)['traceEvents']
        self.ranges, self.ops, self.device = [], [], []
        # the runtime's launch of each correlation id (a kernel's event may
        # come before its launch's in the file)
        launch = {e['args']['correlation']: e['ts'] for e in events
                  if e.get('cat') in LAUNCH_CATS
                  and 'correlation' in e.get('args', {})}
        for e in events:
            cat, args = e.get('cat', ''), e.get('args', {})
            if 'dur' not in e:
                continue
            if cat == 'user_annotation' and e['name'].startswith(
                    ('dana.', 'bench.')):
                self.ranges.append((e['name'], e['ts'], e['ts'] + e['dur']))
            elif cat == 'cpu_op':
                self.ops.append((e['name'], e['ts'], e['ts'] + e['dur']))
            elif cat in DEVICE_CATS:
                self.device.append((e['name'], e['ts'], e['ts'] + e['dur'],
                                    launch.get(args.get('correlation'))))
        self.service = sorted((t0, t1) for n, t0, t1 in self.ranges
                              if n in SERVICE)
        self.units = len(self.service)

    # -- device time charged to host ranges
    def charged_s(self, pred):
        """Seconds of device work launched while a range whose name
        satisfies `pred` was open, inside the service intervals."""
        spans = [(t0, t1) for n, t0, t1 in self.ranges if pred(n)]
        total = 0.0
        for _, d0, d1, ts in self.device:
            if ts is not None and self._in_service(d0) and any(
                    t0 <= ts <= t1 for t0, t1 in spans):
                total += d1 - d0
        return total * 1e-6

    def kernel_s(self, pattern):
        """Seconds of the kernels whose name matches the regex `pattern`,
        inside the service intervals."""
        rx = re.compile(pattern)
        return 1e-6 * sum(d1 - d0 for name, d0, d1, _ in self.device
                          if rx.search(name) and self._in_service(d0))

    def _in_service(self, t):
        i = bisect.bisect_right(self.service, (t, float('inf'))) - 1
        return i >= 0 and self.service[i][0] <= t <= self.service[i][1]

    # -- busy and idle
    def busy_intervals(self):
        """The union of the device intervals, clipped to the service
        intervals."""
        out = []
        for _, d0, d1, _ in sorted(self.device, key=lambda e: e[1]):
            if out and d0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], d1)
            else:
                out.append([d0, d1])
        clipped = []
        for s0, s1 in self.service:
            for d0, d1 in out:
                lo, hi = max(s0, d0), min(s1, d1)
                if lo < hi:
                    clipped.append((lo, hi))
        return clipped

    def busy_s(self):
        return 1e-6 * sum(hi - lo for lo, hi in self.busy_intervals())

    def window_s(self):
        return 1e-6 * sum(t1 - t0 for t0, t1 in self.service)

    def idle_gaps(self):
        """[(t0, t1)] of the service intervals where no device work ran."""
        busy = self.busy_intervals()
        gaps = []
        for s0, s1 in self.service:
            at = s0
            for lo, hi in busy:
                if hi <= s0 or lo >= s1:
                    continue
                if lo > at:
                    gaps.append((at, lo))
                at = max(at, hi)
            if at < s1:
                gaps.append((at, s1))
        return gaps

    # -- the breakdown the ledger keeps
    def top_device_ops(self, n=10):
        tot = collections.Counter()
        for name, d0, d1, _ in self.device:
            if self._in_service(d0):
                tot[name] += (d1 - d0) * 1e-6
        return [[k, v] for k, v in tot.most_common(n)]

    def host_label(self, t):
        """What the host was doing at t: the innermost benchmark or program
        range and the innermost aten op open then."""
        def inner(spans):
            best = None
            for name, t0, t1 in spans:
                if t0 <= t <= t1 and (best is None or t0 >= best[1]):
                    best = (name, t0)
            return best[0] if best else None
        parts = [inner([r for r in self.ranges if r[0] not in SERVICE]),
                 inner(self.ops)]
        return '/'.join(p for p in parts if p) or 'host'

    def longest_gaps(self, n=10):
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_label(t0), (t1 - t0) * 1e-6] for t0, t1 in gaps]
