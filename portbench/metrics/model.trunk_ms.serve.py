"""Device ms a traced request charged to the program's `dana.trunk` and
`dana.support_trunk` ranges (the queries' and, for FSOD, the supports'
ResNet-50 base)."""


def read(run):
    t = run.trace
    if run.kind != 'serve' or t is None or not t.device or not t.units:
        return None
    return 1e3 * t.charged_s(
        lambda n: n in ('dana.trunk', 'dana.support_trunk')) / t.units
