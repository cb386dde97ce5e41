"""scan.construct_host_share: the share of the traced window in each
`Simulator`'s construction (the program's ``lbt.construct`` spans inside
`api.simulate`) less the host to device copies in it (its ``lbt.upload``
spans): the scene's checks and host reads, the sim noise drawn on the
host, the Wald rows built on the host."""

from perfbench import spans
from perfbench.trace import union_seconds


def read(run):
    rec = spans.record()
    roots = [] if rec is None else spans.named(rec, "lbt.simulate")
    if not roots:
        return None
    host = 0
    for c in spans.below(rec, roots, "lbt.construct"):
        ups = spans.below(rec, [c], "lbt.upload")
        host += (c.end_ns - c.start_ns
                 - union_seconds((u.start_ns, u.end_ns) for u in ups))
    return spans.share(run, host)
