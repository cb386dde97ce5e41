"""scan.upload_share: the share of the traced window in the program's
``lbt.upload`` spans on the main thread inside `api.simulate`: the host to
device copies of construction (scene, materials, sim noise, Wald rows) and
of chunk prep (each chunk's rays, the BVH's node records at the first
cull)."""

from perfbench import spans


def read(run):
    return spans.survey_share(run, "lbt.upload")
