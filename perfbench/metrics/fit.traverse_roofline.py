"""fit.traverse_roofline: the traversal's least time over the traversal
kernels' device time, in %.  The least time is the bytes that any
implementation must move, 24 B of ray (origin and direction, float32) in
and 8 B of hit (t and face) out per ray, at the published HBM peak of one
H100 (3.35 TB/s, SXM, at its 700 W limit), counted from the cell's rays
alone.  The kernels: K1 `tile_traverse_kernel`, K2
`pulse_traverse_kernel`; a renamed kernel needs a change of
`perfbench/readers.py`."""

from perfbench import readers


def read(run):
    return readers.traverse_roofline(run)
