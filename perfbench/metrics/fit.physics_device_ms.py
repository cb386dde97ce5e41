"""fit.physics_device_ms: device milliseconds a step in every operation
but the traversal kernels (K1, K2) and the beam cull's (K5 `walk_*`,
`place_*`, `sort_kernel`): returns, shading and their backward, K6
included.  A renamed kernel needs a change of `perfbench/readers.py`."""

from perfbench import readers


def read(run):
    other = readers.device_seconds(
        run, readers.kernels("tile_traverse_kernel", "pulse_traverse_kernel",
                             "walk_thread_kernel", "walk_group_kernel",
                             "place_thread_kernel", "place_group_kernel",
                             "sort_kernel"), match=False)
    if other is None or not run["items"]:
        return None
    return other * 1e3 / run["items"]
