"""Sensor poses: where a configuration's frame is taken from.

``street``: a point on one of the city's street lines (between building
cells), drawn from the pose's own ``seed``, at its mounting height.
``fixed``: the sensor's own position.  The sensor's own ``seed`` seeds
the ray-generation noise.
"""

from __future__ import annotations

import numpy as np

from .scenes import city_streets


def frame_sensor(config: dict) -> dict:
    """The configuration's sensor settings (its frame does not depend on
    the run's seed)."""
    sensor = dict(config["sensor"])
    pose = config["pose"]
    if pose["kind"] == "street":
        spec = config["scene"]
        lines = city_streets(spec["num_buildings"], spec["cell"])
        rng = np.random.default_rng(pose["seed"])
        across = float(rng.choice(lines))
        along = float(rng.uniform(lines[0], lines[-1]))
        x, z = (across, along) if rng.integers(2) else (along, across)
        sensor["tls_position"] = [x, float(pose["height"]), z]
    elif pose["kind"] != "fixed":
        raise ValueError(f"unknown pose kind {pose['kind']!r}")
    return sensor
