"""Save and load compiled RobotModel specs as JSON (port of
``wiki_grx_gym_tpu/models/serialize.py``).

The specs in ``models/resources/`` are byte-identical copies of the JAX
package's (asserted by tests/test_torch_config.py); :func:`save_robot`
writes the same JSON text as the JAX package's ``save_robot`` for the same
model (``tools/import_urdf.py`` makes a spec from a URDF)."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.models.robot import ARRAY_FIELDS, RobotModel

RESOURCES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources")

_STATIC_FIELDS = (
    "parent", "point_body", "point_link", "name", "body_names", "dof_names",
    "link_names", "link_frames",
)


def save_robot(model: RobotModel, path: str) -> None:
    blob = {}
    for f in ARRAY_FIELDS:
        blob[f] = getattr(model, f).numpy().tolist()
    for f in _STATIC_FIELDS:
        blob[f] = getattr(model, f)
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=1)


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def load_robot(path: str) -> RobotModel:
    with open(path) as fh:
        blob = json.load(fh)
    kwargs = {}
    for f in ARRAY_FIELDS:
        kwargs[f] = torch.from_numpy(np.asarray(blob[f], dtype=np.float32))
    for f in _STATIC_FIELDS:
        v = blob[f]
        kwargs[f] = _tuplify(v) if isinstance(v, list) else v
    return RobotModel(**kwargs)
