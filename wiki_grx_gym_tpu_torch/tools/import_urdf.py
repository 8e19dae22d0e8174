"""Compile a URDF (or MJCF) file into the port's JSON robot spec (port of
``tools/import_urdf.py``; the same JSON text for the same file).

    python -m wiki_grx_gym_tpu_torch.tools.import_urdf <robot.urdf> <out.json> [--armature A]
"""

import argparse

from wiki_grx_gym_tpu_torch.models.serialize import save_robot
from wiki_grx_gym_tpu_torch.models.urdf import compile_robot


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("urdf")
    ap.add_argument("out")
    ap.add_argument("--armature", type=float, default=0.0)
    args = ap.parse_args(argv)
    model = compile_robot(args.urdf, armature=args.armature)
    save_robot(model, args.out)
    print(model.summary())


if __name__ == "__main__":
    main()
