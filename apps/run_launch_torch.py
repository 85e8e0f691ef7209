#!/usr/bin/env python
"""Run a reference-format ROS ``.launch`` file against the PyTorch/CUDA port's apps.

Counterpart of ``apps/run_launch.py`` on ``airslam_tpu_torch``: the same
roslaunch subset, parsed by this file's own copy of the parser, with each
node mapped onto the port's CLI (``*_torch.py``). The apps run on the card
unless ``--device cpu`` is passed through.

The reference is driven entirely through roslaunch XML files
(the reference's ``launch/**``: visual_odometry / map_refinement /
relocalization nodes whose ``<param>`` entries carry the config paths —
demo/visual_odometry.cpp:17-24 reads them as ROS params). A user switching
from the reference keeps their launch files:

    python apps/run_launch_torch.py launch/visual_odometry/vo_euroc.launch \
        dataroot:=/data/euroc/MH_01_easy/mav0 saving_dir:=/tmp/out

Supported roslaunch subset (everything the reference's launch files use):
``<arg name default>`` declarations, ``$(arg name)`` / ``$(find air_slam)``
substitution, ``<node>`` with ``<param name value>`` children, ``<group>``
(rviz visualization groups are skipped — headless publisher instead), and
``name:=value`` command-line arg overrides.

Param-name differences between the reference binaries and our apps are
mapped per node type (e.g. the relocalization node's ``dataroot`` is the
query image folder → ``--query_folder``). Params the port has no use
for (DBoW ``.bin`` vocabularies — retrained as tensors at refinement time;
ONNX ``model_dir`` without ``.npz`` weights; refinement ``breakpoint``)
are dropped with a warning instead of failing.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# node "type" attribute → (app, {launch param → app flag})
NODE_APPS = {
    "visual_odometry": ("apps/visual_odometry_torch.py", {
        "config_path": "--config_path",
        "camera_config_path": "--camera_config_path",
        "dataroot": "--dataroot",
        "saving_dir": "--saving_dir",
        "model_dir": "--model_dir",
        "traj_path": "--traj_path",
    }),
    "map_refinement": ("apps/map_refinement_torch.py", {
        "config_path": "--config_path",
        "camera_config_path": "--camera_config_path",
        "map_root": "--map_root",
        "voc_path": "--voc_path",
        "model_dir": "--model_dir",
    }),
    "relocalization": ("apps/relocalization_torch.py", {
        "config_path": "--config_path",
        "map_root": "--map_root",
        "dataroot": "--query_folder",  # reloc queries a folder of images
        "traj_path": "--traj_path",
        "model_dir": "--model_dir",
    }),
}


def _substitute(value: str, args: dict, find_root: str) -> str:
    """Resolve $(arg name) and $(find pkg) in a launch attribute value."""
    out = []
    i = 0
    while i < len(value):
        j = value.find("$(", i)
        if j < 0:
            out.append(value[i:])
            break
        out.append(value[i:j])
        k = value.find(")", j)
        if k < 0:
            raise ValueError(f"unterminated substitution in {value!r}")
        parts = value[j + 2 : k].split()
        if parts[0] == "arg":
            name = parts[1]
            if name not in args:
                raise KeyError(f"$(arg {name}) is not declared")
            out.append(str(args[name]))
        elif parts[0] == "find":
            out.append(find_root)
        else:
            raise ValueError(f"unsupported substitution $({' '.join(parts)})")
        i = k + 1
    return "".join(out)


def parse_launch(path: str, overrides: dict, find_root: str = REPO):
    """Parse a roslaunch file → list of (node_type, {param: value}).

    ``overrides`` wins over ``<arg default>`` (roslaunch ``name:=value``
    semantics). ``$(find air_slam)`` resolves to ``find_root`` so the
    reference's config paths land in this repo's ``configs/`` tree.
    """
    root = ET.parse(path).getroot()
    args: dict = {}
    nodes = []

    def walk(elem):
        for child in elem:
            if child.tag == "arg":
                name = child.get("name")
                if name in overrides:
                    args[name] = overrides[name]
                elif child.get("value") is not None:
                    args[name] = _substitute(child.get("value"), args, find_root)
                elif child.get("default") is not None:
                    args[name] = _substitute(child.get("default"), args, find_root)
                elif name not in args:
                    raise KeyError(f"launch arg {name!r} has no default; "
                                   f"pass {name}:=VALUE")
            elif child.tag == "node":
                if child.get("pkg") == "rviz" or child.get("type") == "rviz":
                    continue  # headless: io/publisher.py is the viz surface
                params = {}
                for p in child:
                    if p.tag == "param":
                        params[p.get("name")] = _substitute(
                            p.get("value", ""), args, find_root)
                nodes.append((child.get("type"), params))
            elif child.tag == "group":
                # reference groups only gate rviz on $(arg visualization);
                # evaluate the condition and recurse (nested nodes/args)
                cond = child.get("if")
                if cond is not None:
                    v = _substitute(cond, args, find_root).strip().lower()
                    if v in ("0", "false"):
                        continue
                # headless build: skip groups that only contain rviz
                walk(child)
            elif child.tag == "include":
                raise ValueError("<include> is not supported; inline the "
                                 "launch file contents")
        return nodes

    walk(root)
    return nodes


def node_command(node_type: str, params: dict, extra: list) -> list:
    """Map one parsed <node> to a command line of the port's app."""
    if node_type not in NODE_APPS:
        raise ValueError(f"unknown node type {node_type!r} "
                         f"(supported: {sorted(NODE_APPS)})")
    app, mapping = NODE_APPS[node_type]
    cmd = [sys.executable, os.path.join(REPO, app)]
    for name, value in params.items():
        flag = mapping.get(name)
        if flag is None:
            print(f"[run_launch] ignoring param {name}={value!r} "
                  f"(no {node_type} equivalent)", file=sys.stderr)
            continue
        if name == "voc_path" and not str(value).endswith(".npz"):
            # DBoW2 .bin vocabularies are reference-format; the refiner
            # retrains a tensor vocabulary from the map when absent
            print(f"[run_launch] ignoring non-.npz voc_path {value!r} "
                  f"(vocabulary is trained from the map)", file=sys.stderr)
            continue
        if name == "model_dir":
            if not (os.path.isdir(value) and glob.glob(os.path.join(value, "*.npz"))):
                print(f"[run_launch] ignoring model_dir {value!r} (no .npz "
                      f"weights; using shipped checkpoints)", file=sys.stderr)
                continue
        cmd += [flag, str(value)]
    return cmd + list(extra)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("launch_file")
    ap.add_argument("assignments", nargs=argparse.REMAINDER,
                    help="roslaunch-style arg overrides: name:=value; "
                         "anything starting with '--' is passed through to "
                         "the app (e.g. --device cpu)")
    args = ap.parse_args(argv)

    overrides, extra = {}, []
    passthrough = False
    for a in args.assignments:
        if a.startswith("--"):
            passthrough = True
        if passthrough:
            extra.append(a)
        elif ":=" in a:
            k, v = a.split(":=", 1)
            overrides[k] = v
        else:
            raise SystemExit(f"unrecognized argument {a!r} "
                             f"(expected name:=value or --app-flag)")

    nodes = parse_launch(args.launch_file, overrides)
    if not nodes:
        raise SystemExit("launch file declares no runnable nodes")
    for node_type, params in nodes:
        cmd = node_command(node_type, params, extra)
        print(f"[run_launch] {node_type}: {' '.join(cmd)}", flush=True)
        r = subprocess.run(cmd)
        if r.returncode != 0:
            raise SystemExit(r.returncode)


if __name__ == "__main__":
    main()
