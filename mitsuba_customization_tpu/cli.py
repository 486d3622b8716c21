"""Command-line renderer: `python -m mitsuba_customization_tpu.cli`.

Counterpart of mitsuba3 src/mitsuba/mitsuba.cpp (SURVEY.md §2.5
L6): load a scene (XML or a Python file/JSON dict), render, write the
image. Mirrors the reference CLI surface:

    mitsuba scene.xml -o out.exr -D spp=128 -m variant
->  python -m mitsuba_customization_tpu.cli scene.xml -o out.png -D spp=128

-D key=value substitutes $vars in XML scenes (xml.cpp's parameter
mechanism). Output: .png (sRGB 8-bit), .npy (float exact; the EXR
stand-in — no OpenEXR in this environment).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_scene(path, defines):
    from mitsuba_customization_tpu.render import xml as xml_mod
    from mitsuba_customization_tpu.render.scene import load_dict

    if path.endswith(".xml"):
        return xml_mod.load_file(path, **defines)
    if path.endswith(".json"):
        with open(path) as f:
            return load_dict(json.load(f))
    if path.endswith(".py"):
        # a python file defining `scene_dict` (or `make_scene()`)
        ns: dict = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), ns)
        if "make_scene" in ns:
            return load_dict(ns["make_scene"](**defines))
        return load_dict(ns["scene_dict"])
    raise ValueError(f"unsupported scene format: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba_customization_tpu",
        description="differentiable renderer "
        "(mitsuba_customization capability set)",
    )
    ap.add_argument("scene", help="scene file (.xml, .json, .py)")
    ap.add_argument("-o", "--output", default="output.png",
                    help="output image (.png or .npy)")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="scene variable override")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=None, help="max path depth")
    ap.add_argument("--integrator", default=None,
                    help="path | direct | depth | aov_normals")
    ap.add_argument("--sharded", action="store_true",
                    help="shard rays across all local devices")
    args = ap.parse_args(argv)

    defines = {}
    for d in args.define:
        if "=" not in d:
            ap.error(f"-D expects key=value, got '{d}'")
        k, v = d.split("=", 1)
        defines[k] = v

    from mitsuba_customization_tpu.utils import compile_cache
    from mitsuba_customization_tpu.utils.io import write_npy, write_png
    from mitsuba_customization_tpu.utils.log import logger

    compile_cache.enable()

    t0 = time.time()
    scene = _load_scene(args.scene, defines)
    logger.info(
        "loaded scene: %d prims, %d materials, %d emitters (%.2fs)",
        scene.geometry.n_prims,
        scene.bsdfs.mat_type.shape[0],
        scene.emitters.n_emitters,
        time.time() - t0,
    )

    import jax

    t0 = time.time()
    if args.sharded:
        from mitsuba_customization_tpu.parallel.mesh import (
            make_mesh,
            render_sharded_jit,
        )

        img = render_sharded_jit(scene, make_mesh(), spp=args.spp,
                                 seed=args.seed)
    else:
        from mitsuba_customization_tpu.render.integrator import render_jit

        img = render_jit(scene, spp=args.spp, seed=args.seed,
                         integrator=args.integrator, max_depth=args.depth)
    jax.block_until_ready(img)
    dt = time.time() - t0
    spp = args.spp or scene.config.spp
    n_rays = scene.config.width * scene.config.height * spp
    logger.info("rendered %dx%d @ %d spp in %.2fs (%.1f Mprimary rays/s)",
                scene.config.width, scene.config.height, spp, dt,
                n_rays / dt / 1e6)

    if args.output.endswith(".npy"):
        write_npy(args.output, img)
    else:
        write_png(args.output, img)
    logger.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
