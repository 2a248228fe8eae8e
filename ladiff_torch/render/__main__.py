"""Offline rendering entry point of the port (counterpart of the root
``render.py``): saved ``.npy`` joint files -> videos.

    python -m ladiff_torch.render --npy experiments/.../sample_000.npy
                                  [--dir folder] [--fps 20] [--cfg
                                  configs/render_ladiff.yaml]
                                  [--blender <binary>] [--out_ext mp4]

Two backends, both on the host:
  * a matplotlib stick-figure animation (the default; matplotlib is
    imported only here);
  * Blender / Cycles where ``--blender`` or ``RENDER.BLENDER_PATH`` names a
    Blender binary: one ``blender --background --python
    ladiff_torch/render/blender_render.py -- --npy <file> ...`` per file,
    the ``RENDER.*`` keys passed on as the script's flags.
"""
from __future__ import annotations

import argparse
import glob
import os
import subprocess

BLENDER_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "blender_render.py")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ladiff_torch.render")
    ap.add_argument("--cfg", type=str, default=None,
                    help="render config (RENDER.* keys, see "
                         "configs/render_ladiff.yaml); CLI flags override")
    ap.add_argument("--npy", type=str, default=None, help="single npy file")
    ap.add_argument("--dir", type=str, default=None,
                    help="render every *.npy in a folder")
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--blender", type=str, default=None,
                    help="path to a Blender binary (Cycles backend)")
    ap.add_argument("--out_ext", type=str, default=None)
    args = ap.parse_args(argv)

    r = {}
    if args.cfg:
        from ladiff_torch.config import load_yaml
        r = load_yaml(args.cfg).get("RENDER", {})
    if args.npy is None and str(r.get("NPY", "") or ""):
        args.npy = str(r["NPY"])
    if args.dir is None and str(r.get("DIR", "") or ""):
        args.dir = str(r["DIR"])
    if args.fps is None:
        args.fps = float(r.get("FPS", 20.0))
    if args.out_ext is None:
        args.out_ext = str(r.get("VID_EXT", "mp4"))
    if args.blender is None and str(r.get("BLENDER_PATH", "") or ""):
        args.blender = str(r["BLENDER_PATH"])

    files = []
    if args.npy:
        files.append(args.npy)
    if args.dir:
        files.extend(sorted(glob.glob(os.path.join(args.dir, "*.npy"))))
    if not files:
        ap.error("provide --npy or --dir")

    if args.blender and os.path.exists(args.blender):
        extra = ["--mode", str(r.get("MODE", "video") or "video"),
                 "--res", str(r.get("RES", "high") or "high"),
                 "--fps", str(args.fps),
                 "--num", str(r.get("NUM", 8) or 8),
                 "--exact-frame", str(r.get("EXACT_FRAME", 0.5) or 0.5)]
        if str(r.get("FACES_PATH", "") or ""):
            extra += ["--faces", str(r["FACES_PATH"])]
        if not bool(r.get("DENOISING", True)):
            extra += ["--no-denoising"]
        if bool(r.get("DOWNSAMPLE", False)):
            extra += ["--downsample"]
        if not bool(r.get("CANONICALIZE", True)):
            extra += ["--no-canonicalize"]
        for f in files:
            cmd = [args.blender, "--background", "--python", BLENDER_SCRIPT,
                   "--", "--npy", f] + extra
            print("+", " ".join(cmd))
            subprocess.run(cmd, check=True)
        return

    import numpy as np

    from ladiff_torch.render.visualize import plot_3d_motion

    for f in files:
        joints = np.load(f)
        title = os.path.basename(f)
        txt = f.rsplit(".", 1)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt) as fh:
                title = fh.readline().strip()
        out = f.rsplit(".", 1)[0] + "." + args.out_ext
        saved = plot_3d_motion(out, joints, title=title, fps=int(args.fps))
        print(f"rendered {f} -> {saved}")


if __name__ == "__main__":
    main()
