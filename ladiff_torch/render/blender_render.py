"""Blender-side renderer (runs INSIDE Blender's Python).

Counterpart of the reference Blender pipeline
(the reference's ladiff/render/blender/: render.py, scene.py,
camera.py, floor.py, joints.py, meshes.py, materials.py + render/video.py)
launched by ``python -m ladiff_torch.render --blender <binary>``:

  blender --background --python ladiff_torch/render/blender_render.py -- \
      --npy sample.npy [--mode video|sequence|frame] [--res high] \
      [--fps 20] [--num 8] [--exact-frame 0.5] [--faces smplh.faces] \
      [--gt] [--always-on-floor] [--no-canonicalize] [--downsample]

Scene fidelity mirrored from the reference:
  * Cycles + denoising, res presets (high 1280x1024, med /2, low /4,
    ultra x2), white world, SUN light 1.5, transparent film for stills;
  * camera at (7.36, -6.93, 5.2|5.6) with per-mode focal lengths and
    root-tracking updates (camera.py:1-52);
  * floor plane sized to the motion bbox * 1.08 (floor.py:15-53);
  * joints mode: per-chain colored diffuse materials and per-joint-class
    shapes (cylinder+sphere limbs, plain cylinders for shoulders/feet,
    head sphere, torso spheres — joints.py:77-143,176-262);
  * mesh mode: vertices npy + --faces (meshes.py; GT green / generated
    orange, sequence stills fade along the Oranges colormap);
  * sequence mode renders ``--num`` pruned stills into ONE image;
    frame mode renders the still at ``--exact-frame`` of the clip;
  * video mode optionally downsamples ::8 like the reference and
    assembles an mp4 over a white background (render/video.py masks the
    transparent film to white; we disable film transparency for video
    frames — identical pixels, no moviepy dependency inside Blender).

The numeric prep (canonicalization, axis swap, frame sampling) lives in
``ladiff_torch.render.blender_prep`` (numpy only: Blender's Python needs
no PyTorch) and is held to the JAX package's in tests/test_torch_render.py.
"""
import argparse
import math
import os
import sys

try:
    import bpy
except ImportError:  # outside Blender: importable (the package's modules
    bpy = None       # are all imported by its tests), ``main`` refuses

import numpy as np

# the repository root, three levels up, so the port imports inside Blender
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from ladiff_torch.render.blender_prep import (  # noqa: E402
    HUMANML3D_JOINTS, HUMANML3D_KINEMATIC_TREE, KIT_KINEMATIC_TREE,
    get_frameidx, prepare_joints, prepare_meshes, prune_begin_end)

SAT = 1.1
# reference JOINTS_MATS colors (joints.py:15-31): body/rarm/larm/rleg/lleg
# chains + the gray torso material
CHAIN_COLORS = [(0.3500, 0.0357, 0.0349), (0.6500, 0.1750, 0.0043),
                (0.0349, 0.3500, 0.0349), (0.0180, 0.0590, 0.6000),
                (0.0320, 0.3250, 0.4210), (0.3, 0.3, 0.3)]
GT_MESH_COLOR = (0.035, 0.415, 0.122)      # meshes.py GT_SMPL (green)
GEN_MESH_COLOR = (0.658, 0.214, 0.0114)    # meshes.py GEN_SMPL (orange)
# matplotlib Oranges colormap anchor points for the sequence fade
# (meshes.py:36-46 samples cmap('Oranges') between 0.50 and 0.90)
_ORANGES = [(0.9922, 0.5529, 0.2353), (0.9569, 0.4275, 0.1216),
            (0.8824, 0.3137, 0.0627), (0.7451, 0.2235, 0.0196),
            (0.6118, 0.1647, 0.0157)]


def parse_args():
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--npy", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", default="video",
                    choices=["video", "sequence", "frame"])
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--res", default="high",
                    help="high|med|low|ultra or a pixel count")
    ap.add_argument("--num", type=int, default=8,
                    help="stills in sequence mode")
    ap.add_argument("--exact-frame", type=float, default=0.5,
                    help="relative frame for frame mode")
    ap.add_argument("--faces", default=None,
                    help="faces npy enables SMPL mesh rendering")
    ap.add_argument("--gt", action="store_true",
                    help="ground-truth mesh color (green)")
    ap.add_argument("--jointstype", default="humanml3d",
                    choices=["humanml3d", "kit"])
    ap.add_argument("--no-canonicalize", action="store_true")
    ap.add_argument("--always-on-floor", action="store_true")
    ap.add_argument("--downsample", action="store_true",
                    help="video mode: keep every 8th frame (reference)")
    ap.add_argument("--no-denoising", action="store_true")
    ap.add_argument("--samples", type=int, default=64)
    return ap.parse_args(argv)


# -- materials (materials.py) ------------------------------------------------

def diffuse_material(r, g, b, a=1.0, roughness=0.127451, saturation=1.0):
    mat = bpy.data.materials.new(name="body")
    mat.use_nodes = True
    bsdf = mat.node_tree.nodes["Principled BSDF"]
    bsdf.inputs["Base Color"].default_value = (r * saturation, g * saturation,
                                               b * saturation, a)
    bsdf.inputs["Roughness"].default_value = roughness
    return mat


def floor_material(color=(0.2, 0.2, 0.2, 1)):
    return diffuse_material(*color[:3], a=color[3])


# -- scene (scene.py) --------------------------------------------------------

def setup_scene(res="high", denoising=True, samples=64, transparent=True):
    scene = bpy.context.scene
    # start empty
    for obj in list(bpy.data.objects):
        bpy.data.objects.remove(obj, do_unlink=True)

    scene.render.engine = "CYCLES"
    scene.cycles.samples = samples
    if denoising:
        scene.cycles.use_denoising = True
    presets = {"high": (1280, 1024), "med": (640, 512), "low": (320, 256),
               "ultra": (2560, 2048)}
    if res in presets:
        scene.render.resolution_x, scene.render.resolution_y = presets[res]
    else:
        scene.render.resolution_x = scene.render.resolution_y = int(res)
    scene.render.film_transparent = transparent

    world = bpy.data.worlds["World"]
    world.use_nodes = True
    bg = world.node_tree.nodes["Background"]
    bg.inputs[0].default_value[:3] = (1.0, 1.0, 1.0)
    bg.inputs[1].default_value = 1.0

    bpy.ops.object.light_add(type="SUN", location=(0, 0, 0))
    bpy.context.object.data.energy = 1.5
    return scene


# -- camera (camera.py) ------------------------------------------------------

class Camera:
    def __init__(self, first_root, mode, is_mesh):
        bpy.ops.object.camera_add(
            location=(7.36, -6.93, 5.6 if is_mesh else 5.2),
            rotation=(math.radians(63), 0, math.radians(46)))
        self.camera = bpy.context.object
        bpy.context.scene.camera = self.camera
        lens = {"sequence": 65 if is_mesh else 85,
                "frame": 130 if is_mesh else 85,
                "video": 110 if is_mesh else 85}[mode]
        self.camera.data.lens = lens
        self.camera.location.x += first_root[0]
        self.camera.location.y += first_root[1]
        self._root = np.asarray(first_root, np.float64)

    def update(self, newroot):
        delta = np.asarray(newroot, np.float64) - self._root
        self.camera.location.x += delta[0]
        self.camera.location.y += delta[1]
        self._root = np.asarray(newroot, np.float64)


# -- floor (floor.py) --------------------------------------------------------

def plot_floor(data):
    minx, miny, _ = data.min(axis=(0, 1))
    maxx, maxy, _ = data.max(axis=(0, 1))
    location = ((maxx + minx) / 2, (maxy + miny) / 2, 0.0)
    bpy.ops.mesh.primitive_plane_add(size=2, location=location)
    obj = bpy.context.object
    obj.name = "SmallPlane"
    obj.scale = (1.08 * (maxx - minx) / 2, 1.08 * (maxy - miny) / 2, 1)
    obj.active_material = floor_material((0.2, 0.2, 0.2, 1))
    return obj


# -- joints drawing (joints.py:77-262) ---------------------------------------

def _sphere(r, t, mat, segments=50):
    bpy.ops.mesh.primitive_uv_sphere_add(segments=segments,
                                         ring_count=segments,
                                         radius=r, location=tuple(t))
    bpy.context.object.active_material = mat
    return [bpy.context.object]


def _cyl_core(t1, t2, r, mat, shrink=0.0):
    d = np.asarray(t2, np.float64) - np.asarray(t1, np.float64)
    dist = float(np.linalg.norm(d))
    if dist < 1e-8:
        return []
    mid = (np.asarray(t1) + np.asarray(t2)) / 2
    bpy.ops.mesh.primitive_cylinder_add(radius=r, depth=dist - shrink,
                                        location=tuple(mid))
    obj = bpy.context.object
    obj.rotation_euler[1] = math.acos(max(-1.0, min(1.0, d[2] / dist)))
    obj.rotation_euler[2] = math.atan2(d[1], d[0])
    obj.active_material = mat
    return [obj]


def cylinder_between(t1, t2, r, mat):
    """Bone cylinder + end spheres (joints.py:176-201)."""
    objs = _cyl_core(t1, t2, r, mat)
    objs += _sphere(r, t1, mat, segments=32)
    objs += _sphere(r, t2, mat, segments=32)
    return objs


def cylinder_sphere_between(t1, t2, r, mat):
    """Slightly shrunk cylinder with rounded joints (joints.py:203-231)."""
    objs = _sphere(r * 0.9, t1, mat, segments=32)
    objs += _sphere(r * 0.9, t2, mat, segments=32)
    objs += _cyl_core(t1, t2, r, mat, shrink=0.2 * r)
    return objs


def sphere_between(t1, t2, mat, factor=1.0):
    d = np.asarray(t2, np.float64) - np.asarray(t1, np.float64)
    mid = (np.asarray(t1) + np.asarray(t2)) / 2
    return _sphere(float(np.linalg.norm(d)) * factor, mid, mat)


class Joints:
    def __init__(self, data, mode, jointstype):
        self.data = data
        self.mode = mode
        self.trajectory = data[:, 0, [0, 1]]
        self.joints = HUMANML3D_JOINTS
        self.tree = (HUMANML3D_KINEMATIC_TREE if jointstype == "humanml3d"
                     else KIT_KINEMATIC_TREE)
        self.mats = [diffuse_material(*c, saturation=SAT)
                     for c in CHAIN_COLORS]

    def __len__(self):
        return len(self.data)

    def get_root(self, i):
        return self.data[i][0]

    def get_mean_root(self):
        return self.data[:, 0].mean(0)

    def get_sequence_mat(self, frac):
        return self.mats

    def load_in_blender(self, index, mats):
        skel = self.data[index]
        head_mat, body_mat = mats[0], mats[-1]
        objs = []
        names = self.joints
        for chain, mat in zip(self.tree, mats):
            for j1, j2 in zip(chain[:-1], chain[1:]):
                name2 = names[j2] if j2 < len(names) else ""
                if name2 == "BUN":                       # head
                    objs += sphere_between(skel[j1], skel[j2], head_mat)
                elif name2 in ("LE", "RE", "LW", "RW",
                               "LMrot", "RMrot", "RK", "LK"):
                    objs += cylinder_sphere_between(skel[j1], skel[j2],
                                                    0.040, mat)
                elif name2 in ("LS", "RS", "LF", "RF"):
                    objs += cylinder_between(skel[j1], skel[j2], 0.040, mat)
                else:                                    # spine etc.
                    objs += cylinder_sphere_between(skel[j1], skel[j2],
                                                    0.040, mat)
        # torso volume (joints.py:115-121)
        if "BLN" in names and len(self.data[index]) > names.index("BLN"):
            bln, root = names.index("BLN"), names.index("root")
            objs += _sphere(0.14, skel[bln], body_mat)
            objs += sphere_between(skel[bln], skel[root], body_mat,
                                   factor=0.28)
            objs += _sphere(0.11, skel[root], body_mat)
        return objs


class Meshes:
    def __init__(self, data, mode, faces_path, gt):
        self.data = data
        self.mode = mode
        self.faces = np.load(faces_path)
        self.trajectory = data[:, :, [0, 1]].mean(1)
        color = GT_MESH_COLOR if gt else GEN_MESH_COLOR
        self.mat = diffuse_material(*color)

    def __len__(self):
        return len(self.data)

    def get_root(self, i):
        return self.data[i].mean(0)

    def get_mean_root(self):
        return self.data.mean((0, 1))

    def get_sequence_mat(self, frac):
        # Oranges colormap between 0.50 and 0.90 (meshes.py:36-46)
        x = frac * (len(_ORANGES) - 1)
        i = min(int(x), len(_ORANGES) - 2)
        t = x - i
        c = [(1 - t) * a + t * b
             for a, b in zip(_ORANGES[i], _ORANGES[i + 1])]
        return diffuse_material(*c)

    def load_in_blender(self, index, mat):
        mesh = bpy.data.meshes.new(name=f"m{index:04d}")
        mesh.from_pydata(self.data[index].tolist(),
                         [], self.faces.tolist())
        mesh.validate()
        obj = bpy.data.objects.new(f"m{index:04d}", mesh)
        obj.active_material = mat
        bpy.context.collection.objects.link(obj)
        return [obj]


def assemble_video(scene, frame_paths, out_path, fps):
    """mp4 from rendered stills via Blender's own sequencer (the reference
    shells to moviepy in render/video.py; no extra deps this way)."""
    scene.sequence_editor_create()
    for i, p in enumerate(frame_paths):
        scene.sequence_editor.sequences.new_image(
            name=os.path.basename(p), filepath=p, channel=1,
            frame_start=i + 1)
    scene.frame_start = 1
    scene.frame_end = len(frame_paths)
    scene.render.fps = int(round(fps))
    scene.render.image_settings.file_format = "FFMPEG"
    scene.render.ffmpeg.format = "MPEG4"
    scene.render.ffmpeg.codec = "H264"
    scene.render.filepath = out_path
    bpy.ops.render.render(animation=True)
    return out_path


def main():
    if bpy is None:
        raise SystemExit("this script must run inside Blender: "
                         "blender --background --python "
                         "ladiff_torch/render/blender_render.py -- --npy "
                         "<file>")
    args = parse_args()
    npydata = np.load(args.npy)
    assert npydata.ndim == 3 and npydata.shape[2] == 3, npydata.shape
    is_mesh = args.faces is not None and npydata.shape[1] > 100
    base = args.npy.rsplit(".", 1)[0]
    mode = args.mode

    if is_mesh:
        data = prepare_meshes(npydata.astype(np.float64),
                              always_on_floor=args.always_on_floor)
    else:
        data = prepare_joints(npydata.astype(np.float64),
                              canonicalize=not args.no_canonicalize,
                              always_on_floor=args.always_on_floor)

    if mode == "video" and args.downsample and not is_mesh:
        data = data[::8]                       # reference render.py:45-46
    if mode == "sequence":
        data = prune_begin_end(data, 0.2)      # reference render.py:60-63

    scene = setup_scene(res=args.res, denoising=not args.no_denoising,
                        samples=args.samples,
                        transparent=(mode != "video"))
    body = (Meshes(data, mode, args.faces, args.gt) if is_mesh
            else Joints(data, mode, args.jointstype))
    plot_floor(body.data)
    camera = Camera(body.get_root(0), mode, is_mesh)

    frameidx = get_frameidx(mode=mode, nframes=len(body),
                            exact_frame=args.exact_frame,
                            frames_to_keep=args.num)
    if mode == "sequence":
        camera.update(body.get_mean_root())

    frames_dir = args.out or (base + "_frames")
    if mode == "video":
        os.makedirs(frames_dir, exist_ok=True)

    kept = []
    frame_paths = []
    n = len(frameidx)
    for index, fi in enumerate(frameidx):
        if mode == "sequence":
            mat = body.get_sequence_mat(index / max(n - 1, 1))
        else:
            mat = (body.mats if not is_mesh else body.mat)
            camera.update(body.get_root(fi))
        objs = body.load_in_blender(fi, mat)
        is_last = index == n - 1
        if mode == "sequence":
            kept.extend(objs)                  # stills accumulate
            if is_last:
                scene.render.filepath = base + "_sequence.png"
                bpy.ops.render.render(write_still=True)
                print("wrote", scene.render.filepath)
        else:
            path = (os.path.join(frames_dir, f"frame_{index:04d}.png")
                    if mode == "video"
                    else f"{base}_{args.exact_frame}.png")
            scene.render.filepath = path
            bpy.ops.render.render(write_still=True)
            frame_paths.append(path)
            for o in objs:
                bpy.data.objects.remove(o, do_unlink=True)
            if mode == "frame":
                print("wrote", path)

    if mode == "video":
        out = assemble_video(scene, frame_paths, base + "_blender.mp4",
                             args.fps)
        print("wrote", out)


if __name__ == "__main__":
    main()
