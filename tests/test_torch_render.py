"""The port's render path against the JAX package on the CPU: the Blender
preparation math (``blender_prep``, with the reference quirks its docstring
lists), the stick-figure animation (``plot_3d_motion`` writes a gif where
ffmpeg is absent), and ``python -m ladiff_torch.render`` against the root
``render.py``: the same flags to a fake Blender binary that records its
argv, the port's own bpy script named, and the stick-figure backend's files.

Sizes: 3 to 25 frames of 21 or 22 joints.  The numpy math is the same code
on both sides: held to 1e-12 absolute; the argv lists exactly.
"""
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from ladiff_torch.render import blender_prep as pbp
from ladiff_tpu.render import blender_prep as rbp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def _joints(T=25, J=22, seed=0):
    j = np.random.RandomState(seed).randn(T, J, 3) * 0.4
    j[..., 1] += 1.0
    return j


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_tables_match_jax():
    for name in ("HUMANML3D_JOINTS", "HUMANML3D_KINEMATIC_TREE",
                 "KIT_KINEMATIC_TREE"):
        assert getattr(pbp, name) == getattr(rbp, name)


@pytest.mark.parametrize("canonicalize,always_on_floor,scale",
                         [(True, False, 1.0), (False, True, 1.0),
                          (True, True, 0.75 / 480)])
def test_prepare_joints_matches_jax(canonicalize, always_on_floor, scale):
    """Canonicalization (the hips read through the MMM table, as the
    reference does), the axis swap into Blender's z-up frame, the floor."""
    j = _joints()
    _close(pbp.get_floor(j), rbp.get_floor(j))
    _close(pbp.get_forward_direction(j[0]), rbp.get_forward_direction(j[0]))
    _close(pbp.canonicalize_joints(j), rbp.canonicalize_joints(j))
    kw = dict(canonicalize=canonicalize, always_on_floor=always_on_floor,
              scale=scale)
    got = pbp.prepare_joints(j, **kw)
    _close(got, rbp.prepare_joints(j, **kw))
    assert got.shape == j.shape and abs(got[..., 2].min()) < 1e-12


def test_prepare_meshes_frames_and_pruning_match_jax():
    v = _joints(T=7, J=40, seed=1)
    for floor in (False, True):
        _close(pbp.prepare_meshes(v.copy(), always_on_floor=floor),
               rbp.prepare_meshes(v.copy(), always_on_floor=floor))
    for mode, exact in (("sequence", None), ("frame", 0.5), ("video", None)):
        assert pbp.get_frameidx(mode, 25, exact, 8) == rbp.get_frameidx(
            mode, 25, exact, 8)
    with pytest.raises(ValueError):
        pbp.get_frameidx("still", 25, None, 8)
    for perc in (0.0, 0.2):
        _close(pbp.prune_begin_end(v, perc), rbp.prune_begin_end(v, perc))


def test_plot_3d_motion_writes_an_animation(tmp_path):
    pytest.importorskip("matplotlib")
    from ladiff_torch.render.visualize import KINEMATIC_CHAINS, plot_3d_motion
    from ladiff_tpu.render.visualize import KINEMATIC_CHAINS as REF_CHAINS
    assert KINEMATIC_CHAINS == REF_CHAINS
    saved = plot_3d_motion(str(tmp_path / "m.mp4"), _joints(T=3, J=21),
                           title="a person walks", fps=10)
    assert os.path.exists(saved) and os.path.getsize(saved) > 0
    assert saved.endswith((".mp4", ".gif"))


def _fake_blender(tmp_path):
    """An executable that appends its argv (as JSON) to ``argv.jsonl``."""
    path = tmp_path / "blender"
    path.write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"open({str(tmp_path / 'argv.jsonl')!r}, 'a').write("
        "json.dumps(sys.argv[1:]) + '\\n')\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _run(cmd, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("keys", [
    {},
    {"MODE": "sequence", "RES": "low", "NUM": 4, "EXACT_FRAME": 0.25,
     "FACES_PATH": "smplh.faces", "DENOISING": False, "DOWNSAMPLE": True,
     "CANONICALIZE": False, "FPS": 12.5}])
def test_entry_point_blender_flags_match_root_script(tmp_path, keys):
    """``--cfg`` with ``RENDER.BLENDER_PATH`` on a fake Blender: the port
    passes the root script's flags for every file of ``--dir``, and names
    ``ladiff_torch/render/blender_render.py``."""
    import yaml
    data = tmp_path / "samples"
    data.mkdir()
    for i in range(2):
        np.save(data / f"sample_00{i}.npy", _joints(T=4, seed=i))
    cfg = tmp_path / "render.yaml"
    cfg.write_text(yaml.safe_dump({"RENDER": dict(
        BLENDER_PATH=_fake_blender(tmp_path), DIR=str(data), **keys)}))
    _run([sys.executable, os.path.join(REPO, "render.py"), "--cfg",
          str(cfg)], tmp_path)
    _run([sys.executable, "-m", "ladiff_torch.render", "--cfg", str(cfg)],
         tmp_path)
    calls = [json.loads(line) for line in
             (tmp_path / "argv.jsonl").read_text().splitlines()]
    assert len(calls) == 4
    root_calls, port_calls = calls[:2], calls[2:]
    for want, got in zip(root_calls, port_calls):
        assert want[:2] == got[:2] == ["--background", "--python"]
        assert want[2] == os.path.join(REPO, "scripts", "blender_render.py")
        assert got[2] == os.path.join(REPO, "ladiff_torch", "render",
                                      "blender_render.py")
        assert os.path.exists(got[2])
        assert got[3:] == want[3:]
    assert port_calls[1][5].endswith("sample_001.npy")
    if keys:
        assert "--no-denoising" in port_calls[0]


def test_entry_point_stick_figure_matches_root_script(tmp_path, monkeypatch,
                                                     capsys):
    """No Blender: both scripts draw the stick figure for ``--npy`` with the
    caption of its ``.txt`` as the title; without input the port refuses."""
    pytest.importorskip("matplotlib")
    import importlib.util

    from ladiff_torch.render.__main__ import main
    spec = importlib.util.spec_from_file_location(
        "ladiff_root_render_for_port", os.path.join(REPO, "render.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    for who in ("root", "port"):
        d = tmp_path / who
        d.mkdir()
        np.save(d / "sample_000.npy", _joints(T=3, J=22))
        (d / "sample_000.txt").write_text("a person waves\n")
        argv = ["--npy", str(d / "sample_000.npy"), "--fps", "10",
                "--out_ext", "gif"]
        if who == "root":
            monkeypatch.setattr(sys, "argv", ["render.py"] + argv)
            root.main()
        else:
            main(argv)
        out = capsys.readouterr().out
        assert f"rendered {d / 'sample_000.npy'} -> {d / 'sample_000.gif'}" \
            in out
        assert os.path.getsize(d / "sample_000.gif") > 0
    with pytest.raises(SystemExit):
        main([])


def test_bpy_script_imports_outside_blender(monkeypatch):
    """The port's bpy script imports without Blender (every module of the
    package does) and refuses to run there.  ``bpy`` is made unimportable
    here: another test file of the same worker may have stubbed it."""
    import importlib
    monkeypatch.setitem(sys.modules, "bpy", None)
    monkeypatch.delitem(sys.modules, "ladiff_torch.render.blender_render",
                        raising=False)
    blender_render = importlib.import_module(
        "ladiff_torch.render.blender_render")
    assert blender_render.bpy is None
    assert blender_render.prepare_joints is pbp.prepare_joints
    with pytest.raises(SystemExit, match="inside Blender"):
        blender_render.main()


def test_blender_side_imports_without_torch():
    """Blender's own Python has numpy but no torch: the bpy script and the
    preparation it imports load with torch unimportable."""
    code = ("import sys; sys.modules['torch'] = None; "
            "import ladiff_torch.render.blender_render as b; "
            "print(b.prepare_joints.__module__)")
    out = _run([sys.executable, "-c", code], REPO)
    assert out.strip() == "ladiff_torch.render.blender_prep"
