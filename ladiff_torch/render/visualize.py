"""Motion visualization: stick-figure 3D animation.

Host-side numpy: the counterpart of ``ladiff_tpu/render/visualize.py``,
line for line.

Rebuild of the reference matplotlib path
(the reference's ladiff/data/humanml/utils/plot_script.py and
ladiff/render/{visualize,anim}.py): draws the kinematic chains per frame
over a ground plane that follows the root trajectory, writes mp4 (ffmpeg)
or gif.  The Blender/Cycles pipeline (reference ladiff/render/blender/) is
an offline external-process tool; `render.py` at the repo root shells out to
it when a Blender install is configured and falls back to this renderer.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["plot_3d_motion", "KINEMATIC_CHAINS"]

KINEMATIC_CHAINS = {
    22: [[0, 2, 5, 8, 11], [0, 1, 4, 7, 10], [0, 3, 6, 9, 12, 15],
         [9, 14, 17, 19, 21], [9, 13, 16, 18, 20]],
    21: [[0, 11, 12, 13, 14, 15], [0, 16, 17, 18, 19, 20], [0, 1, 2, 3, 4],
         [3, 5, 6, 7], [3, 8, 9, 10]],
}

_COLORS = ["#dd2222", "#22dd22", "#2222dd", "#dd22dd", "#22dddd"]


def plot_3d_motion(save_path: str, joints: np.ndarray,
                   title: str = "", fps: int = 20,
                   kinematic_chain: Optional[List[List[int]]] = None,
                   radius: float = 3.0) -> str:
    """joints: [T, J, 3] -> animation file (mp4 if ffmpeg works, else gif)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    joints = np.asarray(joints, np.float64)
    T, J, _ = joints.shape
    chains = kinematic_chain or KINEMATIC_CHAINS.get(J)
    if chains is None:
        chains = [[j, j + 1] for j in range(J - 1)]

    data = joints.copy()
    # put on floor + center xz trajectory like the reference plotter
    data[..., 1] -= data[..., 1].min()
    traj = data[:, 0, [0, 2]]
    data[..., 0] -= traj[:, 0:1]
    data[..., 2] -= traj[:, 1:2]

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")

    def update(i):
        ax.clear()
        ax.set_xlim3d(-radius / 2, radius / 2)
        ax.set_ylim3d(0, radius)
        ax.set_zlim3d(0, radius)
        ax.set_title(f"{title}  frame {i}", fontsize=9)
        ax.grid(False)
        ax.axis("off")
        ax.view_init(elev=120, azim=-90)
        for chain, color in zip(chains, _COLORS * 3):
            ax.plot3D(data[i, chain, 0], data[i, chain, 1],
                      data[i, chain, 2], linewidth=3.0, color=color)
        # trajectory trace on the floor
        ax.plot3D(traj[:i + 1, 0] - traj[i, 0],
                  np.zeros(i + 1), traj[:i + 1, 1] - traj[i, 1],
                  linewidth=1.0, color="#777777")

    anim = FuncAnimation(fig, update, frames=T, interval=1000 / fps)
    try:
        anim.save(save_path, fps=fps)
    except Exception:
        save_path = save_path.rsplit(".", 1)[0] + ".gif"
        anim.save(save_path, fps=fps, writer="pillow")
    plt.close(fig)
    return save_path
