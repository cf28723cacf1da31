"""End-to-end tutorial: the reference's MODEL_COMPARISON workflow.

Mirrors the BioEM tutorial (/root/reference/doc/index.rst:1852-2521): build
two candidate structural models, forward-simulate a particle stack from
model 1 (known orientations, CTF, displacements, noise), then run the full
pipeline through the public CLI surface:

  1. generate a uniform quaternion list  (bioem_tpu.utils.so3)
  2. write an MRC particle stack          (bioem_tpu.io.mrc)
  3. run the posterior engine per model   (python -m bioem_tpu.cli ...)
  4. rank the models                      (python -m bioem_tpu.rank ...)

Model 1 must win (the tutorial's acceptance criterion). Run from the repo
root:  python examples/tutorial.py [workdir]

This parent process stays off JAX (it only writes files); the CLI steps run
as child processes one at a time, so each has the device to itself.
"""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bioem_tpu.io.model_io import AA_DENSITY, AA_RADIUS, Model
from bioem_tpu.io.mrc import write_mrc
from bioem_tpu.utils.so3 import make_quaternion_list

N_PIX = 32
N_IMG = 10
PIXEL_SIZE = 2.0

PARAM = f"""\
PIXEL_SIZE {PIXEL_SIZE}
NUMBER_PIXELS {N_PIX}
USE_QUATERNIONS
CTF_B_ENV 10.0 10.0 1
CTF_DEFOCUS 1.0 1.0 1
CTF_AMPLITUDE 0.1 0.1 1
DISPLACE_CENTER 2 1
"""


def make_model(rng, n_pts=30, spread=20.0):
    residues = rng.choice(list(AA_RADIUS), n_pts)
    pts = rng.uniform(-spread, spread, (n_pts, 3)).astype(np.float32)
    radii = np.array([AA_RADIUS[r] for r in residues], np.float32)
    dens = np.array([AA_DENSITY[r] for r in residues], np.float32)
    return Model(pts, radii, dens, float(dens.astype(np.float64).sum()))


def write_model(path, m):
    with open(path, "w") as f:
        for k in range(m.n_points):
            f.write(
                f"{m.points[k,0]:.6f} {m.points[k,1]:.6f} {m.points[k,2]:.6f} "
                f"{m.radii[k]:.6f} {m.densities[k]:.6f}\n"
            )


def simulate_stack(rng, model, quats):
    """Forward model: project + CTF-convolve + shift + noise (the physics of
    bioem_tpu.simulator, driven directly for a batch)."""
    from bioem_tpu.core.ctf import build_ctf_bank
    from bioem_tpu.params import BioEMParams, make_ctf_grid
    from tests.oracle.oracle import project, rotmat_quat

    p = BioEMParams(
        pixel_size=PIXEL_SIZE, n_pixels=N_PIX, use_quaternions=True,
        n_amp=1, start_amp=0.1, end_amp=0.1,
        n_phase=1, start_defocus=1.0, end_defocus=1.0,
        n_env=1, start_bfactor=10.0, end_bfactor=10.0,
        max_displace_center=2, grid_space_center=1,
    ).finalize_ctf_mode()
    kernel = build_ctf_bank(p, make_ctf_grid(p))[0]
    centered = model.center_density_mass()
    maps = []
    for i in range(N_IMG):
        q = quats[rng.integers(len(quats))]
        proj = project(
            p, centered.points.astype(np.float64), centered.radii,
            centered.densities, centered.norm_den, rotmat_quat(q),
        )
        conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(kernel), s=(N_PIX, N_PIX))
        dx, dy = rng.integers(-2, 3, 2)
        conv = np.roll(conv, (dx, dy), axis=(0, 1))
        noise = rng.normal(0, 0.3 * np.abs(conv).max(), conv.shape)
        maps.append(conv + noise)
    return np.stack(maps).astype(np.float32)


def main():
    work = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tutorial_work",
    )
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(2026)

    print("=== 1. models + orientation list ===")
    m1, m2 = make_model(rng), make_model(rng)
    write_model(os.path.join(work, "model1.txt"), m1)
    write_model(os.path.join(work, "model2.txt"), m2)
    quats = make_quaternion_list(os.path.join(work, "quat64.txt"), 64)
    with open(os.path.join(work, "param.txt"), "w") as f:
        f.write(PARAM)

    print("=== 2. forward-simulate particles from model 1 ===")
    stack = simulate_stack(rng, m1, quats)
    # MRC stores transposed sections (reference map.cpp:663-853 convention).
    write_mrc(os.path.join(work, "particles.mrc"),
              np.transpose(stack, (0, 2, 1)), PIXEL_SIZE)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         env.get("PYTHONPATH", "")]
    )
    # CPU-scale example: the children run on the host unless the caller
    # chose a platform (e.g. JAX_PLATFORMS=cuda).
    env.setdefault("JAX_PLATFORMS", "cpu")

    print("=== 3. posterior run, model 1 (CLI) ===")
    subprocess.run(
        [sys.executable, "-m", "bioem_tpu.cli",
         "--Modelfile", "model1.txt", "--Particlesfile", "particles.mrc",
         "--ReadMRC", "--Inputfile", "param.txt",
         "--ReadOrientation", "quat64.txt",
         "--OutputFile", "Output_m1"],
        cwd=work, env=env, check=True,
    )

    print("=== 4. model ranking (model 1 must win) ===")
    res = subprocess.run(
        [sys.executable, "-m", "bioem_tpu.rank",
         "--Modelfile", "model1.txt", "--Modelfile", "model2.txt",
         "--Particlesfile", "particles.mrc", "--ReadMRC",
         "--Inputfile", "param.txt", "--ReadOrientation", "quat64.txt",
         "--OutputFile", "Model_Ranking"],
        cwd=work, env=env, check=True, capture_output=True, text=True,
    )
    print(res.stdout)
    assert "#1 model1.txt" in res.stdout, "model 1 did not win the ranking!"
    print("TUTORIAL: PASS (generating model ranked first)")
    print(f"artifacts in {work}")


if __name__ == "__main__":
    main()
