# End-to-end drive through the public package API, on the default backend
# (the GPU where JAX has one). chip_smoke.py runs the same check at N=224.
import sys, time
sys.path.insert(0, __import__("os").path.join(__import__("os").path.dirname(__file__), ".."))
import numpy as np
import jax

import bioem_tpu
from bioem_tpu.params import BioEMParams
from bioem_tpu.config import RunConfig
from bioem_tpu.io.model_io import Model
from bioem_tpu.io.map_io import ImageStack
from bioem_tpu.core.orientations import build_orientations
from bioem_tpu.core.engine import BioEMEngine

print("backend:", jax.default_backend(), jax.devices(), flush=True)

# --- scenario: plant a particle at known orientation + displacement ---
N = 64
p = BioEMParams(
    pixel_size=2.0, n_pixels=N,
    use_quaternions=True, grid_points_quaternion=3,
    n_amp=1, start_amp=0.1, end_amp=0.1,
    n_phase=4, start_defocus=0.5, end_defocus=2.5,
    n_env=2, start_bfactor=2.0, end_bfactor=100.0,
    max_displace_center=4, grid_space_center=2,
).finalize_ctf_mode()
orients = build_orientations(p)
print("orientations:", orients.n, "ctfs:", p.n_ctf, flush=True)

rng = np.random.default_rng(7)
pts = rng.uniform(-25, 25, (40, 3)).astype(np.float32)
# radii quantised to 0.1 Å → ≤15 distinct values, so the engine takes the
# Fourier radius-group projection path (also required by refine_results)
radii = np.round(rng.uniform(2.0, 3.4, 40), 1).astype(np.float32)
dens = rng.uniform(40, 110, 40).astype(np.float32)
model = Model(pts, radii, dens, float(dens.sum())).center_density_mass()

# forward-simulate with the oracle pieces: orientation #17, conv #3, shift (2, -2)
from tests.oracle.oracle import project, rotmat_quat
from bioem_tpu.core.ctf import build_ctf_bank
from bioem_tpu.params import make_ctf_grid
TRUE_ORIENT, TRUE_CONV, TRUE_DX, TRUE_DY = 17, 3, 2, -2
grid = make_ctf_grid(p)
bank = build_ctf_bank(p, grid)
proj = project(p, model.points.astype(np.float64), radii, dens, model.norm_den, rotmat_quat(orients.angles[TRUE_ORIENT]))
conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(bank[TRUE_CONV]), s=(N, N))
img = np.roll(conv, (TRUE_DX, TRUE_DY), axis=(0, 1))
img = img + rng.normal(0, 0.1 * img.std(), img.shape)
# normalize like MRC ingest
img = (img - img.mean()) / img.std()
images = ImageStack(np.stack([img, rng.normal(0, 1, (N, N))]).astype(np.float32))  # planted + pure-noise

t0 = time.time()
eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=8))
state = eng.run()
jax.block_until_ready(state.total)
t1 = time.time()
res = eng.results(state)
print(f"run time (incl compile): {t1-t0:.1f}s", flush=True)
print("logP:", res.log_prob, flush=True)
print("best_orient:", res.best_orient, "expected", TRUE_ORIENT, flush=True)
print("best_conv:", res.best_conv, "expected", TRUE_CONV, flush=True)
print("best_cent:", res.best_cent_x, res.best_cent_y, f"expected ({TRUE_DX},{TRUE_DY})", flush=True)
ok = (res.best_orient[0] == TRUE_ORIENT and res.best_conv[0] == TRUE_CONV
      and res.best_cent_x[0] == TRUE_DX and res.best_cent_y[0] == TRUE_DY
      and res.log_prob[0] > res.log_prob[1])
print("PLANTED-PARAMETER RECOVERY:", "PASS" if ok else "FAIL", flush=True)
# throughput check
t0 = time.time(); state = eng.run(); jax.block_until_ready(state.total); t1 = time.time()
comps = orients.n * p.n_ctf * images.n
print(f"steady-state: {t1-t0:.2f}s  {comps/(t1-t0):.0f} comparisons/s", flush=True)

# --- continuous refinement (beyond the reference; bioem_tpu/refine.py) ---
t0 = time.time()
ref = bioem_tpu.refine_results(eng, res, image_indices=[0], n_starts=8, iters=40)
t1 = time.time()
print(f"refine time: {t1-t0:.1f}s  logpro {ref.logpro_seed[0]:.1f} -> "
      f"{ref.logpro_refined[0]:.1f}  cent ({ref.cent_x[0]:+.2f},{ref.cent_y[0]:+.2f})",
      flush=True)
# planted truth is ON-grid here, so the polish must stay near the seed and
# must not lose log-posterior (monotone accept/reject guarantees >=).
ref_ok = (
    ref.logpro_refined[0] >= ref.logpro_seed[0]
    and abs(ref.cent_x[0] - TRUE_DX) < 1.0
    and abs(ref.cent_y[0] - TRUE_DY) < 1.0
    and np.isfinite(ref.grad_norm[0])
)
print("CONTINUOUS REFINEMENT:", "PASS" if ref_ok else "FAIL", flush=True)
