"""End-to-end: JAX engine log(P) and argmax parity with the NumPy oracle.

The oracle (tests/oracle/oracle.py) is a loop-level transliteration of the
reference math; the engine must reproduce its log posteriors to float32
pipeline tolerance and its argmax parameters exactly.
"""

import numpy as np
import pytest

from bioem_tpu.config import RunConfig
from bioem_tpu.core.engine import BioEMEngine
from bioem_tpu.core.orientations import build_orientations
from tests.conftest import tiny_images, tiny_model, tiny_params
from tests.oracle.oracle import run_oracle


def _run_both(p, rng, n_img=3, cfg=None, with_radius=True):
    orients = build_orientations(p)
    model = tiny_model(rng, with_radius=with_radius)
    images = tiny_images(rng, n_img, p.n_pixels)
    oracle = run_oracle(
        p, orients, model.points.astype(np.float64), model.radii, model.densities,
        model.norm_den, images.maps,
    )
    eng = BioEMEngine(p, orients, model, images, cfg or RunConfig(orient_block=3))
    res = eng.results(eng.run())
    return oracle, res


def test_logp_matches_oracle(rng):
    p = tiny_params()
    oracle, res = _run_both(p, rng)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)


def test_argmax_matches_oracle(rng):
    p = tiny_params()
    oracle, res = _run_both(p, rng)
    np.testing.assert_array_equal(res.best_orient, oracle.max_orient)
    np.testing.assert_array_equal(res.best_conv, oracle.max_conv)
    np.testing.assert_array_equal(res.best_cent_x, oracle.max_cent_x)
    np.testing.assert_array_equal(res.best_cent_y, oracle.max_cent_y)
    np.testing.assert_allclose(res.best_norm, oracle.max_norm, rtol=1e-3)
    np.testing.assert_allclose(res.best_mu, oracle.max_mu, rtol=1e-3, atol=1e-5)


def test_point_model_no_radius(rng):
    p = tiny_params()
    oracle, res = _run_both(p, rng, with_radius=False)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)


def test_write_angles(rng):
    p = tiny_params(write_angles=2)
    oracle, res = _run_both(p, rng)
    assert res.angle_log is not None
    np.testing.assert_allclose(res.angle_log, oracle.angle_log, rtol=0, atol=2e-3)


def test_psf_mode(rng):
    p = tiny_params(
        use_psf=True,
        start_amp=0.2, end_amp=0.2, n_amp=1,
        start_phase=0.2, end_phase=0.6, n_phase=2,
        start_env=0.05, end_env=0.2, n_env=2,
    )
    p._finalized = True  # PSF mode: values already in real space
    oracle, res = _run_both(p, rng)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)


def test_quaternion_grid(rng):
    p = tiny_params(use_quaternions=True, grid_points_quaternion=2)
    oracle, res = _run_both(p, rng)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)


def test_image_blocking_invariance(rng):
    p = tiny_params()
    orients = build_orientations(p)
    model = tiny_model(rng)
    images = tiny_images(rng, 5, p.n_pixels)
    r1 = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2, image_block=2))
    r2 = BioEMEngine(p, orients, model, images, RunConfig(orient_block=4, image_block=0))
    a = r1.results(r1.run())
    b = r2.results(r2.run())
    # Different block shapes reorder f32 reductions; ~1e-7 noise expected.
    np.testing.assert_allclose(a.log_prob, b.log_prob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a.best_orient, b.best_orient)


def test_odd_npixels(rng):
    p = tiny_params(n_pixels=15)
    oracle, res = _run_both(p, rng)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)


def test_posterior_invariant_under_image_permutation(rng):
    """Property: permuting the image stack permutes results identically."""
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.engine import BioEMEngine
    from bioem_tpu.core.orientations import build_orientations
    from bioem_tpu.io.map_io import ImageStack
    from .conftest import tiny_images, tiny_model, tiny_params

    p = tiny_params()
    model = tiny_model(rng)
    images = tiny_images(rng, 5, p.n_pixels)
    orients = build_orientations(p)
    perm = np.array([3, 0, 4, 1, 2])

    e1 = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2))
    r1 = e1.results(e1.run())
    e2 = BioEMEngine(
        p, orients, model, ImageStack(images.maps[perm]), RunConfig(orient_block=2)
    )
    r2 = e2.results(e2.run())
    np.testing.assert_allclose(r2.log_prob, r1.log_prob[perm], rtol=1e-12)
    np.testing.assert_array_equal(r2.best_orient, r1.best_orient[perm])


def test_dc_dominated_unnormalized_images_match_oracle(rng):
    """r3 regression: TEXT-ingested images are never normalised (reference
    parity), so a DC-dominated stack violates the sr ≈ 0 premise of the f32
    log1p shortcut in logpro_constants — the engine must take the f64
    correction path (data-driven gate, engine._image_arrays), not key the
    choice on NO_MAP_NORM alone. With the f32 path forced this case is off
    by ~0.07 log-units."""
    from bioem_tpu.io.map_io import ImageStack

    p = tiny_params()
    orients = build_orientations(p)
    model = tiny_model(rng)
    n = p.n_pixels
    maps = (100.0 + rng.normal(0.0, 10.0, size=(3, n, n))).astype(np.float32)
    images = ImageStack(maps)
    oracle = run_oracle(
        p, orients, model.points.astype(np.float64), model.radii,
        model.densities, model.norm_den, images.maps,
    )
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=3))
    assert not eng._f32_corr_ok
    res = eng.results(eng.run())
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-3)

    # A zero-mean engine must refuse a DC-dominated swapped chunk rather
    # than run it through the compiled f32 branch.
    eng0 = BioEMEngine(
        p, orients, model, tiny_images(rng, 3, n), RunConfig(orient_block=3)
    )
    assert eng0._f32_corr_ok
    with pytest.raises(ValueError, match="DC-dominated"):
        eng0.swap_images(maps)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_random_config_corners(seed):
    """Property sweep: randomly sampled parameter-space corners must match
    the oracle. Deliberately includes shapes no other test pins: odd N,
    displacement strides that do not divide N, NON-SYMMETRIC displacement sets (max_disp % stride != 0,
    e.g. {-5,-2,1,4} — reference doRefMapFFT sweeps -maxD..maxD in stride
    steps with no symmetry guarantee, bioem_algorithm.h:156-197), SHIFT_X/Y,
    and both CTF/PSF modes."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.choice([11, 12, 15, 16]))
    stride = int(rng.choice([1, 2, 3]))
    max_d = int(rng.choice([2, 3, 5]))
    use_psf = bool(rng.choice([False, True]))
    kw = dict(
        n_pixels=n,
        pixel_size=float(rng.uniform(1.2, 2.0)),
        max_displace_center=max_d,
        grid_space_center=stride,
        shift_x=int(rng.choice([0, 1])),
        shift_y=int(rng.choice([0, 1])),
        write_angles=int(rng.choice([0, 2])),
        grid_points_alpha=2,
        grid_points_beta=2,
    )
    if use_psf:
        # real-space PSF values (no defocus conversion — see test_psf_mode)
        kw.update(
            use_psf=True,
            n_amp=1, start_amp=0.2, end_amp=0.2,
            start_phase=0.2, end_phase=0.6, n_phase=2,
            start_env=0.05, end_env=0.2, n_env=2,
        )
        p = tiny_params(**kw)
        p._finalized = True
        oracle, res = _run_both(p, np.random.default_rng(2000 + seed), n_img=2)
        np.testing.assert_allclose(res.log_prob, oracle.log_prob, atol=2e-3)
        np.testing.assert_array_equal(res.best_orient, oracle.max_orient)
        return
    p = tiny_params(**kw)
    oracle, res = _run_both(p, rng, n_img=2)
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, atol=2e-4)
    np.testing.assert_array_equal(res.best_orient, oracle.max_orient)
    np.testing.assert_array_equal(res.best_cent_x, oracle.max_cent_x)
    np.testing.assert_array_equal(res.best_cent_y, oracle.max_cent_y)
    if p.write_angles:
        np.testing.assert_allclose(
            res.angle_log, oracle.angle_log, atol=2e-4
        )


@pytest.mark.parametrize("orient_block,image_block,stride,max_d", [
    # Blocks that leave padding lanes on both axes (n_orient and n_img are
    # not multiples of the block sizes; tiny_params' Euler grid gives 8
    # orientations, the stack has 5 images).
    (3, 2, 1, 2), (5, 3, 1, 2), (7, 4, 1, 2), (6, 4, 1, 2),
    # Displacement lattices at strides 1-3; maxD % stride != 0 gives
    # sweeps that are not symmetric about 0 (e.g. {-5, -2, 1, 4}).
    (3, 2, 1, 3), (3, 2, 2, 3), (3, 2, 2, 5), (3, 2, 3, 4), (3, 2, 3, 5),
])
def test_blocking_and_lattice_match_oracle(orient_block, image_block, stride, max_d):
    """Engine vs the NumPy oracle over (orient_block, image_block) pairs
    with padded lanes and over stride-1/2/3 displacement lattices."""
    p = tiny_params(max_displace_center=max_d, grid_space_center=stride)
    rng = np.random.default_rng(77)
    orients = build_orientations(p)
    model = tiny_model(rng)
    images = tiny_images(rng, 5, p.n_pixels)
    oracle = run_oracle(
        p, orients, model.points.astype(np.float64), model.radii,
        model.densities, model.norm_den, images.maps,
    )
    cfg = RunConfig(orient_block=orient_block, image_block=image_block)
    eng = BioEMEngine(p, orients, model, images, cfg)
    assert eng.n_orient_pad > eng.n_orient and eng.n_img_pad > eng.n_img
    res = eng.results(eng.run())
    np.testing.assert_allclose(res.log_prob, oracle.log_prob, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(res.best_orient, oracle.max_orient)
    np.testing.assert_array_equal(res.best_conv, oracle.max_conv)
    np.testing.assert_array_equal(res.best_cent_x, oracle.max_cent_x)
    np.testing.assert_array_equal(res.best_cent_y, oracle.max_cent_y)


def test_refined_varying_max_is_f64_accurate(rng):
    """displacement_lse's returned max must equal the f64 re-evaluation at
    the argmax (absolute-accuracy repair), not the f32 reduction value."""
    import jax.numpy as jnp

    from bioem_tpu.core.posterior import displacement_lse

    o, c, i, d = 2, 2, 3, 5
    ntot = 224.0 * 224.0
    # Scales chosen so u = (2·sr·sc·cc − N²·cc²)/f0 stays in (−1, 0]-ish
    # territory for EVERY entry: ntot·cc²/f0 ≤ 50176·25/1e9 ≈ 1.3e-3
    # (review r5: the first version drove u < −1 → NaN logpro, and
    # assert_allclose's default equal_nan=True made the check vacuous).
    cc = rng.normal(0, 1.0, (o, c, i, d, d)).astype(np.float32) * 5.0
    sum_c = rng.normal(0, 1, (o, c)).astype(np.float32)
    sum_ref = rng.normal(0, 1, (i,)).astype(np.float32)
    f0 = np.abs(rng.normal(0, 1, (o, c, i))).astype(np.float64) * 1e9 + 1e9
    m, se, ds, ccs = displacement_lse(
        cc, jnp.asarray(sum_c), jnp.asarray(sum_ref), jnp.asarray(f0), ntot
    )
    assert np.asarray(m).dtype == np.float64
    assert np.isfinite(np.asarray(m)).all()
    cc64 = np.asarray(ccs).astype(np.float64)
    u = (
        2.0 * sum_ref[None, None, :].astype(np.float64)
        * sum_c[:, :, None].astype(np.float64) * cc64
        - ntot * cc64 * cc64
    ) / f0
    want = (3.0 - ntot) * 0.5 * np.log1p(u)
    np.testing.assert_allclose(np.asarray(m), want, rtol=1e-14, equal_nan=False)
