"""Sharded run == single-device run, on the emulated 8-device CPU mesh.

The JAX answer to the reference's "multi-node testing without a cluster"
(mpirun on one box, doc/index.rst:1367-1389).
"""

import jax
import numpy as np
import pytest

from bioem_tpu.config import RunConfig
from bioem_tpu.core.engine import BioEMEngine
from bioem_tpu.core.orientations import build_orientations
from bioem_tpu.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh
from tests.conftest import tiny_images, tiny_model, tiny_params


@pytest.fixture
def problem(rng):
    p = tiny_params(write_angles=3)
    orients = build_orientations(p)
    model = tiny_model(rng)
    images = tiny_images(rng, 5, p.n_pixels)
    return p, orients, model, images


def _single(p, orients, model, images):
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=2))
    return eng.results(eng.run())


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_sharded_matches_single(problem, mesh_shape):
    p, orients, model, images = problem
    ref = _single(p, orients, model, images)

    mi, mo = mesh_shape
    cfg = RunConfig(orient_block=2, mesh_images=mi, mesh_orient=mo)
    eng = ShardedBioEMEngine(p, orients, model, images, cfg)
    res = eng.results(eng.run())

    np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res.best_orient, ref.best_orient)
    np.testing.assert_array_equal(res.best_conv, ref.best_conv)
    np.testing.assert_array_equal(res.best_cent_x, ref.best_cent_x)
    np.testing.assert_array_equal(res.best_cent_y, ref.best_cent_y)
    np.testing.assert_allclose(res.best_norm, ref.best_norm, rtol=1e-5)
    np.testing.assert_allclose(res.angle_log, ref.angle_log, rtol=0, atol=1e-5)


def test_mesh_needs_enough_devices(problem):
    with pytest.raises(ValueError):
        make_bioem_mesh(16, 16)


def test_sharded_checkpoint_resume(rng, tmp_path):
    """Chunked+checkpointed sharded run == plain sharded run, incl. resume."""
    import numpy as np

    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.orientations import build_orientations
    from bioem_tpu.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh
    from .conftest import tiny_images, tiny_model, tiny_params

    p = tiny_params(write_angles=2)
    model = tiny_model(rng)
    images = tiny_images(rng, 4, p.n_pixels)
    orients = build_orientations(p)
    mesh = make_bioem_mesh(2, 2)

    cfg0 = RunConfig(orient_block=1, mesh_images=2, mesh_orient=2)
    e0 = ShardedBioEMEngine(p, orients, model, images, cfg0, mesh=mesh)
    ref = e0.results(e0.run())

    ckpt = str(tmp_path / "shard.npz")
    cfg1 = RunConfig(
        orient_block=1, mesh_images=2, mesh_orient=2,
        checkpoint_path=ckpt, checkpoint_every=1,
    )
    e1 = ShardedBioEMEngine(p, orients, model, images, cfg1, mesh=mesh)
    r1 = e1.results(e1.run())
    np.testing.assert_allclose(r1.log_prob, ref.log_prob, rtol=1e-12)
    np.testing.assert_allclose(r1.angle_log, ref.angle_log, rtol=1e-10)

    from bioem_tpu.runtime.checkpoint import save_checkpoint

    # Run the first chunk only, checkpoint, then resume with a new engine.
    # Exercises the host round-trip of the pre-merge stacked state.
    e2 = ShardedBioEMEngine(p, orients, model, images, cfg1, mesh=mesh)
    st = e2._initial_stacked_state()
    ang, off, msk, loff = e2._chunks[0]
    st = e2._chunk_run(st, e2.banks, ang, off, msk, loff)
    from bioem_tpu.core.posterior import PosteriorState

    host = PosteriorState(*(np.asarray(v) if v is not None else None for v in st))
    save_checkpoint(ckpt, host, 1, e2._fingerprint)

    e3 = ShardedBioEMEngine(p, orients, model, images, cfg1, mesh=mesh)
    r3 = e3.results(e3.run())
    np.testing.assert_allclose(r3.log_prob, ref.log_prob, rtol=1e-12)
    np.testing.assert_array_equal(r3.best_orient, ref.best_orient)


@pytest.mark.parametrize("mesh_shape,image_block", [
    ((2, 2), 1), ((2, 2), 2), ((2, 4), 1), ((1, 4), 2),
])
def test_sharded_pallas_matches_single(problem, mesh_shape, image_block):
    """Mesh × image blocking: with image_block below each shard's image
    count the block step's lax.map over image blocks runs under shard_map,
    including padded image lanes, and must reproduce the single-device
    run."""
    p, orients, model, images = problem
    ref = _single(p, orients, model, images)

    mi, mo = mesh_shape
    cfg = RunConfig(
        orient_block=2, mesh_images=mi, mesh_orient=mo, image_block=image_block,
    )
    eng = ShardedBioEMEngine(p, orients, model, images, cfg)
    n_local = eng.n_img_pad // mi
    assert eng.i_block < n_local and n_local % eng.i_block == 0
    res = eng.results(eng.run())

    np.testing.assert_allclose(res.log_prob, ref.log_prob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res.best_orient, ref.best_orient)
    np.testing.assert_array_equal(res.best_cent_x, ref.best_cent_x)
    np.testing.assert_array_equal(res.best_cent_y, ref.best_cent_y)
    np.testing.assert_allclose(res.angle_log, ref.angle_log, rtol=0, atol=1e-5)
