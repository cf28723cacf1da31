"""SO(3) list generator, multi-model ranking, rotated-model printing."""

import io

import numpy as np

from bioem_tpu.config import RunConfig
from bioem_tpu.core.orientations import build_orientations, read_orientation_file
from bioem_tpu.rank import format_ranking, rank_models
from bioem_tpu.utils.so3 import make_quaternion_list, super_fibonacci

from .conftest import tiny_images, tiny_model, tiny_params


def test_super_fibonacci_unit_and_uniform():
    q = super_fibonacci(576)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-12)
    # Uniformity proxy: mean of each component ~0, no duplicate rows.
    assert np.abs(q.mean(axis=0)).max() < 0.08
    assert np.unique(q.round(9), axis=0).shape[0] == 576


def test_quaternion_list_roundtrip(tmp_path):
    """Generated list parses through the reference fixed-width reader."""
    path = str(tmp_path / "quat576.txt")
    q = make_quaternion_list(path, 64)
    p = tiny_params(use_quaternions=True, grid_points_quaternion=1)
    p.not_uniform_angles = True
    oset = read_orientation_file(p, path)
    assert oset.n == 64
    np.testing.assert_allclose(oset.angles, q.astype(np.float32), atol=1e-6)


def test_rank_models_prefers_generating_model(rng):
    """Images synthesised from model A must rank A above a decoy B."""
    from bioem_tpu.core.engine import BioEMEngine
    from bioem_tpu.io.map_io import ImageStack
    from tests.oracle.oracle import project, rotmat_euler

    p = tiny_params(grid_points_alpha=2, grid_points_beta=2)
    model_a = tiny_model(rng)
    model_b = tiny_model(np.random.default_rng(999), spread=3.0)
    orients = build_orientations(p)

    # Forward-simulate particles from model A at grid orientations.
    ma = model_a.center_density_mass()
    maps = []
    for k in (0, 3):
        proj = project(
            p, ma.points.astype(np.float64), ma.radii, ma.densities,
            ma.norm_den, rotmat_euler(*orients.angles[k][:3]),
        )
        maps.append(proj + rng.normal(0, 0.05 * np.abs(proj).max(), proj.shape))
    stack = np.stack(maps).astype(np.float32)
    # normalise like MRC ingest
    flat = stack.reshape(len(stack), -1).astype(np.float64)
    mean, sig = flat.mean(1), np.sqrt((flat**2).mean(1) - flat.mean(1) ** 2)
    stack = ((stack - mean[:, None, None]) / sig[:, None, None]).astype(np.float32)
    images = ImageStack(stack)

    total, per_image, _perf = rank_models(
        p, orients, [model_a, model_b], images, RunConfig(orient_block=2)
    )
    assert total[0] > total[1], (total, per_image)
    report = format_ranking(total, per_image, ["A", "B"])
    assert report.index("#1 A") < report.index("#2 B")


def test_write_rotated_models(rng):
    from bioem_tpu.cli import write_rotated_models

    p = tiny_params()
    model = tiny_model(rng, n_points=3)
    orients = build_orientations(p)
    buf = io.StringIO()
    write_rotated_models(model, orients, buf)
    lines = buf.getvalue().splitlines()
    assert len(lines) == orients.n * 3
    assert lines[0].startswith("ROTATED 0 0 ")
    # Rotation preserves radii from origin.
    first = np.array([float(x) for x in lines[0].split()[3:]])
    np.testing.assert_allclose(
        np.linalg.norm(first), np.linalg.norm(model.points[0]), rtol=1e-5
    )


def test_trace_step_reduces_a_gpu_trace():
    """tools/trace_step.py's reduction on a small GPU trace: kernels match
    their HLO instruction by hlo_op stat or (inside a CUDA graph) by kernel
    name, layers come from the named scope in op_name, and the idle share
    is the gap share of the first-to-last kernel window."""
    from jax.profiler import ProfileData

    from tools.trace_step import hlo_op_names, reduce_trace

    hlo = "\n".join([
        '  %input_transpose_fusion.2 = f32[8] fusion(%a), kind=kInput, '
        'metadata={op_name="jit(_run_scan)/while/body/cc_product/sub"}',
        '  %custom-call.13 = f32[8] custom-call(%b), '
        'metadata={op_name="jit(_run_scan)/while/body/cc_stage1/dot_general"}',
        '  ROOT %loop_add_fusion = f32[8] fusion(%c), kind=kLoop, '
        'metadata={op_name="jit(_run_scan)/while/body/merge/add"}',
    ])
    trace = ProfileData.from_text_proto('''
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 3000000
             stats { metadata_id: 1 str_value: "command_buffer" } }
    events { metadata_id: 2 offset_ps: 4000000 duration_ps: 1000000
             stats { metadata_id: 1 str_value: "custom-call.13" } }
    events { metadata_id: 3 offset_ps: 4500000 duration_ps: 1000000
             stats { metadata_id: 1 str_value: "loop_add_fusion" } }
    events { metadata_id: 4 offset_ps: 6000000 duration_ps: 500000 }
  }
  event_metadata { key: 1 value { id: 1 name: "input_transpose_fusion_2" } }
  event_metadata { key: 2 value { id: 2 name: "sm90_xmma_gemm" } }
  event_metadata { key: 3 value { id: 3 name: "loop_add_fusion" } }
  event_metadata { key: 4 value { id: 4 name: "Memset" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } }
}
planes { id: 2 name: "/host:CPU" }
''')
    rep = reduce_trace(trace, hlo_op_names(hlo))
    assert rep["plane"] == "/device:GPU:0"
    assert rep["layers_ns"] == {
        "cc_product": 3000.0, "cc_stage1": 1000.0, "merge": 1000.0,
        "other": 500.0,
    }
    assert rep["kernel_ns"] == 5500.0
    # Window 1000..7500 ns; busy [1000,4000] ∪ [5000,6500] ∪ [7000,7500].
    assert rep["window_ns"] == 6500.0 and rep["busy_ns"] == 5000.0
    assert abs(rep["idle_share"] - 1500.0 / 6500.0) < 1e-12
    assert [r["op"] for r in rep["ops"]][:2] == [
        "input_transpose_fusion_2", "custom-call.13"]


def test_bench_refuses_to_measure_without_gpu():
    """bench.py's numbers are device metrics: on the CPU it stops before
    measuring anything."""
    import pytest

    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.device_identity()
