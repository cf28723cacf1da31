"""True multi-host execution: 2 jax.distributed processes reproduce the
single-process sharded result exactly.

The JAX analogue of running the reference under ``mpirun -n 2``
(/root/reference/doc/index.rst:1367-1389): two OS processes, each owning 2
emulated CPU devices, form one global 2×2 (img × orient) mesh. Input
dissemination is per-host (every process builds the same inputs from the
seed and materialises only its own device shards via
jax.make_array_from_callback), matching the reference's configure-time
MPI_Bcast (bioem.cpp:453-503); the final collective log-sum-exp crosses the
process boundary (bioem.cpp:909-1044 analogue).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bioem_tpu.config import RunConfig
from bioem_tpu.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_workers(tmp_path, ckpt="", mode=""):
    port = _free_port()
    out = str(tmp_path / "mp_result.npz")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            BIOEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
            BIOEM_TPU_NUM_PROCESSES="2",
            BIOEM_TPU_PROCESS_ID=str(pid),
        )
        # Drop any outer mesh/debug env that would change the worker config.
        for k in list(env):
            if k.startswith("BIOEM_TPU_MESH") or k.startswith("BIOEM_DEBUG"):
                env.pop(k)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, out, ckpt, mode],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        logs.append(stdout)
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, f"worker rc={pr.returncode}\n{log}"
    assert os.path.exists(out), logs[0]
    return np.load(out)


@pytest.fixture(scope="module")
def single_process_ref():
    """The same problem on a 2×2 mesh inside one process (4 of 8 devices)."""
    from tests.mp_worker import build_tiny_problem

    p, orients, model, images = build_tiny_problem()
    mesh = make_bioem_mesh(2, 2)
    cfg = RunConfig(orient_block=2, mesh_images=2, mesh_orient=2)
    eng = ShardedBioEMEngine(p, orients, model, images, cfg, mesh=mesh)
    return eng.results(eng.run())


def test_two_process_run_matches_single(tmp_path, single_process_ref):
    got = _launch_workers(tmp_path)
    ref = single_process_ref
    # Same mesh shape, same shardings, same block order → identical FP math.
    np.testing.assert_array_equal(got["log_prob"], ref.log_prob)
    np.testing.assert_array_equal(got["best_orient"], ref.best_orient)
    np.testing.assert_array_equal(got["best_conv"], ref.best_conv)
    np.testing.assert_array_equal(got["best_cent_x"], ref.best_cent_x)
    np.testing.assert_array_equal(got["best_cent_y"], ref.best_cent_y)
    np.testing.assert_array_equal(got["best_norm"], ref.best_norm)
    np.testing.assert_array_equal(got["angle_log"], ref.angle_log)


def test_two_process_streamed_run(tmp_path, single_process_ref):
    """Streamed × sharded × multi-host (the BASELINE-config-5 control path):
    2 image chunks streamed through the global 2×2 mesh by 2 processes with
    per-host ingest must match the single-process non-streamed run exactly.
    Reference analogue: every MPI rank chunks its own images through its GPU
    (map.cpp:549 + bioem.cpp:748-753)."""
    got = _launch_workers(tmp_path, mode="stream")
    ref = single_process_ref
    np.testing.assert_array_equal(got["log_prob"], ref.log_prob)
    np.testing.assert_array_equal(got["best_orient"], ref.best_orient)
    np.testing.assert_array_equal(got["best_conv"], ref.best_conv)
    np.testing.assert_array_equal(got["best_cent_x"], ref.best_cent_x)
    np.testing.assert_array_equal(got["best_norm"], ref.best_norm)
    np.testing.assert_array_equal(got["angle_log"], ref.angle_log)


def test_two_process_checkpointed_run(tmp_path, single_process_ref):
    """Chunked multi-host run with process-0 checkpointing matches too."""
    ckpt = str(tmp_path / "mh_ckpt.npz")
    got = _launch_workers(tmp_path, ckpt=ckpt)
    ref = single_process_ref
    np.testing.assert_allclose(got["log_prob"], ref.log_prob, rtol=1e-12)
    np.testing.assert_array_equal(got["best_orient"], ref.best_orient)
    assert os.path.exists(ckpt)  # process 0 wrote checkpoints


def _write_cli_inputs(d):
    """Tiny deterministic reference-format inputs (text model + PARTICLE
    file + keyword file) shared by all CLI processes."""
    rng = np.random.default_rng(77)
    n = 16
    pts = rng.uniform(-6, 6, (10, 3))
    radii = rng.uniform(1.0, 3.0, 10)
    dens = rng.uniform(40, 100, 10)
    with open(d / "model.txt", "w") as f:
        for k in range(10):
            f.write(
                f"{pts[k,0]:.4f} {pts[k,1]:.4f} {pts[k,2]:.4f} "
                f"{radii[k]:.4f} {dens[k]:.4f}\n"
            )
    maps = rng.normal(0, 1, (3, n, n))
    with open(d / "particles.txt", "w") as f:
        for m in range(maps.shape[0]):
            f.write(f"PARTICLE {m}\n")
            for i in range(n):
                for j in range(n):
                    f.write(f"{i:8d}{j:8d}{maps[m,i,j]:16.8f}\n")
    with open(d / "param.txt", "w") as f:
        f.write(
            "PIXEL_SIZE 1.5\n"
            f"NUMBER_PIXELS {n}\n"
            "GRIDPOINTS_ALPHA 2\n"
            "GRIDPOINTS_BETA 2\n"
            "CTF_B_ENV 2.0 100.0 2\n"
            "CTF_DEFOCUS 0.5 1.5 2\n"
            "CTF_AMPLITUDE 0.1 0.1 1\n"
            "DISPLACE_CENTER 2 1\n"
            "WRITE_PROB_ANGLES 2\n"
        )


def _run_cli(cwd, env_extra, n_local_devices):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("BIOEM_TPU") or k.startswith("BIOEM_DEBUG"):
            env.pop(k)
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_COMPILATION_CACHE="false",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n_local_devices}",
        BIOEM_TPU_ORIENT_BLOCK="2",
        BIOEM_TPU_MESH_IMAGES="2",
        BIOEM_TPU_MESH_ORIENT="2",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    env.update(env_extra)
    return subprocess.Popen(
        [
            sys.executable, "-m", "bioem_tpu.cli",
            "--Modelfile", "model.txt",
            "--Particlesfile", "particles.txt",
            "--Inputfile", "param.txt",
        ],
        cwd=str(cwd),
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )


def test_cli_two_process_matches_single(tmp_path):
    """The unmodified CLI works under the 2-process harness (round-2 gap:
    cli.main never called distributed.initialize — the reference's main()
    does MPI_Init unconditionally, /root/reference/main.cpp:64-68). The
    2-process 2×2-mesh output files must match a single-process 2×2-mesh
    run byte-for-byte (identical shardings → identical FP math)."""
    ref_dir = tmp_path / "single"
    mh_dir = tmp_path / "multi"
    ref_dir.mkdir()
    mh_dir.mkdir()
    _write_cli_inputs(ref_dir)
    _write_cli_inputs(mh_dir)

    pr = _run_cli(ref_dir, {}, 4)
    out, _ = pr.communicate(timeout=600)
    assert pr.returncode == 0, out

    port = _free_port()
    procs = [
        _run_cli(
            mh_dir,
            {
                "BIOEM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "BIOEM_TPU_NUM_PROCESSES": "2",
                "BIOEM_TPU_PROCESS_ID": str(pid),
            },
            2,
        )
        for pid in range(2)
    ]
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        logs.append(stdout)
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, f"cli worker rc={pr.returncode}\n{log}"

    ref_out = (ref_dir / "Output_Probabilities").read_text()
    mh_out = (mh_dir / "Output_Probabilities").read_text()
    assert "RefMap: 0 LogProb:" in ref_out
    assert mh_out == ref_out
    assert (mh_dir / "ANG_PROB").read_text() == (ref_dir / "ANG_PROB").read_text()
