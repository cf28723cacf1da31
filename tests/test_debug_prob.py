"""DEBUG_PROB analogue: per-evaluation logpro dumps + cross-path diffing.

Reference: compiled-in DEBUG_PROB printf of every (iRefMap, iOrient, iConv,
disx, disy, cc, logpro) evaluation (/root/reference/include/defs.h:52,
bioem_algorithm.h:88-128, bioem_cuda.cu:308-313) used to diff the CPU and
GPU paths. Here: two engine layouts (orientation × image blocking) at N=64,
beyond the oracle's reach.
"""

import numpy as np
import pytest

from bioem_tpu.config import RunConfig
from bioem_tpu.core.engine import BioEMEngine
from bioem_tpu.core.orientations import build_orientations
from bioem_tpu.debug_prob import (
    diff_dumps,
    dump_logpro,
    read_dump,
    write_dump,
)

from .conftest import tiny_images, tiny_model, tiny_params


def make_engine(rng, n=16, **cfg_kw):
    p = tiny_params(n_pixels=n, pixel_size=96.0 / n)
    orients = build_orientations(p)
    model = tiny_model(rng)
    images = tiny_images(rng, 2, n)
    cfg_kw.setdefault("orient_block", 2)
    cfg = RunConfig(**cfg_kw)
    return BioEMEngine(p, orients, model, images, cfg)


def logsumexp(x):
    m = x.max()
    return m + np.log(np.exp(x - m).sum())


def test_dump_matches_engine_posterior(rng):
    """Σ over the dump's evaluations must reproduce the engine's streaming
    LSE accumulator exactly (same split-precision values, different
    reduction order)."""
    eng = make_engine(rng)
    state = eng.run()
    lp, cc = dump_logpro(eng, 0)
    assert lp.shape == (eng.n_orient, eng.n_ctf, len(eng.disp), len(eng.disp))
    assert np.isfinite(lp).all()
    want = float(np.log(np.asarray(state.total)[0]) + np.asarray(state.const)[0])
    got = logsumexp(lp)
    # engine block sums run in f32 before the f64 merge → rounding-order
    # differences at the f32 eps scale, not exact equality
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))
    # argmax displacement consistency with the state's best tuple
    o, c, ix, iy = np.unravel_index(np.argmax(lp), lp.shape)
    assert int(np.asarray(state.best_orient)[0]) == o
    assert int(np.asarray(state.best_conv)[0]) == c
    assert int(np.asarray(state.best_cent_x)[0]) == -int(eng.disp[ix])
    assert int(np.asarray(state.best_cent_y)[0]) == -int(eng.disp[iy])


def test_xla_vs_pallas_dump_n64(rng, tmp_path):
    """The production debugging story: diff two dumps at N=64 through the
    text format and the diff tool. The two engines differ in orientation
    and image blocking (3 vs 4 orientations per step, images one at a time
    vs together), so their matmuls run at other shapes; every evaluation
    must agree to f32 rounding."""
    state = rng.bit_generator.state
    eng_a = make_engine(rng, n=64, orient_block=3, image_block=1)
    rng.bit_generator.state = state
    eng_b = make_engine(rng, n=64, orient_block=4, image_block=2)
    assert (eng_a.o_block, eng_a.i_block) != (eng_b.o_block, eng_b.i_block)
    lp_x, cc_x = dump_logpro(eng_a, 1)
    lp_p, cc_p = dump_logpro(eng_b, 1)

    fa, fb = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    write_dump(fa, 1, lp_x, cc_x, eng_a.disp)
    write_dump(fb, 1, lp_p, cc_p, eng_b.disp)
    a, b = read_dump(fa), read_dump(fb)
    assert len(a) == lp_x.size
    dlog, dcc, worst, n_common, only_a, only_b = diff_dumps(a, b)
    assert n_common == lp_x.size and not only_a and not only_b
    # f32 cc rounding ≈ 1e-6 relative of the cc scale; logpro differences
    # amplified by a_coef·d(log1p) stay far under a log-unit.
    assert dcc < 1e-5 * max(1.0, np.abs(cc_x).max())
    assert dlog < 0.05

    from tools.diff_prob_dump import main as diff_main

    assert diff_main([fa, fb, "--atol", "0.05"]) == 0
    # A perturbed dump must fail the diff.
    lp_bad = lp_p.copy()
    lp_bad[0, 0, 0, 0] += 1.0
    write_dump(fb, 1, lp_bad, cc_p, eng_b.disp)
    assert diff_main([fa, fb, "--atol", "0.05"]) == 1


def test_env_gated_cli_dump(rng, monkeypatch, tmp_path):
    """BIOEM_TPU_DEBUG_PROB writes a parseable dump after a CLI run."""
    import os

    from bioem_tpu import cli

    n = 16
    pts = rng.uniform(-6, 6, (8, 3))
    radii = rng.uniform(1.0, 3.0, 8)
    dens = rng.uniform(40, 100, 8)
    with open(tmp_path / "model.txt", "w") as f:
        for k in range(8):
            f.write(
                f"{pts[k, 0]:.4f} {pts[k, 1]:.4f} {pts[k, 2]:.4f} "
                f"{radii[k]:.4f} {dens[k]:.4f}\n"
            )
    maps = rng.normal(0, 1, (1, n, n))
    with open(tmp_path / "particles.txt", "w") as f:
        f.write("PARTICLE 0\n")
        for i in range(n):
            for j in range(n):
                f.write(f"{i:8d}{j:8d}{maps[0, i, j]:16.8f}\n")
    with open(tmp_path / "param.txt", "w") as f:
        f.write(
            "PIXEL_SIZE 1.5\n"
            f"NUMBER_PIXELS {n}\n"
            "GRIDPOINTS_ALPHA 2\n"
            "GRIDPOINTS_BETA 2\n"
            "CTF_B_ENV 2.0 100.0 2\n"
            "CTF_DEFOCUS 0.5 1.5 2\n"
            "CTF_AMPLITUDE 0.1 0.1 1\n"
            "DISPLACE_CENTER 2 1\n"
        )
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BIOEM_TPU_DEBUG_PROB", "0")
    monkeypatch.setenv("BIOEM_TPU_DEBUG_PROB_FILE", "dump0.txt")
    rc = cli.main(
        [
            "--Modelfile", "model.txt", "--Particlesfile", "particles.txt",
            "--Inputfile", "param.txt", "--OutputFile", "out.txt",
        ]
    )
    assert rc == 0
    assert os.path.exists("dump0.txt")
    d = read_dump("dump0.txt")
    assert len(d) > 0
    # Best evaluation in the dump must agree with the written output's
    # maximizing parameters: rebuild the orientation grid from the same
    # parameter file and check the angles printed on the "Maximizing Param"
    # line are those of the dump's argmax orientation (advisor r4: the old
    # `... or out` clause made this assertion vacuous).
    from bioem_tpu.core.orientations import build_orientations
    from bioem_tpu.params import read_parameters

    lps = {k: v[1] for k, v in d.items()}
    best = max(lps, key=lps.get)
    orients = build_orientations(read_parameters("param.txt"))
    want_ang = np.asarray(orients.angles)[best[1], :3]
    with open("out.txt") as f:
        lines = [
            l for l in f
            if l.startswith("RefMap: 0 Maximizing Param:")
        ]
    assert len(lines) == 1
    tok = lines[0].split()
    got_ang = np.array([float(tok[5]), float(tok[7]), float(tok[9])])
    np.testing.assert_allclose(got_ang, want_ang, atol=1e-4)
