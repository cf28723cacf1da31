"""chip_smoke.py on the CPU: it must refuse to pass without a GPU, its
comparators must reject wrong results, and its problem plumbing must run at
a small size (the card runs it at full size)."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_fails_without_gpu(argv, capsys):
    rc = chip_smoke.main(argv)
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert "PHASE device: FAIL" in out


def _golden_text(case, name="Output_Probabilities.f64.golden"):
    with open(os.path.join(DATA, case, name)) as f:
        return f.read()


def _shift_logprobs(text, delta):
    out = []
    for line in text.splitlines(keepends=True):
        if line.startswith("RefMap:") and "LogProb:" in line:
            head, rest = line.split("LogProb:", 1)
            val, tail = rest.split(None, 1)
            line = f"{head}LogProb: {float(val) + delta:.4f} {tail}"
        out.append(line)
    return "".join(out)


def test_golden_comparator_rejects_shifted_golden():
    golden = _golden_text("case_a_euler_ctf")
    assert chip_smoke.check_golden("a", golden, golden, 2e-3, 3, True) == 0.0
    shifted = _shift_logprobs(golden, 1e-2)
    assert shifted != golden
    with pytest.raises(AssertionError, match="max"):
        chip_smoke.check_golden("a", shifted, golden, 2e-3, 3, True)


def _results(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        log_prob=rng.normal(-5e4, 10.0, n),
        best_orient=rng.integers(0, 100, n),
        best_conv=rng.integers(0, 8, n),
        best_cent_x=rng.integers(-10, 10, n),
        best_cent_y=rng.integers(-10, 10, n),
    )


def test_sharded_comparator_rejects_flipped_argmax():
    ref = _results()
    same = _results()
    assert chip_smoke.check_sharded(same, ref, "same") == 0.0
    flipped = _results()
    flipped.best_orient[2] += 1
    with pytest.raises(AssertionError, match="best_orient"):
        chip_smoke.check_sharded(flipped, ref, "flipped")
    moved = _results()
    moved.best_cent_y[0] = -moved.best_cent_y[0] + 1
    with pytest.raises(AssertionError, match="best_cent_y"):
        chip_smoke.check_sharded(moved, ref, "moved")
    off = _results()
    off.log_prob[1] += 1.0  # 1 log-unit ≫ 1e-6 × 5e4
    with pytest.raises(AssertionError, match="log P"):
        chip_smoke.check_sharded(off, ref, "off")


def test_planted_comparator_rejects_wrong_argmax():
    truth = {"orient": 3, "conv": 1, "dx": 4, "dy": -6}
    res = SimpleNamespace(
        best_orient=np.array([3, 0]), best_conv=np.array([1, 0]),
        best_cent_x=np.array([4, 0]), best_cent_y=np.array([-6, 0]),
        log_prob=np.array([-1000.0, -5000.0]),
    )
    assert chip_smoke.check_planted(res, truth) == 4000.0
    res.best_orient[0] = 4
    with pytest.raises(AssertionError, match="planted argmax"):
        chip_smoke.check_planted(res, truth)
    res.best_orient[0] = 3
    res.log_prob[1] = -1050.0  # noise too close to the planted particle
    with pytest.raises(AssertionError, match="noise"):
        chip_smoke.check_planted(res, truth)


def test_e2e_phase_small(tmp_path, monkeypatch, capsys):
    """The e2e phase's file writing, CLI run and API re-run at N=32."""
    monkeypatch.chdir(tmp_path)
    chip_smoke.phase_e2e(n_pixels=32, quat_grid=2, n_img=3, card="cpu")
    out = capsys.readouterr().out
    assert "Output_Probabilities: 3 finite LogProb lines" in out
    assert "memory_analysis" in out
    assert os.listdir(tmp_path) == []  # worked in its own temporary dir


def test_four_phase_on_virtual_devices():
    """The --four phase's meshes on four of the suite's virtual CPU
    devices, at a small size."""
    chip_smoke.phase_four(n_pixels=32, quat_grid=2, n_img=4)


def test_last_line_is_the_json_contract(monkeypatch, capsys):
    """With every phase passing, the last line is exactly the JSON object
    the contract names."""
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: info)
    monkeypatch.setattr(chip_smoke, "card_name_and_power", lambda: "H100, 700 W")
    for name in ("phase_golden", "phase_planted", "phase_e2e"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": info}
