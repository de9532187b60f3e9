"""chip_smoke.py's deck, checks and parity helpers at a tiny size on CPU.

The script itself refuses to run without a GPU; its phase functions are
called directly here.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke

TINY = dict(n_cameras=2, image_hw=(48, 64), grid_shape=(21, 17),
            n_frames=4, n_targets=3)
N_NODES = 21 * 17


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny seeded deck, processed in process as upsp-process would."""
    from upsp_tpu.pipeline.config import read_input_deck
    from upsp_tpu.pipeline.run import run_datapoint

    root = tmp_path_factory.mktemp("smoke")
    deck = chip_smoke.make_deck(str(root), TINY)
    cfg = read_input_deck(deck)
    run_datapoint(cfg, registration_telemetry=True,
                  frames_per_chunk=chip_smoke.FRAMES_PER_CHUNK)
    return deck, cfg


def test_deck_has_the_production_inputs(tiny_run):
    deck, cfg = tiny_run
    assert len(cfg.cameras) == 2 and cfg.frames == 4
    assert cfg.target_patcher == "polynomial"
    for cam in cfg.cameras:
        assert os.path.exists(cam.video) and os.path.exists(cam.calibration)
        assert os.path.exists(cam.targets)
        packed_bytes = 4 * 48 * 64 * 3 // 2
        assert os.path.getsize(cam.video) == packed_bytes
    for path in (cfg.grid, cfg.sds, cfg.paint_cal):
        assert os.path.exists(path)


def test_deck_is_seeded(tmp_path):
    a = chip_smoke.make_deck(str(tmp_path / "a"), TINY, seed=3)
    b = chip_smoke.make_deck(str(tmp_path / "b"), TINY, seed=3)
    for name in ("cam01.mraw", "cam02.mraw", "plate.tgts"):
        with open(os.path.join(os.path.dirname(a), name), "rb") as fa, \
                open(os.path.join(os.path.dirname(b), name), "rb") as fb:
            assert fa.read() == fb.read()


def test_check_outputs_accepts_a_run(tiny_run):
    _, cfg = tiny_run
    s = chip_smoke.check_outputs(cfg.out_dir, 4, N_NODES, 2)
    assert s["flat_files"] == 15 and s["covered_frac"] > 0.5


def _corrupt(out_dir, how):
    if how == "missing":
        os.remove(os.path.join(out_dir, "gain"))
    elif how == "truncated":
        with open(os.path.join(out_dir, "pressure_transpose"), "r+b") as fh:
            fh.truncate(16)
    elif how == "nan":
        inten = np.memmap(os.path.join(out_dir, "intensity"), "<f4",
                          mode="r+", shape=(4, N_NODES))
        cov = np.fromfile(os.path.join(out_dir, "coverage"), "<f4")
        inten[2, np.argmax(cov > 0)] = np.nan
        inten.flush()
    elif how == "telemetry":
        with open(os.path.join(out_dir, "registration"), "r+b") as fh:
            fh.truncate(4 * 4 * 2 * 5 - 40)
    elif how == "low_rho":
        tele = np.memmap(os.path.join(out_dir, "registration"), "<f4",
                         mode="r+", shape=(4, 2, 5))
        tele[3, 1, 0] = 0.95
        tele.flush()


@pytest.mark.parametrize(
    "how", ["missing", "truncated", "nan", "telemetry", "low_rho"]
)
def test_check_outputs_rejects(tiny_run, tmp_path, how):
    _, cfg = tiny_run
    out = str(tmp_path / "out")
    shutil.copytree(cfg.out_dir, out)
    _corrupt(out, how)
    with pytest.raises((AssertionError, ValueError)):
        chip_smoke.check_outputs(out, 4, N_NODES, 2)


def test_rel_err():
    ref = np.array([1.0, 2.0, np.nan, 4.0], np.float32)
    got = np.array([1.0, 2.004, np.nan, 4.0], np.float32)
    mx, p99, med = chip_smoke.rel_err(got, ref)
    # over full scale (4.0), not over the entry's own value (2.0)
    assert mx == pytest.approx(1e-3, rel=1e-3) and med == 0.0
    with pytest.raises(AssertionError, match="finite"):
        chip_smoke.rel_err(np.array([1.0, np.nan]), np.array([1.0, 2.0]))


def test_state_on_keeps_static_fields(tiny_run):
    state, _, secs = chip_smoke.load_state(tiny_run[0])
    cpu = jax.devices("cpu")[1]
    moved = state.to_device(cpu)
    assert secs > 0 and moved.n_nodes == state.n_nodes
    assert moved.ref_frames.devices() == {cpu}
    for a, b in zip(moved.patch_ops, state.patch_ops):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.n_clusters == b.n_clusters
            assert isinstance(a.n_clusters, int)


def test_unpack_and_gather_checks(tiny_run):
    deck, cfg = tiny_run
    state, cfg, _ = chip_smoke.load_state(deck)
    packed = chip_smoke.read_packed(cfg, 2)
    assert packed.shape == (2, 2, 48 * 64 * 3 // 2)
    chip_smoke.check_unpack(state, packed)
    chip_smoke.check_gather(state)


def test_parity_runs_both_precisions(tiny_run):
    deck, _ = tiny_run
    state, cfg, _ = chip_smoke.load_state(deck)
    err, split = chip_smoke.parity(state, chip_smoke.read_packed(cfg, 2))
    # on a CPU-only host both sides are the CPU backend; the bfloat16
    # control still rounds its images, so it fails the p99 bound
    assert err["highest"][0] <= chip_smoke.TOL_HIGHEST
    assert err["default"][0] <= chip_smoke.TOL_DEFAULT_MAX
    chip_smoke.check_parity(err)
    assert set(split) == set(err)
    for name, (mx, _, _) in err.items():
        assert max(split[name]) == pytest.approx(mx, rel=1e-6)


def test_patched_nodes(tiny_run):
    deck, _ = tiny_run
    state, _, _ = chip_smoke.load_state(deck)
    chip_smoke.check_patches(state)
    patched = chip_smoke.patched_nodes(state)
    assert patched.shape == (N_NODES,) and patched.dtype == bool
    assert 0 < patched.sum() < N_NODES


def test_check_patches_rejects_an_ill_posed_operator(tiny_run):
    deck, _ = tiny_run
    state, _, _ = chip_smoke.load_state(deck)
    op = state.patch_ops[0]
    state.patch_ops[0] = op._replace(M=op.M * 100.0)
    with pytest.raises(AssertionError, match="well posed"):
        chip_smoke.check_patches(state)


def test_split_max():
    d = np.array([[1.0, 5.0, np.nan], [2.0, 0.5, 3.0]])
    patched = np.array([False, True, False])
    assert chip_smoke.split_max(d, patched) == (5.0, 3.0)
    assert chip_smoke.split_max(d, np.zeros(3, bool)) == (0.0, 5.0)


@pytest.mark.parametrize("bad", ["highest", "default_p99", "bf16_passes"])
def test_check_parity_rejects(bad):
    ok = (0.0, 0.0, 0.0)
    err = {"highest": ok, "default": ok, "bfloat16": (1e-2, 4e-3, 1e-3)}
    chip_smoke.check_parity(err)
    if bad == "highest":
        err["highest"] = (2 * chip_smoke.TOL_HIGHEST, 0.0, 0.0)
    elif bad == "default_p99":
        err["default"] = (1e-3, 2 * chip_smoke.TOL_DEFAULT_P99, 0.0)
    else:
        err["bfloat16"] = (1e-3, 0.5 * chip_smoke.TOL_DEFAULT_P99, 0.0)
    with pytest.raises(AssertionError):
        chip_smoke.check_parity(err)


def test_worst_frames_and_read_packed_by_index(tiny_run):
    _, cfg = tiny_run
    worst = chip_smoke.worst_registered_frames(cfg.out_dir, 2, 2)
    assert len(set(worst)) == 2 and all(0 <= f < 4 for f in worst)
    tele = np.fromfile(os.path.join(cfg.out_dir, "registration"),
                       "<f4").reshape(4, 2, 5)
    assert tele[worst[0], :, 0].min() == tele[..., 0].min()
    both = chip_smoke.read_packed(cfg, [3, 1])
    np.testing.assert_array_equal(both, chip_smoke.read_packed(cfg, 4)[[3, 1]])


@pytest.mark.parametrize("how", ["same", "intensity", "pressure"])
def test_compare_runs(tiny_run, tmp_path, how):
    _, cfg = tiny_run
    out = str(tmp_path / "out")
    shutil.copytree(cfg.out_dir, out)
    if how == "same":
        patched = np.arange(N_NODES) % 7 == 0
        lines = chip_smoke.compare_runs(cfg.out_dir, out, cfg, N_NODES, 2,
                                        patched)
        assert any("worst frames" in ln for ln in lines)
        assert any("patched / other nodes 0.000e+00/0.000e+00" in ln
                   for ln in lines)
        return
    name = "intensity" if how == "intensity" else "pressure_transpose"
    a = np.memmap(os.path.join(out, name), "<f4", mode="r+")
    i = int(np.flatnonzero(np.isfinite(a))[0])
    a[i] += 0.01 * np.nanmax(np.abs(a)) if how == "intensity" else 0.01
    a.flush()
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.compare_runs(cfg.out_dir, out, cfg, N_NODES, 2)


def test_device_json_contract():
    import json

    rec = json.loads(chip_smoke.device_json(jax.devices()[:1]))
    assert rec["ok"] is True
    assert set(rec["device"]) == {"platform", "kind", "count"}
    assert rec["device"]["count"] == 1


def _run_script(cwd, script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env,
    )


def test_script_refuses_without_gpu(tmp_path):
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    r = _run_script(repo, os.path.join(repo, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    src = os.path.abspath(chip_smoke.__file__)
    shutil.copy(src, tmp_path / "chip_smoke.py")
    r = _run_script(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
