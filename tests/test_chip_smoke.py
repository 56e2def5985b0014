"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself runs
them at full size on the GPU and refuses any other device)."""

import json

import numpy as np
import jax
import pytest

import chip_smoke as cs
from portrayer_tpu import flatten_scene


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_a_non_gpu_device(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_mesh_scene_is_castle_sized_and_seeded():
    st = flatten_scene(cs.mesh_scene(seed=1))
    assert st.n_pairs == 4 * 1800
    again = flatten_scene(cs.mesh_scene(seed=1))
    other = flatten_scene(cs.mesh_scene(seed=2))
    np.testing.assert_array_equal(st.tri_a, again.tri_a)
    assert not np.array_equal(st.tri_a, other.tri_a)


def test_compare_hits_rejects_a_missed_hit():
    from portrayer_tpu.ops.intersect import Hit

    t = np.array([1.0, 2.0, np.inf], np.float32)
    ref = Hit(t=t, node=np.array([0, 1, -1]), tri=np.full(3, -1),
              hit=np.isfinite(t))
    got = ref._replace(hit=np.array([True, False, False]))
    with pytest.raises(AssertionError, match="hit/miss"):
        cs.compare_hits(ref, got, "case")
    tie = ref._replace(node=np.array([5, 1, -1]),
                       t=np.array([1.00001, 2.0, np.inf], np.float32))
    assert cs.compare_hits(ref, tie, "case")["node_ties"] == 1
    far = ref._replace(node=np.array([5, 1, -1]),
                       t=np.array([1.5, 2.0, np.inf], np.float32))
    with pytest.raises(AssertionError):
        cs.compare_hits(ref, far, "case")


def test_phase_sweeps_small():
    cs.phase_sweeps(n_rays=256, seed=3)


def test_phase_goldens_small():
    fracs = cs.phase_goldens(names=("single-triangle",))
    assert fracs["single-triangle"] < cs.GOLDEN_FRAC


def test_phase_frame_small(tmp_path):
    out = cs.phase_frame(size=(64, 32), reps=1, out_dir=str(tmp_path))
    assert (tmp_path / "big-scene.png").exists()
    assert out["sweep"] == "beam" and out["primary_mrays_per_s"] > 0
    assert out["not_background_fraction"] > 0.01


def test_phase_fit_and_precision_small():
    fit = cs.phase_fit(res=16, steps=5)
    losses = fit["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    counts = cs.phase_precision(frame_size=(32, 16), fit=fit)
    assert counts == {"frame": 0, "fit_step": 0}


def test_count_dots():
    assert cs.count_dots("%a = f32[4] add(%x, %y)") == 0
    hlo = ('%d = f32[2,2] dot(%a, %b), lhs_contracting_dims={1}\n'
           '%g = custom-call(%a), custom_call_target="__cublas$gemm"')
    assert cs.count_dots(hlo) == 2


def test_phase_four_cards_small():
    assert len(jax.devices()) >= 4
    out = cs.phase_four_cards(n_dev=4, size=(32, 16), fit_res=16)
    assert out["frame_frac"] == 0.0


@pytest.mark.gpu
def test_phase_sweeps_on_gpu(gpu):
    """On the card: the beam sweep against the flat sweep at 4,096 rays."""
    cs.phase_sweeps(n_rays=4096)


def test_last_line_shape(monkeypatch, capsys):
    """main's last line is the one JSON object the contract names."""
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(cs, "phase_device", lambda: "card, 700.00 W")
    monkeypatch.setattr(cs.compile_cache, "enable", lambda: "no cache")
    monkeypatch.setattr(cs.jax, "devices", lambda: [Dev()])
    for name in ("phase_sweeps", "phase_goldens", "phase_frame",
                 "phase_precision", "phase_four_cards"):
        monkeypatch.setattr(cs, name, lambda *a, **k: {})
    monkeypatch.setattr(cs, "phase_fit", lambda *a, **k: {
        "first_step_s": 1.0, "warm_step_s": 0.1})
    cs.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
