"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself runs
them at full size on a GPU), its refusal of any other platform, and the
full-width kernel check on the card (``gpu`` marker)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_KERNELS = dict(nms_hw=(128, 128), nms_batch=6, nms_checked=3,
                    target_hw=(128, 256), target_batch=5,
                    gt_counts=(0, 1, 7, 16, 50), n_timed=1)
TINY_INFER = dict(hw=(128, 128), batch=2, serve_hw=(128, 256),
                  precision_batch=2, n_timed=1)


def test_phase_device_reports_jax_device():
    got = chip_smoke.phase_device()
    dev = jax.devices()[0]
    assert got == {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}


def test_phase_kernels_match_oracles():
    got = chip_smoke.phase_kernels(**TINY_KERNELS)
    assert got["nms_ms"] > 0 and got["target_ms"] > 0


def test_synthetic_detections_need_suppression():
    """The NMS input has overlapping same-class clusters and stays under
    K=400 valid rows per image, so the oracle comparison covers real
    suppression without the top-K truncation deviation."""
    anchors = _anchors((512, 512))
    cls_prob, loc = chip_smoke.synthetic_detections(anchors, 4)
    assert cls_prob.shape == (4, chip_smoke.NUM_CLASSES + 1, anchors.shape[0])
    np.testing.assert_allclose(cls_prob.sum(1), 1.0, rtol=1e-5)
    valid = (cls_prob[:, 1:].max(1) >= 0.01).sum(1)
    assert (valid > 100).all() and (valid <= 400).all(), valid


def _anchors(hw):
    from dspnet_tpu.api import create_model

    return create_model(chip_smoke.NETWORK, hw).anchors


def test_synthetic_labels_pad_after_valid_rows():
    labels = chip_smoke.synthetic_labels(6, (0, 1, 7), num_labels=20)
    counts = [int((labels[b, :, 0] >= 0).sum()) for b in range(6)]
    assert counts == [0, 1, 7, 0, 1, 7]
    for b, n in enumerate(counts):
        assert (labels[b, n:] == -1).all()
        boxes = labels[b, :n, 1:5]
        assert ((boxes >= 0) & (boxes <= 1)).all()
        assert (boxes[:, 2:] > boxes[:, :2]).all()


def test_phase_infer_checks_outputs():
    got = chip_smoke.phase_infer(**TINY_INFER)
    assert got["infer_ms"] > 0 and got["serve_ms"] > 0


def test_phase_train_steps():
    got = chip_smoke.phase_train(hw=(128, 256), batch=2, steps=2)
    assert got["train_ms"] > 0


def test_phase_four_matches_one_device():
    """data=4 and data=2 x model=2 meshes of virtual CPU devices against
    one device, within the noise floor of a permuted batch."""
    assert len(jax.devices()) >= 4
    got = chip_smoke.phase_four(hw=(128, 256), global_batch=8,
                                per_device_bf16=1, n_timed=1)
    assert got["four_bf16_ms"] > 0


def test_compare_step_catches_a_wrong_gradient():
    """A mesh whose update is off by a factor (a dropped shard) fails the
    leaf comparison even though the noise floor is wide."""
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(50).astype(np.float32)}
    mom = {"w": rng.randn(50).astype(np.float32) * 1e-3}
    stats = {"bn": {"mean": rng.randn(5).astype(np.float32) * 1e-3,
                    "var": (0.9 + 0.1 * rng.rand(5)).astype(np.float32)}}
    noise = {"w": mom["w"] * (1 + 1e-3 * rng.randn(50)).astype(np.float32)}
    one = (1.0, p, (p, mom, stats))
    permuted = (1.0, p, (p, noise, stats))
    chip_smoke._compare_step("same", one, permuted, one)
    wrong = {"w": mom["w"] * 0.75}
    with pytest.raises(AssertionError, match="first update"):
        chip_smoke._compare_step("dropped shard", one, permuted,
                                 (1.0, p, (p, wrong, stats)))
    with pytest.raises(AssertionError, match="loss"):
        chip_smoke._compare_step("loss", one, permuted,
                                 (1.01, p, (p, mom, stats)))


def test_compare_step_scales_bn_means_by_their_activations():
    """A running mean of normalised activations cancels: a shift at float32
    rounding of the activations' RMS passes though it is large next to the
    mean itself, and a shift like per-shard statistics' does not."""
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(50).astype(np.float32)}
    mom = {"w": rng.randn(50).astype(np.float32) * 1e-3}
    # batch E[x^2] ~ 1 per channel, batch mean ~ 1e-3 of it
    mean = (0.1 * 1e-3 * rng.randn(8)).astype(np.float32)
    stats = {"bn": {"mean": mean, "var": np.full(8, 1.0, np.float32)}}
    one = (1.0, p, (p, mom, stats))

    def shifted(d):
        return (1.0, p, (p, mom, {"bn": {"mean": mean + np.float32(d),
                                         "var": stats["bn"]["var"]}}))

    rounding = 0.1 * 4e-7  # ~6 float32 ulps of an O(1) sum, times 1 - m
    assert rounding > 1e-4 * np.abs(mean).max()
    chip_smoke._compare_step("reordered sums", one, one, shifted(rounding))
    with pytest.raises(AssertionError, match="batch_stats"):
        chip_smoke._compare_step("per-shard stats", one, one, shifted(0.1 * 1e-3))


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(capsys, argv):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "needs a GPU" in out.err


def test_phases_run_without_flax_cv2_orbax(tmp_path):
    """The main path needs none of the optional packages: with modules
    named flax, cv2 and orbax that raise ImportError first on the path,
    the phases still import and run."""
    for name in ("flax", "cv2", "orbax"):
        (tmp_path / f"{name}.py").write_text(
            f"raise ImportError('{name} is not installed')\n")
    code = (
        "import chip_smoke as cs\n"
        "print(cs.phase_device())\n"
        f"cs.phase_kernels(**{TINY_KERNELS!r})\n"
        f"cs.phase_infer(**{TINY_INFER!r})\n"
        # the solver and the mesh (phase_train's modules and more)
        "cs.phase_four(hw=(128, 256), global_batch=4, per_device_bf16=1,"
        " n_timed=1)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'flax': False, 'cv2': False, 'orbax.checkpoint': False" in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    """Copied into a directory without the rest of the repo, the script
    fails and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.gpu
def test_kernels_match_oracles_at_full_width_on_gpu(gpu):
    chip_smoke.phase_kernels(n_timed=1)
