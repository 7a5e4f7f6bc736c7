"""App-shell tests: the CLI surface end to end (render both backends, error
paths with the reference's message/exit-code surface, animate, fit)."""

import os

import numpy as np
import pytest

from tpu_ray_tracer.cli import main

from conftest import scene_path


def test_render_numpy_backend(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    rc = main(["render", scene_path("quadratic"), "--backend", "numpy",
               "--size", "32", "24", "-o", out])
    assert rc == 0
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert "Wrote" in capsys.readouterr().out


def test_render_jax_backend_npy(tmp_path):
    out = str(tmp_path / "img.npy")
    rc = main(["render", scene_path("quadratic"), "--size", "32", "24",
               "-o", out])
    assert rc == 0
    img = np.load(out)
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


def test_render_missing_scene(capsys):
    rc = main(["render", "/nonexistent/scene.yml"])
    assert rc == 1
    err = capsys.readouterr().err
    # reference error surface (src/ray-tracer.cpp:151-158)
    assert "Error during scene loading" in err
    assert "Cannot read the file" in err


def test_render_invalid_scene(tmp_path, capsys):
    path = tmp_path / "bad.yml"
    path.write_text("width: 5\nheight: 5\nobjects: []\nlight_sources: []\n")
    rc = main(["render", str(path)])
    assert rc == 1
    assert "Value 'fov' undefined" in capsys.readouterr().err


def test_animate_writes_frames(tmp_path):
    prefix = str(tmp_path / "fr_")
    rc = main(["animate", scene_path("quadratic"), "--backend", "numpy",
               "--size", "24", "16", "--frames", "2", "--prefix", prefix])
    assert rc == 0
    assert os.path.exists(prefix + "0000.png")
    assert os.path.exists(prefix + "0001.png")


def test_fit_self_recovery(tmp_path, capsys):
    rc = main(["fit", scene_path("cayley"), "--size", "24", "16",
               "--steps", "8", "--lr", "0.05"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loss:" in out

def test_bench_xla_backend_inj_jit_frames(capsys):
    # frames inside one jitted lax.map
    rc = main(["bench", scene_path("quadratic"), "--size", "32", "24",
               "--frames", "2", "--backend", "jax"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend xla" in out
    assert "Mrays/s" in out
    assert "in-jit frames" in out


def test_bench_pallas_backend_reachable(capsys):
    # --backend pallas reaches the route chooser, which refuses the GPU
    # kernel on a CPU host instead of falling back to the interpreter
    rc = main(["bench", scene_path("quadratic"), "--size", "32", "16",
               "--frames", "2", "--backend", "pallas"])
    assert rc == 2
    assert "needs a GPU" in capsys.readouterr().err


def test_bench_numpy_backend(capsys):
    rc = main(["bench", scene_path("quadratic"), "--size", "24", "16",
               "--frames", "2", "--backend", "numpy"])
    assert rc == 0
    assert "backend numpy" in capsys.readouterr().out


def test_fit_backend_wiring(monkeypatch, capsys):
    # fit differentiates the render, so only the XLA route serves it: auto
    # and jax run (hard and soft-visibility losses); pallas is refused
    # before any problem is built, as numpy is
    from tpu_ray_tracer.diff import inverse as inv

    built = []
    real_problem = inv.InverseProblem

    def spy(**kwargs):
        built.append(kwargs)
        return real_problem(**kwargs)

    # cmd_fit imports InverseProblem locally; patch at the source module
    monkeypatch.setattr(inv, "InverseProblem", spy)
    assert main(["fit", scene_path("quadratic"), "--size", "12", "8",
                 "--steps", "1"]) == 0
    assert main(["fit", scene_path("quadratic"), "--size", "12", "8",
                 "--steps", "1", "--backend", "jax", "--soft-tau", "0.2",
                 "--params", "coefs"]) == 0
    assert len(built) == 2 and built[1]["soft_tau"] == 0.2
    assert main(["fit", scene_path("quadratic"), "--size", "12", "8",
                 "--steps", "1", "--backend", "pallas"]) == 2
    assert len(built) == 2
    assert "forward only" in capsys.readouterr().err


def test_fit_rejects_numpy_backend(capsys):
    # --backend numpy has no differentiable path; fit must reject it with a
    # clear error instead of silently remapping to auto
    rc = main(["fit", scene_path("quadratic"), "--size", "12", "8",
               "--steps", "1", "--backend", "numpy"])
    assert rc == 2
    assert "not differentiable" in capsys.readouterr().err


def test_view_resolution_independent_of_view_size(capsys, monkeypatch):
    # reference: render at scene resolution regardless of window size
    # (src/ray-tracer.cpp:160-169, 209-214); --size only scales the display
    import tpu_ray_tracer.cli as cli
    from tpu_ray_tracer.render import reference_cpu

    seen = {}
    real = reference_cpu.render_image_np

    def spy(scene, **kwargs):
        seen["render_wh"] = (scene.width, scene.height)
        return real(scene, **kwargs)

    monkeypatch.setattr(reference_cpu, "render_image_np", spy)
    rc = main(["view", scene_path("quadratic"), "--backend", "numpy",
               "--size", "20", "10", "--render-size", "32", "24"])
    assert rc == 0
    assert seen["render_wh"] == (32, 24)  # NOT the 20x10 view size
    out = capsys.readouterr().out
    # non-TTY fallback prints one ANSI frame at the VIEW cell size
    assert out.count("\n") == 10 // 2  # half-block rows


def test_downsample_for_view():
    from tpu_ray_tracer.utils.term_view import downsample_for_view

    img = np.arange(24 * 32 * 3, dtype=np.float32).reshape(24, 32, 3) / 2304
    out = downsample_for_view(img, 16, 12)  # integer 2x2 boxes -> area mean
    assert out.shape == (12, 16, 3)
    assert np.allclose(out[0, 0], img[:2, :2].mean(axis=(0, 1)))
    out2 = downsample_for_view(img, 13, 7)  # non-integer -> nearest
    assert out2.shape == (7, 13, 3)
    assert downsample_for_view(img, 32, 24) is img
