"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
corpus builder plants where it says (checked through the host route)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from monkey_moore_tpu.config import SearchConfig  # noqa: E402
from monkey_moore_tpu.engine import SearchEngine  # noqa: E402

TINY = 400_000
CHUNK = 131_072
TILE = 1024

ONE_CARD = chip_smoke.one_card_specs()
ONE_CARD_SPECS = ONE_CARD[0] + ONE_CARD[1]
MESH_SPECS = chip_smoke.mesh_specs()


def _run(cwd: Path, script: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


class TestRefusesWithoutGpu:
    def test_cpu_exits_nonzero_without_ok_line(self):
        r = _run(REPO, REPO / "chip_smoke.py")
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_alone_outside_checkout(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        r = _run(tmp_path, tmp_path / "chip_smoke.py")
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_cpu_backend_refused_even_with_a_card(self, monkeypatch, capsys):
        """JAX falling back to the CPU (a broken CUDA plugin) must fail the
        smoke even when nvidia-smi answers."""
        import bench

        monkeypatch.setattr(bench, "card_line", lambda: "Fake GPU, 700 W")
        assert chip_smoke.main([]) != 0
        out = capsys.readouterr()
        assert '"ok"' not in out.out
        assert "not a GPU" in out.err


def _plants_check(spec, path, plan, size):
    """Plants are where the plan says, and the host route finds them."""
    raw = np.fromfile(path, dtype=np.uint8)
    for off in plan[spec.name]:
        assert raw[off : off + len(spec.planted)].tobytes() == spec.planted
    eng = SearchEngine(SearchConfig(
        file_path=path, host_latency_threshold_bytes=size, **spec.config
    ))
    results = eng.run()
    assert eng.last_stats.host_routed
    chip_smoke.check_plants(spec, eng.compile(), path, size, plan, results)


def _corpus(tmp_path_factory, specs, name):
    plan = chip_smoke.plan_plants(specs, TINY, CHUNK, TILE)
    path = tmp_path_factory.mktemp("smoke") / name
    chip_smoke.build_corpus(path, TINY, 7, specs, plan)
    return path, plan


@pytest.fixture(scope="module")
def one_card_corpus(tmp_path_factory):
    return _corpus(tmp_path_factory, ONE_CARD_SPECS, "one_card.bin")


@pytest.fixture(scope="module")
def mesh_corpus(tmp_path_factory):
    return _corpus(tmp_path_factory, MESH_SPECS, "mesh.bin")


class TestCorpusBuilder:
    @pytest.mark.parametrize(
        "spec", ONE_CARD_SPECS, ids=[s.name for s in ONE_CARD_SPECS]
    )
    def test_one_card_plants_found_on_host_route(self, spec, one_card_corpus):
        path, plan = one_card_corpus
        _plants_check(spec, path, plan, TINY)

    @pytest.mark.parametrize(
        "spec", MESH_SPECS, ids=[s.name for s in MESH_SPECS]
    )
    def test_mesh_plants_found_on_host_route(self, spec, mesh_corpus):
        path, plan = mesh_corpus
        _plants_check(spec, path, plan, TINY)

    def test_plan_covers_every_seam(self):
        plan = chip_smoke.plan_plants(ONE_CARD_SPECS, TINY, CHUNK, TILE)
        for i, spec in enumerate(ONE_CARD_SPECS):
            spans = [(o, o + len(spec.planted)) for o in plan[spec.name]]
            assert any(o < 8192 + 512 * len(ONE_CARD_SPECS) for o, _ in spans)
            assert any(
                o // (2 * TILE) != (e - 1) // (2 * TILE) for o, e in spans
            ), "no plant straddles a count-tile seam"
            assert any(e > TINY - 96 * len(ONE_CARD_SPECS) for _, e in spans)
            if spec.width == 2:
                assert any(o % 2 for o, _ in spans), "no odd-aligned plant"
            if i == 0:
                assert any(o < CHUNK < e for o, e in spans)
                assert TINY - len(spec.planted) in plan[spec.name]

    def test_plan_refuses_a_file_too_small(self):
        with pytest.raises(ValueError):
            chip_smoke.plan_plants(ONE_CARD_SPECS, 20_000, 8192, TILE)
